"""No module that a run loads has the top-level name jax, jaxlib, flax or
pixelnerf_tpu, compared whole: pixelnerf_tpu_torch begins with
pixelnerf_tpu and is not one."""
import subprocess
import sys

from small_cells import CHECKOUT

SCRIPT = r"""
import sys, time
sys.path.insert(0, %r)
sys.path.insert(0, %r)
import torch
from small_cells import SEED, small_cell
from portbench import run
from portbench.harness import device
for name in ("srn.render", "srn.train.cached"):
    cell = small_cell(name)
    run.execute(cell, SEED, 0.2, True, "cpu", time.perf_counter())
assert "pixelnerf_tpu_torch" in sys.modules
print("FOUND", device.forbidden_modules())
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tests = CHECKOUT + "/portbench/tests"
    out = subprocess.run([sys.executable, "-c", SCRIPT % (CHECKOUT, tests)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout


def test_the_check_compares_whole_top_level_names():
    from portbench.harness import device

    fake = {"pixelnerf_tpu.models": sys, "pixelnerf_tpu_torch.fake": sys, "jaxlib_like": sys}
    before = {k: sys.modules.get(k) for k in fake}
    had_jax = "pixelnerf_tpu" in {m.split(".")[0] for m in sys.modules}
    sys.modules.update(fake)
    try:
        found = device.forbidden_modules()
        assert "pixelnerf_tpu" in found and "pixelnerf_tpu_torch" not in found and "jaxlib_like" not in found
    finally:
        for k, v in before.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v
    assert had_jax == ("pixelnerf_tpu" in {m.split(".")[0] for m in sys.modules})

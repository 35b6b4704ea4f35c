"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the root
of the checkout, at first use. The file name carries a hash of the source,
of every header under ``csrc/`` it includes (directly or through another
header) and of the flags, so an edited source or header builds anew and an
unchanged one loads the library already built. The library is loaded with
``ctypes``; callers declare ``argtypes`` with ``c_void_p`` for every pointer
and the stream.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

from ..utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the headers it includes with quotes, followed
    through the headers, in the order met."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources_of(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start nvcc for one source; returns (target, process) or (target, None)
    when the library is already built."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named kernels, one nvcc process per source, all started
    together. Returns each kernel's compiler output (``-Xptxas -v``:
    registers, shared memory, spills); empty for a library already built.
    Raises if any build fails."""
    names = list(names)
    with span("kernels.build", sources=len(names)) as s:
        nvcc = _nvcc()
        started = {n: _start(n, nvcc) for n in names}
        s.count("compiled", sum(job is not None for _, job in started.values()))
        logs: Dict[str, str] = {}
        failed = []
        for n, (target, job) in started.items():
            if job is None:
                logs[n] = ""
                continue
            proc, tmp = job
            out, _ = proc.communicate()
            logs[n] = out
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
                os.unlink(tmp)
                continue
            # atomic publish: a concurrent build of the same source wins or
            # loses the rename, never leaves a half-written library
            os.replace(tmp, target)
            (BUILD_DIR / f"{target.stem}.log").write_text(out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            with span("kernels.load"):
                target = _target(name)
                if not target.exists():
                    build([name])
                lib = ctypes.CDLL(str(target))
            _LOADED[name] = lib
        return lib


def ptxas_log(name: str) -> str:
    """The compiler output kept from the build of ``csrc/<name>.cu``
    (``-Xptxas -v``), building it first if needed."""
    load(name)
    log = BUILD_DIR / f"{_target(name).stem}.log"
    return log.read_text() if log.exists() else ""


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_entries(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel in a ``-Xptxas -v`` log,
    keyed by the kernel's mangled name."""
    entries: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = entries.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = _REGS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return entries


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

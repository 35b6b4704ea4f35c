"""A render request without host copies: the positional code's tables made
once a device and dtype, the intrinsics, the image shape and the latent
scaling written on the device by fills instead of copied from the host.
Each is held bit-equal to the request built the old way (the tables turned
into tensors in every call, every vector of host numbers copied with
``torch.tensor``, the intrinsics given as host tensors). CPU only, the port
alone, small seeded models; the card's side is in
``tests/test_torch_kernels.py``."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.models import encoder as encoder_mod
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.models import pixelnerf as pixelnerf_mod
from pixelnerf_tpu_torch.models.code import PositionalEncoding
from pixelnerf_tpu_torch.ops import resize as resize_mod
from pixelnerf_tpu_torch.render import RenderConfig
from pixelnerf_tpu_torch.utils import geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 16
FX, FY, CX, CY = 30.0 * SIDE / 32, 29.5 * SIDE / 32, 7.75, 8.25


def old_way(monkeypatch):
    """Patch the request back to its host copies: the code's tables and the
    resize matrices turned into tensors in every call, every vector of host
    numbers made by ``torch.tensor``."""

    def copied(values, device):
        return torch.tensor(list(values), dtype=torch.float32, device=device)

    for mod in (geometry, encoder_mod, pixelnerf_mod):
        monkeypatch.setattr(mod, "device_vector", copied)
    monkeypatch.setattr(
        PositionalEncoding, "device_tables",
        lambda self, device, dtype: tuple(torch.as_tensor(t, device=device, dtype=dtype) for t in self.tables()),
    )
    monkeypatch.setattr(resize_mod, "_device_matrix",
                        lambda make, *sizes, device: torch.as_tensor(make(*sizes), device=device))


def _net(conf_name, views):
    conf = load_config(os.path.join(REPO, "conf", "exp", conf_name))
    m = conf["model"]
    m["encoder"]["num_layers"] = 2
    for mlp in ("mlp_coarse", "mlp_fine"):
        m[mlp]["d_hidden"] = 32
    m["dtype"] = "bfloat16"
    r = conf["renderer"]
    r["n_coarse"], r["n_fine"], r["n_fine_depth"] = 16, 8, 4
    net = make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    images = torch.rand((1, views, 32, 32, 3), generator=g) * 2 - 1
    eyes = ((0.0, 0.4, 1.3), (0.5, 0.3, 1.2), (-0.5, 0.3, 1.2))[:views]
    poses = torch.stack([torch.from_numpy(geometry.look_at(e, (0.0, 0.0, 0.0))) for e in eyes])[None]
    return net, RenderConfig.from_conf(conf["renderer"]), images, poses


def _request(net, cfg, images, poses, enc_focal, enc_c, focal, c):
    renderer = FullRenderer(net, cfg, ray_chunk=SIDE * SIDE, fast=True)
    target = geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0))
    with torch.inference_mode():
        enc = net.encode(images, poses, enc_focal, enc_c)
        rays = geometry.gen_rays(torch.from_numpy(target)[None], SIDE, SIDE, focal, 0.8, 1.8, c=c, device="cpu")[0]
        rgb, depth = renderer.render_image(enc, rays, generator=torch.Generator().manual_seed(2))
    return enc, rgb, depth


@pytest.mark.parametrize("conf_name,views", [("srn.conf", 1), ("dtu.conf", 3)], ids=["srn", "dtu_ns3"])
def test_render_image_is_bit_equal_to_the_request_built_the_old_way(monkeypatch, conf_name, views):
    """One bf16 ``fast`` view through ``FullRenderer.render_image``: the
    ``srn`` shape (one source view, white background) and the ``dtu`` shape
    (three source views, no white background). The intrinsics come as Python
    numbers, as the benchmark and the apps give them, against host tensors
    the old way."""
    net, cfg, images, poses = _net(conf_name, views)
    assert cfg.white_bkgd == (conf_name == "srn.conf")
    enc, rgb, depth = _request(net, cfg, images, poses, (30.0, 29.5), (16.0, 15.5), (FX, FY), (CX, CY))
    with monkeypatch.context() as m:
        old_way(m)
        enc_o, rgb_o, depth_o = _request(net, cfg, images, poses, torch.tensor([[30.0, 29.5]]),
                                         torch.tensor([[16.0, 15.5]]), torch.tensor([FX, FY]), torch.tensor([CX, CY]))
    for name in ("focal", "c", "image_shape"):
        got, want = getattr(enc, name), getattr(enc_o, name)
        assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want), name
    assert torch.equal(enc.latent, enc_o.latent)
    assert torch.isfinite(rgb).all() and rgb.std() > 0
    assert torch.equal(rgb, rgb_o) and torch.equal(depth, depth_o)


FORMS = {
    "numbers": ((FX, FY), (CX, CY)),
    "numpy": (np.array([FX, FY], np.float32), np.array([CX, CY], np.float64)),
    "host_tensors": (torch.tensor([FX, FY]), torch.tensor([CX, CY])),
    "rows": (torch.tensor([[FX, FY]]), torch.tensor([[CX, CY]], dtype=torch.float64)),
    "scalar_focal": (FX, (CX, CY)),
    "numpy_scalar_focal": (np.float32(FX), [CX, CY]),
    "zero_dim_focal": (torch.tensor(FX), torch.tensor([CX, CY])),
    "centre_default": ((FX, FY), None),
}


def old_intrinsics(form, width, height):
    """The host tensors the old way takes for ``FORMS[form]`` at an image of
    ``width`` x ``height``."""
    f = FX if form in ("scalar_focal", "numpy_scalar_focal", "zero_dim_focal") else (FX, FY)
    c = (width * 0.5, height * 0.5) if FORMS[form][1] is None else (CX, CY)
    return torch.tensor(f), torch.tensor(c)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_gen_rays_is_bit_equal_for_every_form_of_the_intrinsics(monkeypatch, form):
    """``gen_rays`` with focal and principal point as numbers, lists, numpy
    scalars and arrays, host tensors of any shape that holds a scalar or a
    pair, against the old way's copies of the same values."""
    focal, c = FORMS[form]
    pose = torch.from_numpy(geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0)))[None]
    got = geometry.gen_rays(pose, 12, 10, focal, 0.8, 1.8, c=c, device="cpu")
    old_f, old_c = old_intrinsics(form, 12, 10)
    with monkeypatch.context() as m:
        old_way(m)
        want = geometry.gen_rays(pose, 12, 10, old_f, 0.8, 1.8, c=old_c, device="cpu")
    assert got.shape == (1, 10, 12, 8) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_device_vector_writes_the_numbers_torch_tensor_would():
    values = (128, 0.1, -1.0, 2.0 / 3.0, 1e-30, 3.4e38)
    out = geometry.device_vector(values, "cpu")
    assert out.dtype == torch.float32 and torch.equal(out, torch.tensor(values, dtype=torch.float32))
    on = geometry.on_device(np.array([[1.5, 2.5], [3.5, 4.5]]), "cpu")
    assert on.shape == (2, 2) and torch.equal(on, torch.tensor([[1.5, 2.5], [3.5, 4.5]]))
    assert geometry.on_device(2.0).shape == ()


def test_positional_code_makes_its_tables_once_a_device_and_dtype(monkeypatch):
    """The same table objects on a second call on the same device and dtype,
    bit-equal to ``tables()``; others for another dtype; tables first made
    in inference mode still serve a training step's backward."""
    pe = PositionalEncoding(num_freqs=5, d_in=3, freq_factor=2.75)
    with torch.inference_mode():
        freqs, phases = pe.device_tables(torch.device("cpu"), torch.float32)
    f_np, p_np = pe.tables()
    assert torch.equal(freqs, torch.from_numpy(f_np)) and torch.equal(phases, torch.from_numpy(p_np))
    again = pe.device_tables("cpu", torch.float32)
    assert again[0] is freqs and again[1] is phases
    wide = pe.device_tables("cpu", torch.float64)
    assert wide[0] is not freqs and wide[0].dtype == torch.float64
    assert torch.equal(wide[0], torch.from_numpy(f_np).double())

    x = torch.rand((7, 3), generator=torch.Generator().manual_seed(4))
    want = pe(x)

    def no_tables(self):
        raise AssertionError("the tables were made again")

    monkeypatch.setattr(PositionalEncoding, "tables", no_tables)
    assert torch.equal(pe(x), want)
    xg = x.clone().requires_grad_(True)
    pe(xg).sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("resize", ["bilinear", "area"])
def test_resize_makes_its_matrices_once_a_device(monkeypatch, resize):
    """The encoder's resizes contract with matrices made once a size and
    device: bit-equal to the matrices copied in every call, not made again,
    and, first made in inference mode, still saved by a training step."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand((2, 13, 11, 4), generator=g)
    if resize == "bilinear":
        fn, size = resize_mod.resize_bilinear, (23, 19)
        mats = resize_mod._bilinear_matrix(23, 13, True), resize_mod._bilinear_matrix(19, 11, True)
    else:
        fn, size = resize_mod.resize_area, (5, 4)
        mats = resize_mod._area_matrix(5, 13), resize_mod._area_matrix(4, 11)
    with torch.inference_mode():
        got = fn(x, *size)
    want = torch.einsum("pw,nowc->nopc", torch.from_numpy(mats[1]),
                        torch.einsum("oh,nhwc->nowc", torch.from_numpy(mats[0]), x))
    assert torch.equal(got, want)
    calls = []
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: calls.append(a) or torch.tensor(0.0))
    xg = x.clone().requires_grad_(True)
    out = fn(xg, *size)
    monkeypatch.undo()
    assert calls == [] and torch.equal(out.detach(), want)
    out.sum().backward()
    assert xg.grad is not None and xg.grad.shape == x.shape

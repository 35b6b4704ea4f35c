"""LPIPS perceptual distance, VGG variant (counterpart of
``pixelnerf_tpu/utils/lpips.py``), as a ``torch.nn.Module``.

- a VGG16 feature trunk (NCHW convs, ReLUs, a 2x2 max pool between its
  five groups, floor sizes on odd inputs) giving the five LPIPS taps:
  relu1_2, relu2_2, relu3_3, relu4_3, relu5_3;
- the distance: the inputs shifted and scaled by the lpips package's
  constants, each tap unit-normalised over its channels (``+ 1e-10``), the
  squared difference weighted by the tap's 1x1 "linear head", averaged over
  space and summed over the taps (Zhang et al., CVPR 2018);
- an importer for the torch formats in the wild: a whole
  ``lpips.LPIPS(net='vgg').state_dict()`` (``net.slice<k>.<idx>.*`` with
  ``lin<k>.model.1.weight``) or a torchvision ``vgg16`` state_dict
  (``features.<idx>.*``) merged with the lin heads.

Images are NHWC in [-1, 1], the lpips package's range. The convolutions
run in full float32: TF32 is turned off around them, whatever the
process's setting, so the metric on the card is the CPU's to float32
rounding.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg16.features conv indices, grouped by LPIPS slice (a max
# pool between groups), and each group's channels
_VGG_PLAN: Sequence[Sequence[int]] = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_VGG_WIDTHS: Sequence[int] = (64, 128, 256, 512, 512)

# lpips.ScalingLayer constants (inputs in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def init_lpips_params(rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Random weights in the parameter tree :class:`LPIPS` takes (conv
    ``weight`` (O, I, 3, 3), ``bias`` (O,); ``lins`` (C,) each), drawn as
    the JAX package's ``init_lpips_params`` draws them from the same
    generator, so one seed gives both packages the same network."""
    rng = rng or np.random.default_rng(0)
    params: Dict[str, Any] = {"convs": [], "lins": []}
    c_in = 3
    for group, width in zip(_VGG_PLAN, _VGG_WIDTHS):
        g = []
        for _ in group:
            kernel = rng.normal(0, 0.05, (3, 3, c_in, width)).astype(np.float32)     # HWIO
            g.append({"weight": kernel.transpose(3, 2, 0, 1).copy(), "bias": np.zeros((width,), np.float32)})
            c_in = width
        params["convs"].append(g)
        params["lins"].append(np.abs(rng.normal(0, 0.05, (width,))).astype(np.float32))
    return params


@contextlib.contextmanager
def _full_float32_convs():
    """cuDNN convolutions in full float32 (no TF32) inside the block."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class LPIPS(nn.Module):
    """``LPIPS(params)(img0, img1) -> (B,)`` distances of two (B, H, W, 3)
    image batches in [-1, 1]. ``params`` is :func:`init_lpips_params`'s or
    :func:`import_lpips_state_dict`'s tree; move the module to a device
    with ``.to(device)``."""

    def __init__(self, params: Dict[str, Any]):
        super().__init__()
        self.convs = nn.ModuleList()
        for group in params["convs"]:
            convs = nn.ModuleList()
            for conv in group:
                weight = torch.as_tensor(np.asarray(conv["weight"], np.float32))
                c = nn.Conv2d(weight.shape[1], weight.shape[0], 3, padding=1)
                with torch.no_grad():
                    c.weight.copy_(weight)
                    c.bias.copy_(torch.as_tensor(np.asarray(conv["bias"], np.float32)))
                convs.append(c)
            self.convs.append(convs)
        for k, lin in enumerate(params["lins"]):
            self.register_buffer(f"lin{k}", torch.as_tensor(np.asarray(lin, np.float32)).reshape(1, -1, 1, 1))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).reshape(1, 3, 1, 1))
        self.requires_grad_(False)

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The five tap activations (NCHW) of ``x`` (NCHW, already scaled)."""
        taps = []
        for gi, group in enumerate(self.convs):
            if gi > 0:
                x = F.max_pool2d(x, 2, 2)
            for conv in group:
                x = torch.relu(conv(x))
            taps.append(x)
        return taps

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        x0 = (img0.permute(0, 3, 1, 2) - self.shift) / self.scale
        x1 = (img1.permute(0, 3, 1, 2) - self.shift) / self.scale
        with _full_float32_convs():
            taps0, taps1 = self.taps(x0), self.taps(x1)
        total = 0.0
        for k, (t0, t1) in enumerate(zip(taps0, taps1)):
            n0 = t0 / (torch.sqrt(torch.sum(t0 ** 2, dim=1, keepdim=True)) + 1e-10)
            n1 = t1 / (torch.sqrt(torch.sum(t1 ** 2, dim=1, keepdim=True)) + 1e-10)
            val = torch.sum((n0 - n1) ** 2 * getattr(self, f"lin{k}"), dim=1)     # the 1x1 head, no bias
            total = total + torch.mean(val, dim=(1, 2))
        return total

    @classmethod
    def from_torch_file(cls, path: str) -> "LPIPS":
        return cls(load_torch_lpips(path))


def import_lpips_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A torch state_dict (``lpips.LPIPS`` whole, or torchvision vgg16 with
    the lin heads) -> the parameter tree :class:`LPIPS` takes. Values may be
    tensors or numpy arrays. The classifier and the scaling layer's
    constants are skipped; a missing conv or head raises."""
    flat = {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy()) for k, v in state_dict.items()}
    idx_to_group = {idx: (gi, ci) for gi, group in enumerate(_VGG_PLAN) for ci, idx in enumerate(group)}
    convs: List[List[Dict[str, np.ndarray]]] = [[{} for _ in g] for g in _VGG_PLAN]
    lins: List[Optional[np.ndarray]] = [None] * len(_VGG_PLAN)
    for key, value in flat.items():
        parts = key.split(".")
        if parts[0].startswith("lin") and parts[0][3:].isdigit():
            # lpips lin head: lin<k>.model.1.weight, shape (1, C, 1, 1)
            lins[int(parts[0][3:])] = value.reshape(-1).astype(np.float32)
            continue
        if "classifier" in parts:
            continue                     # torchvision vgg16's fully-connected head
        if parts[-1] not in ("weight", "bias") or not parts[-2].isdigit():
            continue                     # scaling_layer.shift/scale: constants kept here
        idx = int(parts[-2])
        if idx not in idx_to_group:
            continue
        gi, ci = idx_to_group[idx]
        convs[gi][ci][parts[-1]] = value.astype(np.float32)
    for gi, group in enumerate(convs):
        for ci, entry in enumerate(group):
            if "weight" not in entry or "bias" not in entry:
                raise ValueError(f"LPIPS import: missing conv weights for slice {gi} conv {ci}")
    if any(lin is None for lin in lins):
        raise ValueError("LPIPS import: missing lin-head weights (lin0..lin4)")
    return {"convs": convs, "lins": lins}


def load_torch_lpips(path: str) -> Dict[str, Any]:
    """LPIPS weights from a torch .pth file (on the CPU, weights only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_lpips_state_dict(sd)

"""The arithmetic of the reference's matrix products and convolutions.

``Precision("f32")`` is float32 with TF32 off (the reference). The controls
compute the same mathematics one step lower than a configuration states:
``"tf32"`` rounds every operand of a product or convolution to TF32's 10
mantissa bits (round to nearest even) and accumulates in float32, in the
backward as in the forward; ``"fp8"`` rounds every operand, and every
stored activation that the program stores in bf16, to float8 e4m3 with a
per-tensor scale (its largest magnitude at 448), as an 8-bit path would.
``"bf16"`` rounds the same to bfloat16: not a control, but the scale of
the rounding error that a bf16 configuration brings on a given scene.
The rounding is emulated, so a control runs alike on the CPU and the card.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        rg = r(g.contiguous())
        return rg @ r(b).t(), r(a).t() @ rg, None


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, rnd)
        return F.conv2d(rnd(x), rnd(w), None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, r = ctx.conf
        rg = r(g.contiguous())
        gx = torch.nn.grad.conv2d_input(x.shape, r(w), rg, stride, padding) if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(r(x), w.shape, rg, stride, padding)
        return gx, gw, None, None, None


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self._round = {"f32": None, "tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}[mode]

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
        """``x @ w.T + b`` over the last axis of x."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self._round is None:
            y = x2 @ w.t()
        else:
            y = _RoundedMatmul.apply(x2, w.t(), self._round)
        if b is not None:
            y = y + b
        return y.reshape(*lead, w.shape[0])

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        if self._round is None:
            return F.conv2d(x, w, None, stride, padding)
        return _RoundedConv.apply(x, w, stride, padding, self._round)

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the program stores in a narrower type (the latent
        map): kept as it is, or at bf16 and fp8 rounded as such a path
        stores it."""
        return self._round(x) if self.mode in ("bf16", "fp8") else x


@contextlib.contextmanager
def exact_float32():
    """Float32 products and convolutions without TF32 inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before

"""NeRF sinusoidal positional encoding (counterpart of
``pixelnerf_tpu/models/code.py``).

No parameters, so a plain dataclass. Output layout matches the JAX package
and the reference exactly: input first if ``include_input``, then
interleaved (sin, cos) per frequency, frequency-major. Checkpoint parity
depends on this column order feeding the first MLP layer.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PositionalEncoding:
    num_freqs: int = 6
    d_in: int = 3
    freq_factor: float = math.pi
    include_input: bool = True

    @property
    def d_out(self) -> int:
        return self.num_freqs * 2 * self.d_in + (self.d_in if self.include_input else 0)

    def tables(self):
        """(frequencies, phases), each (2 * num_freqs,) float32: the
        reference module's ``_freqs`` and ``_phases`` buffers, flattened."""
        freqs = self.freq_factor * 2.0 ** np.arange(self.num_freqs, dtype=np.float32)
        freqs2 = np.repeat(freqs, 2).astype(np.float32)        # f1 f1 f2 f2 ...
        phases = np.zeros(2 * self.num_freqs, dtype=np.float32)
        phases[1::2] = math.pi * 0.5                            # sin, cos, ...
        return freqs2, phases

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(..., d_in) -> (..., d_out)."""
        freqs2, phases = self.tables()
        freqs2 = torch.as_tensor(freqs2, device=x.device, dtype=x.dtype)
        phases = torch.as_tensor(phases, device=x.device, dtype=x.dtype)
        embed = torch.sin(x[..., None, :] * freqs2[:, None] + phases[:, None])
        embed = embed.reshape(*x.shape[:-1], 2 * self.num_freqs * self.d_in)
        if self.include_input:
            embed = torch.cat([x, embed], dim=-1)
        return embed

    @classmethod
    def from_conf(cls, conf, d_in: int = 3) -> "PositionalEncoding":
        return cls(
            num_freqs=conf.get_int("num_freqs", 6),
            d_in=d_in,
            freq_factor=conf.get_float("freq_factor", math.pi),
            include_input=conf.get_bool("include_input", True),
        )

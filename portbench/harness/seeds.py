"""Every random stream of a run, derived from ``--seed`` and the stream's
name, so that the same seed gives the same inputs and weights."""
from __future__ import annotations

import hashlib


def derive(seed: int, *names) -> int:
    """A 63-bit seed for the stream ``names`` of run seed ``seed`` (any
    whole number, also one past 32 bits)."""
    h = hashlib.sha256(str(int(seed)).encode())
    for n in names:
        h.update(b"/" + str(n).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def generator(device, seed: int, *names):
    import torch

    return torch.Generator(device=device).manual_seed(derive(seed, *names))

"""The card, the process's environment and the modules it may not load."""
from __future__ import annotations

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pixelnerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's. ``pixelnerf_tpu_torch`` begins
    with ``pixelnerf_tpu`` and is not one of them."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_caches(checkout: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the program builds
    its CUDA sources into ``build/kernels`` there itself); JAX kept out of
    libraries that would load it."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(checkout, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(checkout, "build", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"


def require_cards(count: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is false; no result")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"portbench: the cell needs {count} cards, {torch.cuda.device_count()} visible; no result")


def describe(device) -> dict:
    """The result's ``device`` fields and the card's power limit."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, "power_limit": "none"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()), "power_limit": smi}

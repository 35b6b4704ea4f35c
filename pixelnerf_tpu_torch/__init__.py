"""pixelnerf_tpu_torch — the PyTorch/CUDA port of ``pixelnerf_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100). It mirrors
the JAX package's layout (``config/``, ``utils/``, ``models/``, ``ops/``,
``render/``, ``eval/``, ``train/``, ``data/``, ``apps/``) so each module's
counterpart is easy to find, keeps the JAX layouts at its public functions
(NHWC images, ``(N, Hl, Wl, C)`` latents, ``(SB, B, 8)`` rays), and
replaces each Pallas TPU kernel on its path with a CUDA C++ kernel for
``sm_90a`` (``csrc/``, built at first use by ``ops/_build.py``).

It imports torch, numpy and the standard library only. Entry points default
to ``device="cuda"``; the CPU is used only when the caller asks for it.
"""

__version__ = "0.1.0"

# Lazy top-level conveniences: ``import pixelnerf_tpu_torch`` stays free of
# the torch import cost until a symbol is touched.
_LAZY = {
    "make_model": ("pixelnerf_tpu_torch.models", "make_model"),
    "PixelNeRFNet": ("pixelnerf_tpu_torch.models", "PixelNeRFNet"),
    "SceneEncoding": ("pixelnerf_tpu_torch.models", "SceneEncoding"),
    "from_jax_variables": ("pixelnerf_tpu_torch.models", "from_jax_variables"),
    "RenderConfig": ("pixelnerf_tpu_torch.render", "RenderConfig"),
    "FullRenderer": ("pixelnerf_tpu_torch.eval", "FullRenderer"),
    "load_config": ("pixelnerf_tpu_torch.config", "load_config"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))

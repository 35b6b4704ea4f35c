"""Profiling and tracing hooks (counterpart of
``pixelnerf_tpu/utils/profiling.py``).

``named_scope`` and ``annotate`` mark a region in a trace (a
``torch.profiler.record_function`` span); ``trace`` records a
TensorBoard-viewable profile of a region (the train app's
``--profile_dir``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

named_scope = record_function


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Record the CPU's and, where there is one, the GPU's activity (CUDA
    kernels through CUPTI) inside the block into a ``*.pt.trace.json`` file
    in ``profile_dir`` (nothing when it is None).

    View with: tensorboard --logdir <profile_dir> (the PyTorch profiler
    plugin), or open the file in Perfetto.
    """
    if not profile_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


def annotate(name: str):
    """Decorator form of ``named_scope``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap

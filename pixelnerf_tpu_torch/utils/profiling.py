"""The port's own spans, and the train app's profiler hook (counterpart of
``pixelnerf_tpu/utils/profiling.py``).

``span(name, **counts)`` marks one call into a layer::

    with span("field.mlp", rows=n) as s:
        ...
        s.count("kernel_b")

Off (the default), it returns one shared object that does nothing, after a
single check of a module flag: it reads no clock and keeps nothing. On
(:func:`enable`), each span keeps one :class:`Record` in memory: its name
and thread, its start and end on :data:`clock`, the index of the span it
opened in (one stack a thread), the id of its request (a ``request`` span
opens a new one; the spans under it inherit it) and its counts, integers
passed to ``span`` or added by ``count``. :func:`take` returns the records
and clears them; at most :data:`CAP` are kept, and the spans past the cap
are counted by :func:`dropped`.

The spans of the port, from the request down:

- ``request``: ``FullRenderer.render_image``, the root of a view
  (``rays``, ``chunks``)
- ``rays``: ``utils/geometry.gen_rays`` (``rays``)
- ``render_rays``: one chunk of the renderer (``rays``); its self time is
  the renderer's: sampling, the sort, compositing, the ``torch.cat``\\ s.
  ``render_rays.merge``: the chunk loop's output concatenation
- ``field.features``: ``PixelNeRFNet.query_features`` (``points``,
  ``views``, and ``inputs_fused`` or ``separate``: whether kernel A's
  field instance ran the whole stage); ``field.mlp``: ``PixelNeRFNet.query_mlp`` (``rows``, and
  ``kernel_b`` or ``dense``: which of the two ran; ``kernel_b_views``: the
  views a launch of kernel B's multi-view mode averages)
- ``encode``: ``PixelNeRFNet.encode`` (``images``)
- ``train.step`` with ``forward``, ``backward``, ``optimizer``;
  ``data.next``: the train loop's wait on the input pipeline
- ``kernels.load``, ``kernels.build`` (``compiled``: the sources ``nvcc``
  compiled)

``trace(profile_dir)`` records a ``torch.profiler`` trace of a region with
the spans written into it (the train app's ``--profile_dir``).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import socket
import threading
import time
from typing import Iterator, List, Optional

# the host clock torch.profiler stamps its host events with (CLOCK_REALTIME,
# in ns): a span's start and end compare with the profiler's events directly
clock = time.time_ns

CAP = 1 << 20

_on = False
_lock = threading.Lock()
_records: List["Record"] = []
_dropped = 0
_requests = itertools.count(1)
_local = threading.local()


class _Off:
    """What ``span`` returns while the spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, key: str, n: int = 1) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Record:
    """One span: ``name``, ``thread`` (the OS thread id), ``start`` and
    ``end`` (ns on :data:`clock`), ``parent`` (the index in the records of
    the span it opened in, or None), ``request`` (its request's id, or
    None), ``counts`` and ``index`` (its own index, None past the cap)."""

    __slots__ = ("name", "thread", "start", "end", "parent", "request", "counts", "index")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts
        self.thread = threading.get_native_id()
        self.start = self.end = None

    def __enter__(self):
        global _dropped
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.index if up is not None else None
        if self.name == "request":
            self.request = next(_requests)
        else:
            self.request = up.request if up is not None else None
        with _lock:
            if len(_records) < CAP:
                self.index = len(_records)
                _records.append(self)
            else:
                self.index = None
                _dropped += 1
        stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc):
        self.end = clock()
        _stack().pop()
        return False

    def count(self, key: str, n: int = 1) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


def span(name: str, **counts):
    """A context manager around one call into a layer: a :class:`Record`
    when the spans are on, else the shared object that does nothing."""
    if not _on:
        return _OFF
    return Record(name, counts)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the count ``key`` of this thread's innermost open span
    (nothing while the spans are off or none is open)."""
    if not _on:
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].count(key, n)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def dropped() -> int:
    """Spans not kept since the last :func:`take`, the cap being reached."""
    return _dropped


def take() -> List[Record]:
    """The records kept since the last call, and clear them (call it with
    no span open: the indices of open spans refer to the records taken)."""
    global _records, _dropped
    with _lock:
        out, _records, _dropped = _records, [], 0
    return out


def self_times(records: List[Record]) -> List[int]:
    """Each record's self time in ns: its length less its children's, the
    records closed (a child lies inside its parent, on its thread)."""
    out = [r.end - r.start for r in records]
    for r in records:
        if r.parent is not None:
            out[r.parent] -= r.end - r.start
    return out


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Record the CPU's and, where there is one, the GPU's activity (CUDA
    kernels through CUPTI) inside the block into a ``*.pt.trace.json`` file
    in ``profile_dir`` (nothing when it is None), with the port's spans
    written into it as complete events of their threads (category
    ``program_span``, the counts among their ``args``): the spans are on
    inside the block, and their records are taken at its end.

    View with: tensorboard --logdir <profile_dir> (the PyTorch profiler
    plugin), or open the file in Perfetto.
    """
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            disable()
    os.makedirs(profile_dir, exist_ok=True)
    # tensorboard_trace_handler's file name, which the profiler plugin finds
    path = os.path.join(profile_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, take())


def _write_spans(path: str, records: List[Record]) -> None:
    """Add ``records`` to the chrome trace at ``path`` (as exported by
    ``torch.profiler``, its times in us from ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    for r in records:
        if r.end is None:
            continue
        args = dict(r.counts, parent=r.parent, request=r.request)
        doc["traceEvents"].append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid, "tid": r.thread,
                                   "ts": (r.start - base) / 1e3, "dur": (r.end - r.start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)

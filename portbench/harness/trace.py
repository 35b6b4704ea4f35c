"""Spans, the device trace and what is read from them.

A traced run runs its window twice. The first is timed as an untraced
run's is: ``Spans("timed")`` times the harness's calls into each layer by
the host clock (a span that times device work ends with a synchronize),
and the host-clock per-layer metrics come from it. The second runs under
``torch.profiler``, its spans only ``record_function`` ranges that label
the trace (no synchronize): ``Trace`` reduces its events to the device's
busy time (the union of the intervals in which a kernel, copy or set ran),
each kernel's time, and the idle gaps, each labelled by the benchmark's
innermost span and the host operation running at its middle."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "portbench.window"


class Spans:
    """``with spans(name):`` around a call. ``mode``: ``"off"`` (untraced
    runs), ``"timed"`` (seconds recorded, a ``synced`` span ended by a
    synchronize) or ``"labels"`` (a ``record_function`` range only)."""

    def __init__(self, mode: str, sync):
        assert mode in ("off", "timed", "labels")
        self.mode = mode
        self.sync = sync
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, synced: bool = False):
        if self.mode == "off":
            yield
        elif self.mode == "labels":
            with torch.profiler.record_function(name):
                yield
        else:
            t0 = time.perf_counter()
            yield
            if synced:
                self.sync()
            self.seconds[name].append(time.perf_counter() - t0)


def _is_annotation(e) -> bool:
    """A ``record_function`` range mirrored on the device's timeline, which
    is no operation of the device's."""
    if getattr(e, "is_user_annotation", None) and e.is_user_annotation():
        return True
    kind = getattr(e, "activity_type", None)
    return bool(kind) and "annotation" in str(kind()).lower()


def _ns(e, end=False):
    try:
        start, dur = e.start_ns(), e.duration_ns()
    except AttributeError:       # older profilers give microseconds
        start, dur = e.start_us() * 1000, e.duration_us() * 1000
    return start + dur if end else start


class Trace:
    """``with Trace(on) as tr:`` around the window; then ``tr.reduce(names)``."""

    def __init__(self, on: bool, cuda: bool):
        self.on = on
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts) if on else None
        self._range = None

    def __enter__(self):
        if self.on:
            self.prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._range.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def reduce(self, span_names) -> dict:
        """busy_s, window_s, kernels {name: [seconds, count]}, device_ops
        and idle_gaps (the ten largest, [name, seconds])."""
        events = self.prof.profiler.kineto_results.events()
        cuda_type = torch.autograd.DeviceType.CUDA
        device, cpu = [], []
        window = None
        for e in events:
            if e.device_type() == cuda_type:
                if not _is_annotation(e):
                    device.append((_ns(e), _ns(e, True), e.name()))
            else:
                name = e.name()
                if name == WINDOW:
                    window = (_ns(e), _ns(e, True), e.start_thread_id())
                cpu.append((_ns(e), _ns(e, True), name, e.start_thread_id()))
        if window is None:
            raise RuntimeError("the trace holds no window range")
        w0, w1, main = window
        device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1)
        kernels = defaultdict(lambda: [0.0, 0])
        busy, gaps = 0, []
        cur_a, cur_b = w0, w0
        for a, b, n in device:
            k = kernels[n]
            k[0] += (b - a) / 1e9
            k[1] += 1
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        if w1 > cur_b:
            gaps.append((cur_b, w1))
        labels = _label_gaps(gaps, [c for c in cpu if c[3] == main and c[2] != WINDOW], set(span_names))
        idle = defaultdict(float)
        for (a, b), label in zip(gaps, labels):
            idle[label] += (b - a) / 1e9
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
        return {
            "busy_s": busy / 1e9,
            "window_s": (w1 - w0) / 1e9,
            "kernels": dict(kernels),
            "device_ops": [[n[:200], v[0]] for n, v in top[:10]],
            "idle_gaps": [[n[:200], v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        }


def _label_gaps(gaps, cpu, span_names):
    """Per gap, ``<innermost benchmark span>/<innermost host operation>`` at
    the gap's middle (``window`` outside every span)."""
    mids = [(a + b) // 2 for a, b in gaps]
    spans = _innermost(sorted((a, b, n) for a, b, n, _ in cpu if n in span_names), mids)
    ops = _innermost(sorted((a, b, n) for a, b, n, _ in cpu if n not in span_names), mids)
    return [f"{s or 'window'}/{o or 'none'}" for s, o in zip(spans, ops)]


def _innermost(intervals, times):
    """For each of the increasing ``times``, the name of the innermost of
    the nested ``intervals`` (sorted by start) that holds it, or None: one
    sweep with a stack of the open intervals."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] <= intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out

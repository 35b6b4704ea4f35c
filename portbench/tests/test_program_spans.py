"""The attribution of a profiled window's device work and host waits to the
program's spans (``harness/program_spans.py``), on synthetic events in the
profiler's shape: per-span device seconds, launches and waits, the
``(outside)`` bucket, the gap labels, and a window without program spans
labelled exactly as ``Trace.reduce`` labels it."""
import types

import pytest
import torch
from small_cells import small_cell

from portbench.harness import program_spans, record, trace
from pixelnerf_tpu_torch.utils import profiling

MAIN, OTHER, NATIVE = 1, 2, 4242
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """An event as ``kineto_results.events()`` gives it."""

    def __init__(self, name, start, end, device=CPU, corr=0, tid=MAIN):
        self._name, self._start, self._dur, self._device, self._corr, self._tid = (
            name, start, end - start, device, corr, tid)

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return False


def _record(index, name, start, end, parent=None):
    r = profiling.Record(name, {})
    r.index, r.parent, r.start, r.end, r.thread, r.request = index, parent, start, end, NATIVE, None
    return r


def _kernel(name, start, end, corr):
    return Ev(name, start, end, CUDA, corr)


def _window():
    """Window 0-1000 ns; the benchmark's ``render`` span 100-900; device
    work 60-90 (launched outside any program span), 320-520 (B, from
    field.mlp), 520-560 (A, from field.features), 600-650 (a cat, from
    render_rays' self time), 830-840 (a copy, from rays), 870-880 (from
    another thread), 950-960 (its runtime call not in the trace)."""
    events = [
        Ev(trace.WINDOW, 0, 1000), Ev("render", 100, 900),
        Ev("cudaLaunchKernel", 50, 55, corr=4), _kernel("draw_kernel", 60, 90, 4),
        Ev("aten::mm", 200, 215), Ev("cudaLaunchKernel", 210, 214, corr=1), _kernel("fused_mlp_kernel", 320, 520, 1),
        Ev("cudaLaunchKernel", 320, 324, corr=2), _kernel("gather_bilerp_kernel", 520, 560, 2),
        Ev("cudaLaunchKernel", 450, 455, corr=3), _kernel("CatArrayBatchedCopy", 600, 650, 3),
        Ev("aten::copy_", 819, 846), Ev("cudaMemcpyAsync", 820, 822, corr=5), Ev("Memcpy HtoD", 830, 840, CUDA, 5),
        Ev("cudaStreamSynchronize", 823, 845),
        Ev("cudaLaunchKernel", 860, 862, corr=6, tid=OTHER), _kernel("other_thread_kernel", 870, 880, 6),
        _kernel("unlinked_kernel", 950, 960, 99),
        Ev("cudaDeviceSynchronize", 905, 960),
    ]
    records = [_record(0, "request", 100, 800), _record(1, "render_rays", 150, 700, 0),
               _record(2, "field.mlp", 200, 300, 1), _record(3, "field.features", 310, 400, 1),
               _record(4, "rays", 810, 850)]
    return events, records


def test_device_time_launches_and_waits_go_to_the_innermost_program_span():
    events, records = _window()
    att = program_spans.attribute(events, records, ("render",), NATIVE)
    s = att["spans"]
    assert set(s) == {"field.mlp", "field.features", "render_rays", "rays", "(outside)", "(unlinked)"}
    assert s["field.mlp"]["device_s"] == 200e-9 and s["field.mlp"]["launches"] == 1
    assert s["field.mlp"]["kernels"] == {"fused_mlp_kernel": 200e-9}
    assert s["field.features"]["device_s"] == 40e-9
    assert s["render_rays"]["device_s"] == 50e-9
    assert s["rays"]["device_s"] == 10e-9 and s["rays"]["syncs"] == 1
    assert s["(outside)"]["device_s"] == pytest.approx(40e-9) and s["(outside)"]["launches"] == 2
    assert s["(outside)"]["syncs"] == 1
    assert s["(unlinked)"]["device_s"] == 10e-9
    assert abs(sum(v["device_s"] for v in s.values()) - att["device_s"]) < 1e-15
    assert att["device_s"] == 350e-9
    assert att["root_syncs"] == {"rays": 1, "(outside)": 1}
    assert att["sync_ops"] == {"rays/aten::copy_": 1, "(outside)/none": 1}
    assert dict(att["idle_gaps"]) == pytest.approx({
        "window/none": 100e-9, "render/field.mlp/aten::mm": 230e-9, "render/render_rays/none": 40e-9,
        "render/request/none": 180e-9, "render/none": 30e-9, "window/cudaDeviceSynchronize": 70e-9}, abs=1e-15)


def test_a_window_without_program_spans_is_labelled_as_the_trace_labels_it():
    events, _ = _window()
    tr = trace.Trace(False, False)
    tr.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    reduced = tr.reduce(("render",))
    att = program_spans.attribute(events, [], ("render",), NATIVE)
    assert att["idle_gaps"][:10] == reduced["idle_gaps"]
    assert att["device_s"] == sum(v[0] for v in reduced["kernels"].values())
    assert (att["busy_s"], att["window_s"]) == (reduced["busy_s"], reduced["window_s"])
    assert set(att["spans"]) == {"(outside)", "(unlinked)"}


def test_readers_measure_once_a_run_and_give_nothing_untraced():
    cell = small_cell("srn.render")
    untraced = record.RunRecord(cell, {"work": {}, "spans": {}, "trace": None, "window_s": 1.0})
    assert program_spans.read(untraced, "host_ms") is None
    traced = record.RunRecord(cell, {"work": {"rays": 512}, "spans": {}, "window_s": 0.2,
                                     "trace": {"kernels": {}, "busy_s": 0.0, "window_s": 0.2}})
    first = program_spans.read(traced, "host_ms")
    assert first > 0 and program_spans.read(traced, "host_ms") == first
    assert program_spans.read(traced, "host_syncs") == 0 and program_spans.read(traced, "dropped") == 0
    # on the CPU the trace holds no device work: no device number
    assert program_spans.read(traced, "renderer_ms") is None
    assert not profiling._on and profiling.take() == []


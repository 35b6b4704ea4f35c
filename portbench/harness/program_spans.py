"""The program's own spans (``pixelnerf_tpu_torch/utils/profiling.py``) in a
render cell, and the device time and host waits put down to them.

After a traced run's two windows, :func:`measure` runs the cell's sessions
in two more windows with the program's spans on, each as the run's own
windows run (whole requests, one client, the benchmark's spans around each
call, the same sessions and draws from the run's seed): first unprofiled,
which gives the host's time in ``request`` and ``rays`` a view and the
spans' cost; then under ``torch.profiler`` as ``trace.Trace`` profiles
(CPU and CUDA activity). :func:`attribute` links each kernel, copy and set
on the device to the runtime call that launched it (the CUPTI correlation
id they share) and puts its device time down to the innermost program span
open on the window's thread at that call's start; work launched outside
every program span of that thread (the benchmark's draws, scenes and
synchronizes) goes under ``(outside)``. It counts each span's waits on the
device (``SYNCS``), and labels each idle gap as ``Trace.reduce`` does, with
the innermost program span at the gap's middle between the benchmark's span
and the host operation (``render/field.mlp/cudaLaunchKernel``).

The readers of ``host_ms.*``, ``renderer_ms.*``, ``mlp_ms.*`` and
``host_syncs.*`` take their numbers from :func:`read`, which measures once
a run. A program without the spans (one older than them) gives nothing.

The windows are the run's own, not a third pair, where the harness turns
the spans on itself (PERF.md, Open questions)."""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import types
import weakref
from collections import defaultdict

import torch

from ..accounting import mlp as mlp_acc
from . import program, scene, weights as weights_mod
from .render_cell import SPANS, Session, view_draws
from .trace import WINDOW, Spans, Trace, _innermost, _is_annotation, _label_gaps, _ns

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "(outside)"
UNLINKED = "(unlinked)"
# the spans of a view's host side, and of the renderer layer
HOST = ("request", "rays")
RENDERER = ("render_rays", "render_rays.merge")
WINDOW_S = 8.0
MIN_VIEWS = 2
FALLBACK_SEED = 19

_measured = weakref.WeakKeyDictionary()


def read(run, key: str):
    """``key`` of the measurement of ``run`` (a ``record.RunRecord``), made
    at the first call of a run; None for an untraced run, a program without
    the spans, or a number the run's device cannot give."""
    if not run.trace:
        return None
    if run not in _measured:
        _measured[run] = _measure_run(run)
    return (_measured[run] or {}).get(key)


def _measure_run(run):
    try:
        from pixelnerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "take"):
        return None
    # a run whose trace holds device work ran on the card
    device = "cuda" if run.trace["kernels"] else "cpu"
    cell = types.SimpleNamespace(config=run.config, traffic=run.traffic)
    seconds = min(WINDOW_S, run.window_s)
    out = measure(cell, _run_seed(), seconds, device)
    if run.work.get("rays"):
        out["spans_on_over_off_rate"] = out["rate"] / (run.work["rays"] / run.window_s)
    detail = out["detail"]
    shown = {n: dict(v, kernels=[[k[:100], t] for k, t in sorted(v["kernels"].items(), key=lambda kv: -kv[1])[:6]])
             for n, v in detail["spans"].items()}
    print("portbench.program_spans " + json.dumps(out | {"detail": detail | {
        "spans": shown, "idle_gaps": detail["idle_gaps"][:20]}}), file=sys.stderr)
    return out


def _run_seed() -> int:
    """The ``--seed`` of the run's command line (``run.py``), else a fixed
    one (a run driven from Python)."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=FALLBACK_SEED)
    return p.parse_known_args(sys.argv[1:])[0].seed


def measure(cell, seed: int, seconds: float, device) -> dict:
    """The two windows with the program's spans on (module docstring):
    numbers a view (``host_self_ms``: each span's host self time, in the
    unprofiled window), and ``detail``, the spans' table and labelled
    gaps."""
    from pixelnerf_tpu_torch.eval.common import FullRenderer
    from pixelnerf_tpu_torch.utils import geometry, profiling

    cfg, tr = cell.config, cell.traffic
    cam = cfg["camera"]
    h, w = cam["image_size"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wts = weights_mod.make(cfg, mlp_acc.model_d_in(cfg["model"]), seed, device)
    net = program.build_net(cfg, tr["dtype"], device, wts)
    renderer = FullRenderer(net, program.render_config(cfg), ray_chunk=tr["ray_chunk"], fast=tr["fast"], staged=True)
    focal_t = torch.tensor([scene.focal_pair(cam)], device=device)
    c_t = torch.tensor([cam["c"]], device=device, dtype=torch.float32)
    targets = scene.trajectory(tr["trajectory"], cam, device)

    def request(spans, sess, s, k, enc):
        # render_cell.run's request
        draws = view_draws(cell, seed, s, k, device)
        chunks = [{n: v[:, a:a + tr["ray_chunk"]] for n, v in draws.items()} for a in range(0, h * w, tr["ray_chunk"])]
        if enc is None:
            with spans("encode", synced=True):
                enc = net.encode(sess.images[None], sess.src_poses[None], focal_t, c_t)
        with spans("render"):
            rays = geometry.gen_rays(sess.targets[k:k + 1], w, h, scene.focal_pair(cam), cam["z_near"], cam["z_far"],
                                     c=cam["c"], device=device)[0]
            renderer.render_image(enc, rays, noise=chunks)
        with spans("sync"):
            sync()
        return enc

    def window(spans) -> tuple:
        """Whole requests until ``seconds`` have passed and at least
        ``MIN_VIEWS`` were made: (views, seconds)."""
        views, s, t0 = 0, 0, time.perf_counter()
        while True:
            with spans("client"):
                sess = Session(cell, seed, s, device, targets)
            enc = None
            for k in range(len(targets)):
                enc = request(spans, sess, s, k, enc)
                views += 1
                if views >= MIN_VIEWS and time.perf_counter() - t0 >= seconds:
                    return views, time.perf_counter() - t0
            s += 1

    with torch.inference_mode():
        request(Spans("off", sync), Session(cell, seed, -1, device, targets), -1, 0, None)
        sync()
        profiling.take()
        profiling.enable()
        try:
            views, window_s = window(Spans("off", sync))
            host = profiling.take()
            with Trace(True, cuda) as trace:
                p_views, p_window_s = window(Spans("labels", sync))
            dropped = profiling.dropped()
            records = profiling.take()
        finally:
            profiling.disable()
            profiling.take()
    del net, renderer
    if cuda:
        torch.cuda.empty_cache()

    att = attribute(trace.prof.profiler.kineto_results.events(), records, SPANS, threading.get_native_id())
    spans = att["spans"]
    host_ns = sum(r.end - r.start for r in host if r.parent is None and r.name in HOST)
    host_self = defaultdict(float)
    for r, own in zip(host, profiling.self_times(host)):
        host_self[r.name] += own / 1e6 / views
    out = {"views": views, "profiled_views": p_views, "rate": views * h * w / window_s,
           "profiled_over_unprofiled_rate": (p_views / p_window_s) / (views / window_s),
           "host_ms": host_ns / 1e6 / views,
           "host_syncs": sum(att["root_syncs"].get(n, 0) for n in HOST) / p_views,
           "host_self_ms": dict(host_self), "dropped": dropped,
           "detail": att}
    if att["device_s"] > 0:
        out["renderer_ms"] = 1e3 * sum(spans[n]["device_s"] for n in RENDERER if n in spans) / p_views
        out["mlp_ms"] = 1e3 * spans.get("field.mlp", {}).get("device_s", 0.0) / p_views
        out["features_ms"] = 1e3 * spans.get("field.features", {}).get("device_s", 0.0) / p_views
    return out


def attribute(events, records, span_names, thread: int) -> dict:
    """Put the profiled window's device work and host waits down to the
    program's spans.

    :param events: the profiler's events (``kineto_results.events()``), the
        window marked by ``trace.WINDOW``
    :param records: the program's span records of the window, as
        ``profiling.take()`` returns them
    :param span_names: the benchmark's own spans, which label the gaps first
    :param thread: the OS id of the thread that ran the window
    :return: ``spans`` {name: device_s, launches, syncs, kernels {name:
        s}} with ``(outside)`` (and ``(unlinked)``, device work whose
        runtime call is not in the trace); ``device_s``, the window's
        device time, which the spans' sum; ``root_syncs`` {root span name:
        waits}; ``sync_ops`` {"<span>/<innermost host operation>": waits};
        ``window_s``, ``busy_s`` (as ``Trace.reduce`` gives them);
        ``idle_gaps`` ([label, s], the largest first)
    """
    cuda_type = torch.autograd.DeviceType.CUDA
    device, cpu, window = [], [], None
    for e in events:
        if e.device_type() == cuda_type:
            if not _is_annotation(e):
                device.append((_ns(e), _ns(e, True), e.name(), e.correlation_id()))
        else:
            if e.name() == WINDOW:
                window = (_ns(e), _ns(e, True), e.start_thread_id())
            cpu.append((_ns(e), _ns(e, True), e.name(), e.start_thread_id(), e.correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1, main = window
    main_cpu = [c for c in cpu if c[3] == main]
    runtime = {c[4]: c for c in cpu if c[2].startswith("cu")}

    kept = [r for r in records if r.thread == thread and r.end is not None]
    names = {r.index: r.name for r in kept}
    root = {}
    for r in sorted(kept, key=lambda r: r.index):
        root[r.index] = root.get(r.parent, r.index) if r.parent is not None else r.index
    intervals = sorted((r.start, r.end, r.index) for r in kept)

    def innermost(times):
        order = sorted(range(len(times)), key=times.__getitem__)
        found = _innermost(intervals, [times[i] for i in order])
        out = [None] * len(times)
        for i, f in zip(order, found):
            out[i] = f
        return out

    spans = defaultdict(lambda: {"device_s": 0.0, "launches": 0, "syncs": 0, "kernels": defaultdict(float)})
    device = sorted((max(a, w0), min(b, w1), n, corr) for a, b, n, corr in device if b > w0 and a < w1)
    calls = [runtime.get(corr) for _, _, _, corr in device]
    on_main = [c is not None and c[3] == main for c in calls]
    where = innermost([c[0] if c is not None else 0 for c in calls])
    total = 0
    for (a, b, n, _), call, main_call, idx in zip(device, calls, on_main, where):
        if call is None:
            key = UNLINKED
        else:
            key = names[idx] if main_call and idx is not None else OUTSIDE
        s = spans[key]
        s["device_s"] += (b - a) / 1e9
        s["launches"] += 1
        s["kernels"][n] += (b - a) / 1e9
        total += b - a

    root_syncs, sync_ops = defaultdict(int), defaultdict(int)
    waits = [c for c in main_cpu if c[2] in SYNCS]
    ops = sorted((a, b, n) for a, b, n, _, _ in main_cpu if n not in SYNCS and not n.startswith("cu")
                 and n not in span_names and n != WINDOW)
    for c, idx, op in zip(waits, innermost([c[0] for c in waits]), _innermost(ops, [c[0] for c in waits])):
        name = names[idx] if idx is not None else OUTSIDE
        spans[name]["syncs"] += 1
        root_syncs[names[root[idx]] if idx is not None else OUTSIDE] += 1
        sync_ops[f"{name}/{op or 'none'}"] += 1

    gaps, cur = [], w0
    for a, b, _, _ in device:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    idle_ns = sum(b - a for a, b in gaps)
    labels = _label_gaps(gaps, [c[:4] for c in main_cpu if c[2] != WINDOW], set(span_names))
    idle = defaultdict(float)
    for (a, b), label, idx in zip(gaps, labels, innermost([(a + b) // 2 for a, b in gaps])):
        if idx is not None:
            bench, op = label.split("/", 1)
            label = f"{bench}/{names[idx]}/{op}"
        idle[label] += (b - a) / 1e9

    for s in spans.values():
        s["kernels"] = dict(s["kernels"])
    return {"spans": dict(spans), "device_s": total / 1e9, "root_syncs": dict(root_syncs),
            "sync_ops": dict(sync_ops), "window_s": (w1 - w0) / 1e9, "busy_s": (w1 - w0 - idle_ns) / 1e9,
            "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])]}

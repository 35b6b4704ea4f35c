"""The port's own spans (``pixelnerf_tpu_torch/utils/profiling.py``): the
recorder off and on, self time, the span tree of a render request, the
train step's and the pipeline's spans, the shared clock with
``torch.profiler``, and the spans in the train app's chrome trace. CPU
only, a small SRN-shaped model."""
from __future__ import annotations

import json
import os
import sys
import threading

import pytest
import torch

from pixelnerf_tpu_torch.config import load_config
from pixelnerf_tpu_torch.eval import FullRenderer
from pixelnerf_tpu_torch.models import make_model
from pixelnerf_tpu_torch.render import RenderConfig
from pixelnerf_tpu_torch.train.loss import make_render_loss
from pixelnerf_tpu_torch.train.step import make_train_step
from pixelnerf_tpu_torch.utils import geometry, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 16


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with the spans off and no record kept."""
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_keeps_nothing_and_returns_the_shared_object():
    a = profiling.span("request", rays=4)
    b = profiling.span("field.mlp")
    assert a is b
    with a as s:
        s.count("rows", 3)
        profiling.count("rows", 3)
    assert profiling.take() == [] and profiling.dropped() == 0


def test_on_records_nesting_parents_requests_and_counts():
    profiling.enable()
    with profiling.span("rays", rays=8):
        pass
    with profiling.span("request", rays=8) as req:
        with profiling.span("render_rays") as rr:
            with profiling.span("field.mlp", rows=5) as m:
                m.count("rows", 2)
                profiling.count("kernel_b")
        req.count("chunks")
    with profiling.span("request"):
        with profiling.span("field.features"):
            pass
    profiling.disable()
    with profiling.span("after"):
        pass
    recs = profiling.take()
    assert [r.name for r in recs] == ["rays", "request", "render_rays", "field.mlp", "request", "field.features"]
    assert [r.index for r in recs] == list(range(6))
    assert [r.parent for r in recs] == [None, None, 1, 2, None, 4]
    assert recs[0].request is None
    assert recs[1].request == recs[2].request == recs[3].request
    assert recs[4].request == recs[5].request != recs[1].request
    assert recs[1].counts == {"rays": 8, "chunks": 1}
    assert recs[3].counts == {"rows": 7, "kernel_b": 1}
    assert rr.start <= m.start <= m.end <= rr.end and req.start <= rr.start
    assert all(r.thread == threading.get_native_id() for r in recs)
    assert profiling.take() == []


def test_each_thread_keeps_its_own_stack():
    profiling.enable()
    inner_started, release = threading.Event(), threading.Event()

    def other():
        with profiling.span("data.next"):
            inner_started.set()
            release.wait(10)

    with profiling.span("train.step"):
        t = threading.Thread(target=other)
        t.start()
        assert inner_started.wait(10)
        with profiling.span("forward"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    recs = _by_name(profiling.take())
    step, fwd, nxt = recs["train.step"][0], recs["forward"][0], recs["data.next"][0]
    assert fwd.parent == step.index and nxt.parent is None
    assert nxt.thread != step.thread == fwd.thread


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.span("rays"):
            pass
    assert profiling.dropped() == 2
    assert len(profiling.take()) == 3
    assert profiling.dropped() == 0


def test_self_time_is_a_span_less_its_children():
    profiling.enable()
    with profiling.span("request"):
        with profiling.span("render_rays"):
            with profiling.span("field.features"):
                sum(range(20000))
            with profiling.span("field.mlp"):
                sum(range(20000))
        with profiling.span("render_rays.merge"):
            pass
    recs = profiling.take()
    own = profiling.self_times(recs)
    length = [r.end - r.start for r in recs]
    assert own[0] == length[0] - length[1] - length[4]
    assert own[1] == length[1] - length[2] - length[3]
    assert own[2] == length[2] and own[3] == length[3]
    assert all(t >= 0 for t in own)


def _tiny(dtype=None, d_hidden=32):
    conf = load_config(os.path.join(REPO, "conf", "exp", "srn.conf"))
    m = conf["model"]
    m["encoder"]["num_layers"] = 2
    for mlp in ("mlp_coarse", "mlp_fine"):
        m[mlp]["d_hidden"] = d_hidden
    if dtype is not None:
        m["dtype"] = dtype
    r = conf["renderer"]
    r["n_coarse"], r["n_fine"], r["n_fine_depth"] = 16, 8, 4
    net = make_model(conf["model"], device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    images = torch.rand((1, 1, 32, 32, 3), generator=g) * 2 - 1
    poses = torch.from_numpy(geometry.look_at((0.0, 0.4, 1.3), (0.0, 0.0, 0.0)))[None, None]
    return net, conf, images, poses


@pytest.mark.parametrize("dtype,fast,path", [(None, False, "dense"), ("bfloat16", True, "kernel_b")])
def test_a_render_request_gives_the_span_tree_of_its_layers(dtype, fast, path):
    sys.path.insert(0, REPO)
    from portbench.accounting.mlp import field_rows_per_ray

    net, conf, images, poses = _tiny(dtype)
    cfg = RenderConfig.from_conf(conf["renderer"])
    chunk = SIDE * SIDE // 2 + 7       # two chunks, the second short
    renderer = FullRenderer(net, cfg, ray_chunk=chunk, fast=fast)
    target = geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0))
    profiling.enable()
    with torch.inference_mode():
        enc = net.encode(images, poses, torch.full((1,), 30.0))
        rays = geometry.gen_rays(target[None], SIDE, SIDE, 30.0 * SIDE / 32, 0.8, 1.8, device="cpu")[0]
        rgb, _ = renderer.render_image(enc, rays, generator=torch.Generator().manual_seed(2))
    recs = profiling.take()
    assert rgb.shape == (SIDE, SIDE, 3)
    by = _by_name(recs)
    assert [r.name for r in recs if r.parent is None] == ["encode", "rays", "request"]
    assert by["encode"][0].counts == {"images": 1}
    assert by["rays"][0].counts == {"rays": SIDE * SIDE}
    req = by["request"][0]
    assert req.counts == {"rays": SIDE * SIDE, "chunks": 2} and req.request is not None
    assert [r.counts["rays"] for r in by["render_rays"]] == [chunk, SIDE * SIDE - chunk]
    assert all(r.parent == req.index for r in by["render_rays"] + by["render_rays.merge"])
    assert len(by["render_rays.merge"]) == 1
    for rr in by["render_rays"]:
        kids = [r for r in recs if r.parent == rr.index]
        assert [r.name for r in kids] == ["field.features", "field.mlp", "field.mlp", "field.features", "field.mlp"]
        assert all(k.request == req.request for k in kids)
    assert len(by["field.features"]) == 4 and len(by["field.mlp"]) == 6
    assert all(r.counts[path] == 1 and len(r.counts) == 2 for r in by["field.mlp"])
    rows = sum(r.counts["rows"] for r in by["field.mlp"])
    assert rows == field_rows_per_ray(cfg.n_coarse, cfg.n_fine) * SIDE * SIDE
    points = sum(r.counts["points"] for r in by["field.features"])
    assert points == (cfg.n_coarse + cfg.n_fine) * SIDE * SIDE
    assert all(r.counts["views"] == 1 for r in by["field.features"])


@pytest.mark.parametrize("dtype,fast,path", [(None, False, "dense"), ("bfloat16", True, "kernel_b")])
def test_a_multi_view_request_counts_the_views_of_kernel_b(dtype, fast, path):
    """At three source views the field MLP's spans say which path ran: the
    dense chain, or kernel B's multi-view mode with ``kernel_b_views``, the
    views a launch averages."""
    net, conf, _, _ = _tiny(dtype)
    g = torch.Generator().manual_seed(3)
    images = torch.rand((1, 3, 32, 32, 3), generator=g) * 2 - 1
    poses = torch.stack([torch.from_numpy(geometry.look_at(eye, (0.0, 0.0, 0.0)))
                         for eye in ((0.0, 0.4, 1.3), (0.5, 0.3, 1.2), (-0.5, 0.3, 1.2))])[None]
    cfg = RenderConfig.from_conf(conf["renderer"])
    renderer = FullRenderer(net, cfg, ray_chunk=SIDE * SIDE, fast=fast)
    target = geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0))
    profiling.enable()
    with torch.inference_mode():
        enc = net.encode(images, poses, torch.full((1,), 30.0))
        rays = geometry.gen_rays(target[None], SIDE, SIDE, 30.0 * SIDE / 32, 0.8, 1.8, device="cpu")[0]
        rgb, _ = renderer.render_image(enc, rays, generator=torch.Generator().manual_seed(2))
    by = _by_name(profiling.take())
    assert rgb.shape == (SIDE, SIDE, 3) and torch.isfinite(rgb).all()
    assert all(r.counts["views"] == 3 for r in by["field.features"])
    mlp = by["field.mlp"]
    assert len(mlp) == 3 and all(r.counts[path] == 1 for r in mlp)
    want = {"kernel_b_views": 3} if path == "kernel_b" else {}
    assert all({k: v for k, v in r.counts.items() if k not in ("rows", path)} == want for r in mlp)


def test_a_train_step_gives_its_forward_backward_and_optimizer_spans():
    net, conf, images, poses = _tiny()
    cfg = RenderConfig.from_conf(conf["renderer"])
    opt = torch.optim.Adam(net.parameters(), lr=1e-4)
    step = make_train_step(net, cfg, opt, make_render_loss(conf["loss"]))
    target = geometry.look_at((0.9, 0.3, 1.0), (0.0, 0.0, 0.0))
    rays = geometry.gen_rays(target[None], 4, 4, 7.5, 0.8, 1.8, device="cpu").reshape(1, 16, 8)
    batch = {"images": images, "poses": poses, "focal": torch.full((1,), 30.0), "c": torch.full((1, 2), 16.0),
             "rays": rays, "rgb_gt": torch.rand((1, 16, 3), generator=torch.Generator().manual_seed(3))}
    profiling.enable()
    step(batch, generator=torch.Generator().manual_seed(1))
    recs = profiling.take()
    by = _by_name(recs)
    top = by["train.step"][0]
    assert top.parent is None and top.counts == {"rays": 16}
    assert [r.name for r in recs if r.parent == top.index] == ["forward", "backward", "optimizer"]
    fwd = by["forward"][0]
    assert [r.name for r in recs if r.parent == fwd.index] == ["encode", "render_rays"]


def test_the_pipeline_wait_is_a_span():
    from pixelnerf_tpu_torch.data.pipeline import RayBatchPipeline
    from pixelnerf_tpu_torch.data.synthetic import SyntheticSphereDataset

    ds = SyntheticSphereDataset(num_objects=2, num_views=3, image_size=(8, 8))
    pipe = RayBatchPipeline(ds, batch_size=1, rays_per_object=4, prefetch=1, workers=1, seed=0)
    profiling.enable()
    it = iter(pipe)
    for _ in range(2):
        next(it)
    it.close()
    waits = [r for r in profiling.take() if r.name == "data.next"]
    assert len(waits) == 2 and all(r.thread == threading.get_native_id() for r in waits)


def test_the_profiler_stamps_its_host_events_on_the_spans_clock():
    """A ``record_function`` marker opened inside a program span starts
    and ends inside it: the two share one clock."""
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.enable()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span("field.mlp"):
                with record_function(f"marker{i}"):
                    x = x @ x.T / 64
    recs = profiling.take()
    marks = sorted((e for e in prof.profiler.kineto_results.events() if e.name().startswith("marker")),
                   key=lambda e: e.name())
    assert len(marks) == 5
    for r, e in zip(recs, marks):
        assert r.start <= e.start_ns() and e.start_ns() + e.duration_ns() <= r.end, (r.start, r.end, e.start_ns())


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    """``trace()`` (the train app's ``--profile_dir``): the spans are
    complete events of their thread, inside the ATen ops' frame."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.span("train.step", rays=4):
            with profiling.span("forward"):
                y = x @ x
    assert not profiling._on and profiling.take() == []
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert set(ours) == {"train.step", "forward"}
    step, fwd = ours["train.step"], ours["forward"]
    assert step["ph"] == "X" and step["tid"] == threading.get_native_id() and step["pid"] == os.getpid()
    assert step["args"]["rays"] == 4 and fwd["args"]["parent"] == 0
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"] for e in mm)
    assert step["ts"] <= fwd["ts"] and fwd["ts"] + fwd["dur"] <= step["ts"] + step["dur"]
    del y

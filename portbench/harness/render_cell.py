"""Render sessions, closed loop, one client: a session encodes new source
views made from the seed, then renders the traffic's trajectory of target
views of them, each a request timed from its issue to ``synchronize()``.
The window runs whole requests until ``seconds`` have passed; its rate is
every completed view's rays over its length. A traced run then runs a
second, profiled window (``trace.py``).

Correctness: once the windows have closed, a sample of their views drawn
from the seed, and of each view's rays, is rendered again by the plain
reference from the same weights, source images, poses and draws, and the
program's latent, rgb and depth are compared with it."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..accounting import mlp as mlp_acc
from ..reference import encoder as ref_encoder
from ..reference import field as ref_field
from ..reference import render as ref_render
from ..reference.precision import Precision, exact_float32
from . import program, scene, seeds, weights as weights_mod
from .trace import Spans, Trace

SPANS = ("client", "encode", "render", "sync")


class Session:
    """One session's inputs, made from (seed, session index); its target
    cameras are the traffic's trajectory, the same in every session."""

    def __init__(self, cell, seed: int, index: int, device, targets: torch.Tensor):
        cfg = cell.config
        cam = cfg["camera"]
        h, w = cam["image_size"]
        ns = cfg["source_views"]
        gen = seeds.generator(device, seed, "session", index)
        self.targets = targets
        if cfg["scene"] == "object":
            objs = scene.random_objects(gen, 1, device)
            self.src_poses = scene.sphere_poses(gen, ns, cam["radius"], device)
            imgs = scene.render_objects(objs, self.src_poses[None], h, w, cam["focal"], cam["c"])[0]
            self.images = scene.to_unit(imgs)
        else:
            self.images = scene.smooth_views(gen, ns, h, w, device)
            arc = cam["arc"]
            self.src_poses = scene.arc_poses(torch.tensor(cam["source_positions"], dtype=torch.float32,
                                                          device=device), arc["count"], arc["radius"], arc["height"])


def view_draws(cell, seed: int, session: int, view: int, device):
    h, w = cell.config["camera"]["image_size"]
    gen = seeds.generator(device, seed, "draws", session, view)
    return program.draws(gen, (1, h * w), cell.config["renderer"], device)


def reference_rays(pose: torch.Tensor, pix: torch.Tensor, cam: dict) -> torch.Tensor:
    """(R, 8) rays of pixels ``pix`` (flat indices) of a view at ``pose``."""
    h, w = cam["image_size"]
    fx, fy = scene.focal_pair(cam)
    y, x = (pix // w).float(), (pix % w).float()
    d = torch.stack([(x - cam["c"][0]) / fx, -(y - cam["c"][1]) / fy, -torch.ones_like(x)], dim=-1)
    d = d / d.norm(dim=-1, keepdim=True)
    dw = d @ pose[:3, :3].t()
    nf = torch.tensor([cam["z_near"], cam["z_far"]], device=pose.device).expand(len(pix), 2)
    return torch.cat([pose[:3, 3].expand(len(pix), 3), dw, nf], dim=-1)


def window_work(cfg: dict, views: int, sessions: int) -> dict:
    """A window's counts of work: views, encodes, rays, field rows and
    gathered points."""
    h, w = cfg["camera"]["image_size"]
    r = cfg["renderer"]
    rays = views * h * w
    return {"views": views, "sessions": sessions, "rays": rays,
            "field_rows": rays * mlp_acc.field_rows_per_ray(r["n_coarse"], r["n_fine"]),
            "gather_points": rays * (r["n_coarse"] + r["n_fine"]) * cfg["source_views"]}


def run(cell, seed: int, seconds: float, traced: bool, device, controls=()) -> dict:
    """Run the cell once on ``device``: set-up, the window (and with
    ``traced`` the profiled one), then the check; with ``controls``
    (precision names) also each control's numbers."""
    from pixelnerf_tpu_torch.eval.common import FullRenderer
    from pixelnerf_tpu_torch.utils import geometry

    cfg, tr = cell.config, cell.traffic
    cam = cfg["camera"]
    h, w = cam["image_size"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    d_in = mlp_acc.model_d_in(cfg["model"])
    phases = {"imports": time.perf_counter()}
    wts = weights_mod.make(cfg, d_in, seed, device)
    phases["weights"] = time.perf_counter()
    net = program.build_net(cfg, tr["dtype"], device, wts)
    phases["model"] = time.perf_counter()
    renderer = FullRenderer(net, program.render_config(cfg), ray_chunk=tr["ray_chunk"], fast=tr["fast"], staged=True)
    focal_t = torch.tensor([scene.focal_pair(cam)], device=device)
    c_t = torch.tensor([cam["c"]], device=device, dtype=torch.float32)
    targets = scene.trajectory(tr["trajectory"], cam, device)

    def request(spans, sess, s, k, enc):
        draws = view_draws(cell, seed, s, k, device)
        chunks = [{n: v[:, a:a + tr["ray_chunk"]] for n, v in draws.items()} for a in range(0, h * w, tr["ray_chunk"])]
        if enc is None:
            with spans("encode", synced=True):
                enc = net.encode(sess.images[None], sess.src_poses[None], focal_t, c_t)
        with spans("render"):
            rays = geometry.gen_rays(sess.targets[k:k + 1], w, h, scene.focal_pair(cam), cam["z_near"], cam["z_far"],
                                     c=cam["c"], device=device)[0]
            rgb, depth = renderer.render_image(enc, rays, noise=chunks)
        with spans("sync"):
            sync()
        return enc, rgb, depth

    views, sessions = [], {}

    def window(spans) -> tuple:
        """Whole requests until ``seconds`` have passed, each session from
        a new index: (the window's views, sessions begun, seconds)."""
        first, s0, done = len(views), len(sessions), False
        s = s0
        t_start = time.perf_counter()
        while not done:
            with spans("client"):
                sess = Session(cell, seed, s, device, targets)
            enc = None
            for k in range(len(targets)):
                t0 = time.perf_counter()
                enc, rgb, depth = request(spans, sess, s, k, enc)
                t1 = time.perf_counter()
                views.append({"session": s, "view": k, "seconds": t1 - t0, "rgb": rgb, "depth": depth})
                if t1 - t_start >= seconds:
                    done = True
                    break
            sessions[s] = {"inputs": sess, "latent": enc.latent}
            s += 1
        return views[first:], s - s0, time.perf_counter() - t_start

    with torch.inference_mode():
        # warm-up: one session's encode and one view, the cell's shapes
        warm = Session(cell, seed, -1, device, targets)
        request(Spans("off", sync), warm, -1, 0, None)
        sync()
        setup_end = phases["warm_up"] = time.perf_counter()
        before = program.counters()
        spans = Spans("timed" if traced else "off", sync)
        timed, n_sessions, window_s = window(spans)
        phases["window"] = time.perf_counter()
        launches = program.counters(before)
        reduced = None
        if traced:
            with Trace(True, cuda) as trace:
                profiled, p_sessions, p_window_s = window(Spans("labels", sync))
            phases["profiled_window"] = time.perf_counter()
            reduced = trace.reduce(SPANS)
            reduced["window_work"] = window_work(cfg, len(profiled), p_sessions)
            reduced["host_window_s"] = p_window_s
            phases["trace_reduced"] = time.perf_counter()
    memory = int(torch.cuda.max_memory_allocated()) if cuda else 0
    del net, renderer
    if cuda:
        torch.cuda.empty_cache()

    lat = np.array([v["seconds"] for v in timed])
    failed = int(sum(int(not (torch.isfinite(v["rgb"]).all() and torch.isfinite(v["depth"]).all()))
                     for v in views))
    work = window_work(cfg, len(timed), n_sessions)
    e2e = {tr["rate_metric"]: work["rays"] / window_s, "view_ms_p95": float(np.percentile(lat * 1e3, 95)),
           "setup_s": setup_end}
    numbers = check(cell, seed, device, wts, views, sessions)
    phases["check"] = time.perf_counter()
    control_numbers = {c: check(cell, seed, device, wts, views, sessions, control=c) for c in controls}
    return {"e2e": e2e, "work": work, "window_s": window_s, "trace": reduced, "spans": dict(spans.seconds),
            "attempted": len(views), "failed": failed, "numbers": numbers, "memory": memory, "launches": launches,
            "controls": control_numbers, "phases": phases}


def check_sample(cell, seed: int, n_views: int):
    rng = scene.numpy_rng(seed, "check")
    k = min(cell.traffic["check_views"], n_views)
    return rng, sorted(rng.choice(n_views, k, replace=False).tolist())


def reference_view(cell, wts, latent, sess, k, pix, draws, prec, chunk=1024):
    """The reference's (rgb, depth) of pixels ``pix`` of view k."""
    cfg = cell.config
    cam = cfg["camera"]
    h, w = cam["image_size"]
    sc = ref_field.Scene(latent, sess.src_poses, torch.tensor(scene.focal_pair(cam), device=latent.device),
                         torch.tensor(cam["c"], dtype=torch.float32, device=latent.device), (w, h))
    rays = reference_rays(sess.targets[k], pix, cam)

    def fld(pts, dirs, coarse):
        return ref_field.query(wts, cfg["model"], sc, pts, dirs, coarse, prec)

    rgb, depth = [], []
    for a in range(0, len(pix), chunk):
        sel = pix[a:a + chunk]
        out = ref_render.render(fld, rays[a:a + chunk], {n: v[0, sel] for n, v in draws.items()}, cfg["renderer"])
        rgb.append(out["fine"][0])
        depth.append(out["fine"][1])
    return torch.cat(rgb), torch.cat(depth)


@torch.no_grad()
def check(cell, seed, device, wts, views, sessions, control: str = None) -> dict:
    """The compared numbers. With ``control``, the reference computed at
    that precision stands in for the program's outputs.

    ``latent_rel_err``: the latent's relative error. ``rgb_mae``,
    ``depth_mae``: mean absolute errors a ray, the worst view.
    ``rgb_over_bf16``, ``depth_over_bf16``: the mean absolute error over
    all the sampled rays, over the reference's own at bf16 on the same rays
    (``Precision("bf16")``): how much the error exceeds what bf16 rounding
    brings on these scenes. A random scene's outputs are several times more
    sensitive to rounding on some seeds than on others, which moves the
    program's error and its control's alike; the ratio cancels it."""
    from .checks import rel_norm

    cam = cell.config["camera"]
    enc_cfg = cell.config["model"]["encoder"]
    h, w = cam["image_size"]
    span = cam["z_far"] - cam["z_near"]
    rng, picked = check_sample(cell, seed, len(views))
    n_rays = min(cell.traffic["check_rays"], h * w)
    ref_prec, bf16 = Precision(), Precision("bf16")
    ctrl_prec = Precision(control) if control else None
    lat_err, rgb_mae, depth_mae = 0.0, 0.0, 0.0
    sums = {"rgb": 0.0, "rgb_bf16": 0.0, "depth": 0.0, "depth_bf16": 0.0}
    latents = {}
    with exact_float32():
        for i in picked:
            v = views[i]
            s = v["session"]
            sess = sessions[s]["inputs"]
            if s not in latents:
                ref_lat = ref_encoder.encode(wts, sess.images, enc_cfg, ref_prec)
                got = (ref_encoder.encode(wts, sess.images, enc_cfg, ctrl_prec) if control
                       else sessions[s]["latent"].float())
                latents[s] = (ref_lat, got, ref_encoder.encode(wts, sess.images, enc_cfg, bf16))
                lat_err = max(lat_err, rel_norm(got, ref_lat))
            ref_lat, got_lat, bf16_lat = latents[s]
            pix = torch.as_tensor(np.sort(rng.choice(h * w, n_rays, replace=False)), device=device)
            draws = view_draws(cell, seed, s, v["view"], device)
            rgb_r, depth_r = reference_view(cell, wts, ref_lat, sess, v["view"], pix, draws, ref_prec)
            rgb_b, depth_b = reference_view(cell, wts, bf16_lat, sess, v["view"], pix, draws, bf16)
            if control:
                rgb_p, depth_p = reference_view(cell, wts, got_lat, sess, v["view"], pix, draws, ctrl_prec)
            else:
                rgb_p, depth_p = v["rgb"].reshape(-1, 3)[pix].float(), v["depth"].reshape(-1)[pix].float()
            rgb_e = (rgb_p - rgb_r).abs().double().mean(dim=-1)
            depth_e = (depth_p - depth_r).abs().double() / span
            rgb_mae, depth_mae = max(rgb_mae, float(rgb_e.mean())), max(depth_mae, float(depth_e.mean()))
            sums["rgb"] += float(rgb_e.sum())
            sums["depth"] += float(depth_e.sum())
            sums["rgb_bf16"] += float((rgb_b - rgb_r).abs().double().mean(dim=-1).sum())
            sums["depth_bf16"] += float((depth_b - depth_r).abs().double().sum()) / span
    return {"latent_rel_err": lat_err, "rgb_mae": rgb_mae, "depth_mae": depth_mae,
            "rgb_over_bf16": sums["rgb"] / max(sums["rgb_bf16"], 1e-30),
            "depth_over_bf16": sums["depth"] / max(sums["depth_bf16"], 1e-30)}

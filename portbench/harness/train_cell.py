"""Training steps: ``make_train_step`` fed by ``RayBatchPipeline`` over the
SRN reader, as the train app runs them, on an SRN-layout data set of PNGs
written at set-up (optionally held whole in the reader's decoded-object
cache, filled by one pass at set-up).

Set-up builds the step, its model and optimizer once, and drives it from
the seed through its first three steps, through the window's own call and
feed; the same object then runs the window, a step after a step until
``seconds`` have passed, and the rate is every completed step's rays over
the window's length. A traced run then runs a second, profiled window
(``trace.py``).

Correctness: once the windows have closed, the plain reference reads the
PNGs itself, draws the same three batches, and runs the three steps from
the same weights with the same draws. Compared: the batches' pixels and
geometry, the first step's loss, the first gradient as Adam holds it
after one step (by the worst leaf), and each parameter's change after
three steps, before the fourth step moves them (by the median leaf and
by the worst)."""
from __future__ import annotations

import concurrent.futures as cf
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from ..accounting import mlp as mlp_acc
from ..reference import srn_data
from ..reference import train as ref_train
from ..reference.precision import Precision, exact_float32
from . import dataset, program, seeds, weights as weights_mod
from .trace import Spans, Trace

SPANS = ("batch_wait", "to_device", "draws", "step")
CHECKED_STEPS = 3
# a leaf whose reference gradient is under this share of the median leaf's
# is moved by Adam from round-off alone: left out of the change's comparison
NOUGHT = 1e-3


def pipeline_seed(seed: int) -> int:
    return seeds.derive(seed, "pipeline")


def run(cell, seed: int, seconds: float, traced: bool, device, controls=()) -> dict:
    """Run the cell once on ``device``: set-up, the window, then the check;
    with ``controls`` (precision names) also each control's numbers."""
    from pixelnerf_tpu_torch.config import ConfigNode
    from pixelnerf_tpu_torch.data import RayBatchPipeline, SRNDataset
    from pixelnerf_tpu_torch.train.loss import make_render_loss
    from pixelnerf_tpu_torch.train.step import make_train_step

    cfg, tr = cell.config, cell.traffic
    cam, data = cfg["camera"], cfg["train_data"]
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = tr["tf32"]
    torch.backends.cudnn.allow_tf32 = tr["tf32"]
    d_in = mlp_acc.model_d_in(cfg["model"])
    phases = {"imports": time.perf_counter()}
    wts = weights_mod.make(cfg, d_in, seed, device)
    phases["weights"] = time.perf_counter()
    names = weights_mod.trainable(cfg, d_in)
    tmp = tempfile.mkdtemp(prefix="portbench-data-")
    it = None
    try:
        root = dataset.write_srn(tmp, cfg, data["objects"], data["views"], seed, device)
        phases["data_set"] = time.perf_counter()
        dset = SRNDataset(root, stage="train", image_size=tuple(cam["image_size"]),
                          cache_cap=data["objects"] if tr["cache"] else 0)
        if tr["cache"]:
            with cf.ThreadPoolExecutor(tr["workers"]) as pool:
                list(pool.map(dset.__getitem__, range(len(dset))))
        phases["cache"] = time.perf_counter()
        net = program.build_net(cfg, tr["dtype"], device, wts)
        phases["model"] = time.perf_counter()
        opt_cfg = cfg["optimizer"]
        optimizer = torch.optim.Adam(net.parameters(), lr=opt_cfg["lr"], betas=tuple(opt_cfg["betas"]),
                                     eps=opt_cfg["eps"])
        loss_cfg = cfg["loss"]
        loss_fn = make_render_loss(ConfigNode({
            "lambda_coarse": loss_cfg["lambda_coarse"], "lambda_fine": loss_cfg["lambda_fine"],
            "rgb": ConfigNode({"use_l1": loss_cfg["use_l1"]}), "rgb_fine": ConfigNode({"use_l1": loss_cfg["use_l1"]})}))
        step = make_train_step(net, program.render_config(cfg), optimizer, loss_fn, train_encoder=True,
                               ray_chunk=tr["ray_chunk"])
        sb, rays = tr["objects_per_step"], tr["rays_per_object"]
        pipe = RayBatchPipeline(dset, batch_size=sb, rays_per_object=rays, views=tuple(tr["source_views"]),
                                seed=pipeline_seed(seed), prefetch=tr["prefetch"], workers=tr["workers"])
        it = iter(pipe)

        def one(i, spans):
            with spans("batch_wait"):
                batch = next(it)
            with spans("to_device"):
                dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "step"}
            with spans("draws"):
                draws = program.draws(seeds.generator(device, seed, "step", i), (sb, rays), cfg["renderer"], device)
            with spans("step", synced=True):
                metrics = step(dev, noise=[draws])
            return batch, metrics["t"]

        params = dict(net.named_parameters())
        beta1 = opt_cfg["betas"][0]
        checked, losses = [], []
        for i in range(CHECKED_STEPS):
            batch, loss = one(i, Spans("off", sync))
            checked.append(batch)
            losses.append(loss)
            if i == 0:
                # a step that left no optimizer state passed the optimizer no gradient
                grads = {n: optimizer.state[params[n]].get("exp_avg", torch.zeros_like(params[n])).detach().clone()
                         / (1 - beta1) for n in names}
        after = {n: params[n].detach().clone() for n in names}
        sync()
        setup_end = phases["first_steps"] = time.perf_counter()

        def window(spans) -> tuple:
            """Steps until ``seconds`` have passed: (steps, seconds)."""
            n, t_start = 0, time.perf_counter()
            while True:
                _, loss = one(len(losses), spans)
                losses.append(loss)
                n += 1
                if time.perf_counter() - t_start >= seconds:
                    sync()
                    return n, time.perf_counter() - t_start

        before = program.counters()
        spans = Spans("timed" if traced else "off", sync)
        n_steps, window_s = window(spans)
        phases["window"] = time.perf_counter()
        launches = program.counters(before)
        reduced = None
        if traced:
            with Trace(True, cuda) as trace:
                p_steps, p_window_s = window(Spans("labels", sync))
            phases["profiled_window"] = time.perf_counter()
            reduced = trace.reduce(SPANS)
            reduced["window_work"] = window_work(cfg, tr, p_steps)
            reduced["host_window_s"] = p_window_s
            phases["trace_reduced"] = time.perf_counter()
        it.close()
        it = None
        memory = int(torch.cuda.max_memory_allocated()) if cuda else 0
        failed = int(sum(int(not torch.isfinite(x)) for x in losses))
        prog = {"losses": [float(x) for x in losses[:CHECKED_STEPS]], "grads": grads, "after": after,
                "batches": checked}
        del net, optimizer, step
        if cuda:
            torch.cuda.empty_cache()
        numbers, look = check(cell, seed, device, wts, root, prog)
        phases["check"] = time.perf_counter()
        control_numbers = {c: check(cell, seed, device, wts, root, prog, control=c)[0] for c in controls}
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(tmp, ignore_errors=True)
    work = window_work(cfg, tr, n_steps)
    e2e = {"train_rays_per_s": work["rays"] / window_s, "setup_s": setup_end}
    return {"e2e": e2e, "work": work, "window_s": window_s, "trace": reduced, "spans": dict(spans.seconds),
            "attempted": len(losses) - CHECKED_STEPS, "failed": failed, "numbers": numbers, "memory": memory, "launches": launches,
            "controls": control_numbers, "phases": phases, "look": look}


def window_work(cfg: dict, tr: dict, steps: int) -> dict:
    """A window's counts of work: steps, rays and each step's operations."""
    return {"steps": steps, "rays": steps * tr["objects_per_step"] * tr["rays_per_object"],
            "step_flops": train_step_flops(cfg, tr)}


def train_step_flops(cfg: dict, tr: dict) -> int:
    """Forward and backward operations of one step's model work: the
    encoder on every source image, the field on every sample of every ray
    (the backward of a product takes two products, of its input and its
    weight)."""
    from ..accounting import encoder as enc_acc

    h, w = cfg["camera"]["image_size"]
    ns = max(tr["source_views"])
    images = tr["objects_per_step"] * ns
    rows = tr["objects_per_step"] * tr["rays_per_object"] * mlp_acc.field_rows_per_ray(
        cfg["renderer"]["n_coarse"], cfg["renderer"]["n_fine"])
    return (images * enc_acc.encoder_image_train_flops(cfg["model"]["encoder"], h, w)
            + 3 * rows * mlp_acc.config_point_flops(cfg["model"], ns))


def reference_batches(cell, seed: int, root: str):
    cfg, tr = cell.config, cell.traffic
    dirs = srn_data.object_dirs(root + "_train")
    cache = {}

    def objects(i):
        if i not in cache:
            cache[i] = srn_data.read_object(dirs[i])
        return cache[i]

    return srn_data.batches(objects, len(dirs), CHECKED_STEPS, pipeline_seed(seed), tr["objects_per_step"], tr["rays_per_object"],
                            tuple(tr["source_views"]), cfg["camera"]["z_near"], cfg["camera"]["z_far"],
                            lookahead=2 * tr["workers"])


def reference_steps(cell, seed, device, wts, batches, prec):
    cfg, tr = cell.config, cell.traffic
    d_in = mlp_acc.model_d_in(cfg["model"])
    rcfg = {"model": cfg["model"], "renderer": cfg["renderer"], "loss": cfg["loss"], "optimizer": cfg["optimizer"],
            "trainable": weights_mod.trainable(cfg, d_in)}
    tensors = [{k: torch.as_tensor(b[k]).to(device) for k in ("images", "poses", "focal", "c", "rays", "rgb_gt")}
               for b in batches]
    draws = [program.draws(seeds.generator(device, seed, "step", i), (tr["objects_per_step"], tr["rays_per_object"]),
                           cfg["renderer"], device) for i in range(len(batches))]
    return ref_train.train(wts, rcfg, tensors, draws, prec)


def leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    """Per leaf, |‖got‖ - ‖ref‖| over the larger of ‖ref‖ and the median
    leaf's ‖ref‖."""
    names = [n for n in ref if keep is None or n in keep]
    norms = {n: float(ref[n].double().norm()) for n in names}
    med = statistics.median(norms.values())
    return {n: abs(float(got[n].double().norm()) - norms[n]) / max(norms[n], med, 1e-30) for n in names}


def numbers_of(prog: dict, ref: tuple, wts: dict) -> tuple:
    """The compared numbers, and what the look at them needs (not compared):
    the worst leaves' names and the later steps' loss gaps."""
    losses_r, grads_r, after_r = ref
    gnorm = {n: float(g.double().norm()) for n, g in grads_r.items()}
    med = statistics.median(gnorm.values())
    moved = {n for n, g in gnorm.items() if g >= NOUGHT * med}
    grad = leaf_gaps(prog["grads"], grads_r)
    change = leaf_gaps({n: prog["after"][n] - wts[n] for n in after_r}, {n: after_r[n] - wts[n] for n in after_r},
                       moved)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], losses_r)]
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    numbers = {
        # the first step's loss, and the change by the median leaf beside the
        # worst: Adam moves a near-zero gradient entry by the step size
        # whatever its magnitude, so the later steps' losses and the worst
        # leaf's change carry round-off's signs (PERF.md, the look); the worst
        # leaf's limit still sees a leaf left unmoved, or moved double
        "loss_gap_1": loss[0],
        "grad_gap_1": grad[worst_grad],
        "change_gap_med": statistics.median(change.values()),
        "change_gap_max": change[worst_change],
    }
    look = {"loss_gaps": loss, "worst_grad_leaf": [worst_grad, grad[worst_grad]],
            "worst_change_leaf": [worst_change, change[worst_change]], "left_out": sorted(set(gnorm) - moved)}
    return numbers, look


def reader_numbers(prog_batches, ref_batches) -> dict:
    pix = geo = 0.0
    for p, r in zip(prog_batches, ref_batches):
        for k in ("images", "rgb_gt"):
            pix = max(pix, float(np.abs(p[k].astype(np.float64) - r[k]).max()))
        for k in ("rays", "poses", "focal", "c"):
            geo = max(geo, float(np.abs(np.asarray(p[k], np.float64) - r[k]).max()))
    return {"reader_pixels": pix, "reader_geometry": geo}


def check(cell, seed, device, wts, root, prog, control: str = None) -> tuple:
    """The compared numbers and the look at them. With ``control``, the
    reference computed at that precision stands in for the program's steps."""
    batches = reference_batches(cell, seed, root)
    with exact_float32():
        ref = reference_steps(cell, seed, device, wts, batches, Precision())
        if control:
            losses, grads, after = reference_steps(cell, seed, device, wts, batches, Precision(control))
            prog = dict(prog, losses=losses, grads=grads, after=after)
    out = reader_numbers(prog["batches"], batches)
    numbers, look = numbers_of(prog, ref, wts)
    out.update(numbers)
    return out, look

"""Training harness (counterpart of ``pixelnerf_tpu/train/trainer.py``).

The epoch/batch loop with interval-driven side effects (print, eval, save,
vis), Adam with an optional staircase exponential LR decay per epoch,
gradient accumulation, crash-tolerant checkpoints, TensorBoard scalars
where available, resume, and the sample-count schedule. Hooks:
``post_batch``, ``extra_save_state``; ``vis_fn(generator, epoch,
batch_idx) -> (image or None, metrics)`` renders the visual that is
written as ``<visual_dir>/<epoch>_<batch>_vis.png``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import ConfigNode
from ..parallel.mesh import is_main_process, shard_batch
from ..render.renderer import RenderConfig
from ..utils import png
from .loss import make_render_loss
from .state import load_checkpoint, save_checkpoint
from .step import make_eval_step, make_train_step


class Trainer:
    def __init__(
        self,
        net,
        train_pipeline: Iterable,
        test_pipeline: Optional[Iterable],
        render_cfg: RenderConfig,
        conf,                       # 'train' + 'loss' config root
        name: str = "exp",
        out_dir: str = "results",
        lr: float = 1e-4,
        gamma: float = 1.0,
        num_epochs: int = 10000000,
        epoch_batches: int = 1000,
        train_encoder: bool = True,
        resume: bool = False,
        vis_fn: Optional[Callable] = None,
        render_schedule=None,
        train_ray_chunk=None,
        train_remat=True,
        seed: int = 0,
        ckpt_dir: Optional[str] = None,
        visual_dir: Optional[str] = None,
        log_dir: Optional[str] = None,
        debug_nans: bool = False,
        mesh=None,
    ):
        self.net = net
        # a mesh of ranks (parallel.make_mesh): each step takes this rank's
        # slice of the batch; rank 0 alone prints and writes files
        self.mesh = mesh
        self.is_main = is_main_process()
        self.device = next(net.parameters()).device
        self.render_cfg = render_cfg
        self.name = name
        self.num_epochs = num_epochs
        self.epoch_batches = epoch_batches
        self.vis_fn = vis_fn

        tconf = conf.get_config("train", None) or ConfigNode()
        get = tconf.get_int
        self.print_interval = get("print_interval", 2)
        self.save_interval = get("save_interval", 50)
        self.vis_interval = get("vis_interval", 100)
        self.eval_interval = get("eval_interval", 50)
        self.accu_grad = get("accu_grad", 1)
        self.num_epoch_repeats = get("num_epoch_repeats", 1)

        self.ckpt_dir = ckpt_dir or os.path.join(out_dir, "checkpoints", name)
        self.visual_dir = visual_dir or os.path.join(out_dir, "visuals", name)
        self._log_dir = log_dir or os.path.join(out_dir, "logs", name)
        if self.is_main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            os.makedirs(self.visual_dir, exist_ok=True)

        # per-epoch ExponentialLR as a staircase: an epoch is
        # epoch_batches * num_epoch_repeats optimizer updates
        self.lr = lr
        self.gamma = gamma
        self.optimizer = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

        self.step = 0
        if resume:
            restored = load_checkpoint(self.ckpt_dir, net, self.optimizer)
            if restored is not None:
                self.step = restored
                # keep the sampling curriculum (no_bbox_step) aligned with
                # the restored step
                if hasattr(train_pipeline, "step"):
                    train_pipeline.step = restored
                print(f"Resumed from step {self.step}")

        loss_conf = conf.get_config("loss", None) or ConfigNode()
        self.loss_fn = make_render_loss(loss_conf)
        self.render_schedule = render_schedule
        self.train_encoder = train_encoder
        self.train_ray_chunk = train_ray_chunk
        self.train_remat = train_remat
        self.debug_nans = debug_nans
        self._step_cache = {}
        self.train_step, self.eval_step = self._steps_for(render_cfg)

        self.train_pipeline = train_pipeline
        self.test_pipeline = test_pipeline
        # step draws from (seed, counter) streams; counter 0 is the eval stream
        self._base_seed = int(seed) & 0x7FFFFFFF
        self._seed_counter = 0
        self._eval_gen = self._generator(0)
        self._vis_gen = self._generator(0xFFFFFFFF)   # a counter the steps never reach

        self.writer = None
        if self.is_main and os.environ.get("PIXELNERF_NO_TB") != "1":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(self._log_dir)
            except Exception:
                pass

    def _steps_for(self, cfg: RenderConfig):
        """(train_step, eval_step) for a render config, cached: the
        sample-count schedule switches between a few configs. The gradient
        accumulation's state lives on the optimizer, so it carries over a
        switch and, through the checkpoint, a resume."""
        if cfg not in self._step_cache:
            self._step_cache[cfg] = (
                make_train_step(
                    self.net, cfg, self.optimizer, self.loss_fn,
                    train_encoder=self.train_encoder, ray_chunk=self.train_ray_chunk,
                    remat=self.train_remat, accu_grad=self.accu_grad, debug_nans=self.debug_nans, mesh=self.mesh,
                ),
                make_eval_step(self.net, cfg, self.loss_fn, mesh=self.mesh),
            )
        return self._step_cache[cfg]

    def lr_at(self, step: int) -> float:
        """The learning rate of the optimizer update made at ``step``."""
        if self.gamma == 1.0:
            return self.lr
        n_updates = step // self.accu_grad
        return self.lr * self.gamma ** (n_updates // (self.epoch_batches * self.num_epoch_repeats))

    def _generator(self, counter: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed((self._base_seed << 32) | counter)

    def _next_generator(self) -> torch.Generator:
        self._seed_counter += 1
        return self._generator(self._seed_counter)

    def _to_device(self, batch) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items() if k != "step"}

    # -- hooks ---------------------------------------------------------------

    def post_batch(self, epoch: int, batch_idx: int) -> None:
        pass

    def extra_save_state(self) -> None:
        pass

    # -- loop ----------------------------------------------------------------

    def _log(self, tag, scalars, step):
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(f"{tag}/{k}", float(v), step)

    def _print_pending(self):
        p_epoch, p_bidx, p_step, p_metrics, p_dt = self._pending
        self._pending = None
        if not self.is_main:
            return
        p_metrics = {k: float(v) for k, v in p_metrics.items()}
        print(
            f"E{p_epoch} B{p_bidx} "
            + " ".join(f"{k}:{v:.5f}" for k, v in p_metrics.items())
            + f" ({p_dt:.2f}s)"
        )
        self._log("train", p_metrics, p_step)

    def start(self):
        train_iter = iter(self.train_pipeline)
        test_iter = iter(self.test_pipeline) if self.test_pipeline else None
        # deferred (epoch, batch_idx, step, metrics, dt): printing the
        # previous interval's metrics reads values the device has finished,
        # so float() does not wait on the step just launched
        self._pending = None
        try:
            self._run_epochs(train_iter, test_iter)
        finally:
            # the pipelines' prefetch threads stop before their next pull
            train_iter.close()
            if test_iter is not None:
                test_iter.close()
            # the run's last interval (a short run's only one)
            if self._pending is not None:
                self._print_pending()

    def _run_epochs(self, train_iter, test_iter):
        t_last = time.time()
        for epoch in range(self.num_epochs):
            for batch_idx in range(self.epoch_batches * self.num_epoch_repeats):
                batch = next(train_iter)
                if self.mesh is not None:
                    batch = shard_batch(self.mesh, {k: v for k, v in batch.items() if k != "step"})
                batch = self._to_device(batch)
                if self.render_schedule is not None:
                    cfg = self.render_schedule.at_step(self.step)
                    if cfg not in self._step_cache:
                        print(
                            "INFO: sampling resolution changed on schedule "
                            f"==> c {cfg.n_coarse} f {cfg.n_fine}"
                        )
                    self.train_step, self.eval_step = self._steps_for(cfg)
                for group in self.optimizer.param_groups:
                    group["lr"] = self.lr_at(self.step)
                metrics = self.train_step(batch, generator=self._next_generator())
                self.step += 1

                if batch_idx % self.print_interval == 0:
                    dt = time.time() - t_last
                    t_last = time.time()
                    if self._pending is not None:
                        self._print_pending()
                    self._pending = (epoch, batch_idx, self.step, metrics, dt)

                if test_iter is not None and batch_idx % self.eval_interval == 1:
                    test_batch = self._to_device(next(test_iter))
                    test_metrics = self.eval_step(test_batch, generator=self._eval_gen)
                    test_metrics = {k: float(v) for k, v in test_metrics.items()}
                    if self.is_main:
                        print("*** eval: " + " ".join(f"{k}:{v:.5f}" for k, v in test_metrics.items()))
                        self._log("test", test_metrics, self.step)

                if batch_idx % self.save_interval == 1 and (epoch > 0 or batch_idx > 0) and self.is_main:
                    save_checkpoint(self.ckpt_dir, self.net, self.optimizer, self.step)
                    self.extra_save_state()

                if self.vis_fn is not None and batch_idx % self.vis_interval == 1:
                    vis, vis_metrics = self.vis_fn(self._vis_gen, epoch, batch_idx)
                    if vis is not None and self.is_main:
                        self._save_visual(vis, epoch, batch_idx)
                    if vis_metrics:
                        self._log("vis", vis_metrics, self.step)

                self.post_batch(epoch, batch_idx)
            if self.is_main:
                save_checkpoint(self.ckpt_dir, self.net, self.optimizer, self.step)

    def _save_visual(self, vis: np.ndarray, epoch: int, batch_idx: int):
        path = os.path.join(self.visual_dir, f"{epoch:04d}_{batch_idx:04d}_vis.png")
        png.imwrite(path, (np.clip(vis, 0, 1) * 255).astype(np.uint8))

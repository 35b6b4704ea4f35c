"""Hierarchical volume renderer, coarse + fine (counterpart of
``pixelnerf_tpu/render/renderer.py``).

Semantics kept exactly:

- stratified coarse samples with jittered left-edge bins
- inverse-CDF importance samples from the detached coarse weights, with
  the comparison-count searchsorted
- gaussian depth-jitter samples clamped to [near, far]
- ``alpha = 1 - exp(-delta * relu(sigma))``, transmittance by the cumprod
  of shifted ``(1 - alpha + 1e-10)``, ``delta_inf = far - z_K``, optional
  white background
- ``render_rays`` takes the field as one ``query_fn(points, viewdirs,
  coarse)`` (unstaged: the fine pass queries the sorted union of coarse
  and new samples) or as a staged pair ``(features_fn, mlp_fn)``
- the staged fine pass: the fine MLP runs on the cached coarse features and
  on the new samples' features, and the two outputs are merged by one
  stable sort of z with the 4 output channels as payload

Random draws come from an explicit ``torch.Generator``, or are injected as
a dict (``jax.random`` and ``torch.Generator`` cannot agree, so parity
tests hand both sides the same numbers):

- ``"coarse"`` (SB, B, n_coarse) uniform jitter of the coarse bins
- ``"fine_u"`` (SB, B, n_imp) uniform CDF positions of the importance samples
- ``"fine_jitter"`` (SB, B, n_imp) uniform jitter of the importance samples
- ``"depth"`` (SB, B, n_fine_depth) standard normals of the depth samples
- ``"noise_c"`` (SB, B, n_coarse) and ``"noise_f"`` (SB, B, n_coarse +
  n_fine) standard normals of the sigma noise, drawn only for training with
  ``noise_std > 0``

where ``n_imp = n_fine - n_fine_depth``.

Training differentiates through all of it: the expected depth feeding the
depth-jittered samples is not detached (the reference does not detach it),
so the fine pass's gradients reach the coarse pass through the sample
positions; only the importance weights are detached.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 128
    n_fine: int = 0
    n_fine_depth: int = 0
    noise_std: float = 0.0
    depth_std: float = 0.01
    white_bkgd: bool = False
    # samples linear in disparity (1/z) between near and far, not in depth
    lindisp: bool = False

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0

    @classmethod
    def from_conf(cls, conf, white_bkgd: bool = False, lindisp: bool = False) -> "RenderConfig":
        return cls(
            n_coarse=conf.get_int("n_coarse", 128),
            n_fine=conf.get_int("n_fine", 0),
            n_fine_depth=conf.get_int("n_fine_depth", 0),
            noise_std=conf.get_float("noise_std", 0.0),
            depth_std=conf.get_float("depth_std", 0.01),
            white_bkgd=bool(conf.get_float("white_bkgd", white_bkgd)),
            lindisp=lindisp,
        )


class RenderSchedule:
    """Sample-count schedule (counterpart of ``RenderSchedule`` in
    ``pixelnerf_tpu/render/renderer.py``).

    ``sched = [iters, n_coarse, n_fine]``: once the training iteration
    crosses ``iters[k]``, sampling switches to ``(n_coarse[k], n_fine[k])``.
    """

    def __init__(self, base: RenderConfig, sched):
        self.base = base
        self.sched = sched if sched else None

    def at_step(self, iter_idx: int) -> RenderConfig:
        if not self.sched:
            return self.base
        iters, n_coarse, n_fine = self.sched
        cfg = self.base
        for k in range(len(iters)):
            if iter_idx >= iters[k]:
                cfg = dataclasses.replace(self.base, n_coarse=int(n_coarse[k]), n_fine=int(n_fine[k]))
        return cfg

    @classmethod
    def from_conf(cls, conf, base: RenderConfig) -> "RenderSchedule":
        return cls(base, conf.get_list("sched", None))


def draw_noise(
    rays: torch.Tensor, cfg: RenderConfig, generator: torch.Generator, train: bool = False
) -> Dict[str, torch.Tensor]:
    """Draw every random number one ``render_rays`` call needs (the sigma
    noise only for ``train``)."""
    lead = rays.shape[:-1]
    kw = dict(generator=generator, device=rays.device, dtype=rays.dtype)
    n_imp = cfg.n_fine - cfg.n_fine_depth
    noise = {"coarse": torch.rand(lead + (cfg.n_coarse,), **kw)}
    if cfg.using_fine and n_imp > 0:
        noise["fine_u"] = torch.rand(lead + (n_imp,), **kw)
        noise["fine_jitter"] = torch.rand(lead + (n_imp,), **kw)
    if cfg.using_fine and cfg.n_fine_depth > 0:
        noise["depth"] = torch.randn(lead + (cfg.n_fine_depth,), **kw)
    if train and cfg.noise_std > 0.0:
        noise["noise_c"] = torch.randn(lead + (cfg.n_coarse,), **kw)
        if cfg.using_fine:
            noise["noise_f"] = torch.randn(lead + (cfg.n_coarse + cfg.n_fine,), **kw)
    return noise


def _z_from_steps(rays: torch.Tensor, z_steps: torch.Tensor, lindisp: bool) -> torch.Tensor:
    near, far = rays[..., 6:7], rays[..., 7:8]
    if not lindisp:
        return near * (1 - z_steps) + far * z_steps
    return 1.0 / (1.0 / near * (1 - z_steps) + 1.0 / far * z_steps)


def sample_coarse(rays: torch.Tensor, cfg: RenderConfig, u: torch.Tensor) -> torch.Tensor:
    """Stratified samples: (..., B, 8) rays -> (..., B, Kc) depths."""
    step = 1.0 / cfg.n_coarse
    z_steps = torch.linspace(0.0, 1.0 - step, cfg.n_coarse, device=rays.device, dtype=rays.dtype)
    return _z_from_steps(rays, z_steps + u * step, cfg.lindisp)


def sample_fine(
    rays: torch.Tensor, weights: torch.Tensor, cfg: RenderConfig,
    u: torch.Tensor, jitter: torch.Tensor,
) -> torch.Tensor:
    """Importance samples from coarse weights: -> (..., B, n_fine - n_fine_depth)."""
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)        # (..., Kc+1)
    # searchsorted(cdf, u, right) == count of cdf entries <= u; branchless
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).to(rays.dtype), dim=-1) - 1.0
    inds = torch.clamp(inds, min=0.0)
    z_steps = (inds + jitter) / cfg.n_coarse
    return _z_from_steps(rays, z_steps, cfg.lindisp)


def sample_fine_depth(
    rays: torch.Tensor, depth: torch.Tensor, cfg: RenderConfig, normal: torch.Tensor
) -> torch.Tensor:
    """Gaussian jitter around the expected depth: -> (..., B, n_fine_depth)."""
    z = depth[..., None] + normal * cfg.depth_std
    return torch.minimum(torch.maximum(z, rays[..., 6:7]), rays[..., 7:8])


QueryFn = Union[Callable, Sequence[Callable]]


def _points_of(rays: torch.Tensor, z_samp: torch.Tensor, use_viewdirs: bool):
    """World points (SB, B*K, 3) of the samples ``z_samp`` (SB, B, K) along
    ``rays``, and their view directions (or None)."""
    SB, B, K = z_samp.shape
    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    points = points.reshape(SB, B * K, 3)
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays[..., None, 3:6].expand(SB, B, K, 3).reshape(SB, B * K, 3)
    return points, viewdirs


def composite(
    query_fn: Callable, rays: torch.Tensor, z_samp: torch.Tensor, coarse: bool, cfg: RenderConfig,
    sigma_noise: Optional[torch.Tensor] = None, use_viewdirs: bool = True,
) -> Dict[str, torch.Tensor]:
    """Alpha-composite field queries along rays.

    :param query_fn: ``f(points (SB, P, 3), viewdirs, coarse) -> (SB, P, 4)``
    :param rays: (SB, B, 8)
    :param z_samp: (SB, B, K), sorted
    :return: dict(weights (SB, B, K), rgb (SB, B, 3), depth (SB, B))
    """
    SB, B, K = z_samp.shape
    points, viewdirs = _points_of(rays, z_samp, use_viewdirs)
    out = query_fn(points, viewdirs, coarse)
    return composite_outputs(out.reshape(SB, B, K, -1), rays, z_samp, cfg, sigma_noise)


def composite_outputs(
    out: torch.Tensor, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig,
    sigma_noise: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Compositing on field outputs (SB, B, K, 4) aligned with sorted z.

    :param sigma_noise: (SB, B, K) standard normals, scaled by
        ``cfg.noise_std`` and added to sigma (training), or None
    """
    deltas = z_samp[..., 1:] - z_samp[..., :-1]
    delta_inf = rays[..., 7:8] - z_samp[..., -1:]
    deltas = torch.cat([deltas, delta_inf], dim=-1)                    # (SB, B, K)
    rgbs = out[..., :3]
    sigmas = out[..., 3]
    if sigma_noise is not None:
        sigmas = sigmas + sigma_noise * cfg.noise_std
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))
    alphas_shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), 1.0 - alphas + 1e-10], dim=-1
    )
    T = torch.cumprod(alphas_shifted, dim=-1)                           # (SB, B, K+1)
    weights = alphas * T[..., :-1]
    rgb_final = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth_final = torch.sum(weights * z_samp, dim=-1)
    if cfg.white_bkgd:
        pix_alpha = torch.sum(weights, dim=-1)
        rgb_final = rgb_final + (1.0 - pix_alpha[..., None])
    return {"weights": weights, "rgb": rgb_final, "depth": depth_final}


def _stage_features(features_fn, rays, z_samp, use_viewdirs):
    """The feature stage on the sample positions of ``z_samp``."""
    return features_fn(*_points_of(rays, z_samp, use_viewdirs))


def _format(out: Dict[str, torch.Tensor], want_weights: bool) -> Dict[str, torch.Tensor]:
    ret = {"rgb": out["rgb"], "depth": out["depth"]}
    if want_weights:
        ret["weights"] = out["weights"]
    return ret


def render_rays(
    query_fn: QueryFn,
    rays: torch.Tensor,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
    train: bool = False,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Hierarchical render of a ray batch.

    :param query_fn: either ``f(points (SB, P, 3), viewdirs, coarse) ->
        (SB, P, 4)`` or a staged pair ``(features_fn, mlp_fn)`` with
        ``features_fn(points, viewdirs) -> feats`` and ``mlp_fn(feats,
        coarse) -> (SB, P, 4)``. Staged, the fine pass reuses the coarse
        samples' features (the sorted fine union contains every coarse z),
        so only the new samples go through ``features_fn``, and the field
        outputs are permuted by the sort of z instead of the features. The
        two forms compute the same per-sample values in other batches: they
        agree to the matrix products' float32 rounding, not bit for bit
    :param rays: (SB, B, 8) [origin, dir, near, far]
    :param noise: pre-drawn random numbers (see the module docstring);
        drawn from ``generator`` if None
    :param train: add the sigma noise (``cfg.noise_std > 0``)
    :return: {'coarse': {rgb, depth[, weights]}[, 'fine': {...}]}
    """
    if rays.dim() != 3 or rays.shape[-1] != 8:
        raise ValueError(f"rays must be (SB, B, 8), got {tuple(rays.shape)}")
    if noise is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or pre-drawn noise")
        noise = draw_noise(rays, cfg, generator, train)
    SB, B, _ = rays.shape
    sigma_noise = train and cfg.noise_std > 0.0

    staged = isinstance(query_fn, (tuple, list))
    noise_c = noise["noise_c"] if sigma_noise else None
    noise_f = noise["noise_f"] if sigma_noise and cfg.using_fine else None

    z_coarse = sample_coarse(rays, cfg, noise["coarse"])               # (SB, B, Kc)
    if staged:
        features_fn, mlp_fn = query_fn
        feats_c = _stage_features(features_fn, rays, z_coarse, use_viewdirs)
        out_c = mlp_fn(feats_c, True).reshape(SB, B, cfg.n_coarse, 4)
        coarse_out = composite_outputs(out_c, rays, z_coarse, cfg, noise_c)
    else:
        coarse_out = composite(query_fn, rays, z_coarse, True, cfg, noise_c, use_viewdirs)
    outputs = {"coarse": _format(coarse_out, want_weights)}

    if cfg.using_fine:
        new_samps = []
        if cfg.n_fine - cfg.n_fine_depth > 0:
            new_samps.append(
                sample_fine(rays, coarse_out["weights"], cfg, noise["fine_u"], noise["fine_jitter"])
            )
        if cfg.n_fine_depth > 0:
            new_samps.append(sample_fine_depth(rays, coarse_out["depth"], cfg, noise["depth"]))
        if not staged:
            z_combine, _ = torch.sort(torch.cat([z_coarse] + new_samps, dim=-1), dim=-1)
            fine_out = composite(query_fn, rays, z_combine, False, cfg, noise_f, use_viewdirs)
        else:
            out_fc = mlp_fn(feats_c, False).reshape(SB, B, cfg.n_coarse, 4)
            del feats_c   # both MLP calls have taken it; autograd keeps what it saved
            if new_samps:
                z_new = torch.cat(new_samps, dim=-1)                    # (SB, B, Kn)
                feats_n = _stage_features(features_fn, rays, z_new, use_viewdirs)
                out_fn = mlp_fn(feats_n, False).reshape(SB, B, z_new.shape[-1], 4)
                out_f = torch.cat([out_fc, out_fn], dim=2)
                z_all = torch.cat([z_coarse, z_new], dim=-1)
            else:
                out_f, z_all = out_fc, z_coarse
            # one stable sort keyed on z; the 4 output channels ride as payload
            z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
            out_sorted = torch.gather(out_f, 2, order[..., None].expand(-1, -1, -1, 4))
            fine_out = composite_outputs(out_sorted, rays, z_sorted, cfg, noise_f)
        outputs["fine"] = _format(fine_out, want_weights)
    return outputs


# the products remat="dots" keeps: matrix products without batch dims
# (F.linear and torch.matmul of an (..., K) input by a (K, N) weight reach
# them through a view)
_SAVED_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]
_save_dots = functools.partial(create_selective_checkpoint_contexts, _SAVED_DOTS)


def render_rays_chunked(
    query_fn: QueryFn,
    rays: torch.Tensor,
    cfg: RenderConfig,
    ray_chunk: int,
    generator: Optional[torch.Generator] = None,
    noise_chunks=None,
    want_weights: bool = False,
    use_viewdirs: bool = True,
    train: bool = False,
    remat: Union[bool, str] = False,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Memory-bounded render: a Python loop over ray chunks of (SB, B, 8),
    concatenated along B. ``noise_chunks`` is a list with one noise dict per
    chunk, or None to draw each chunk's from ``generator`` before its render.

    ``remat`` sets what the backward recomputes (``torch.utils.checkpoint``,
    non-reentrant; the noise is drawn before the checkpointed call, so the
    recompute sees the same numbers):

    - ``False``: nothing; every chunk's activations are kept
    - ``True``: the whole chunk render
    - ``"features"``: only the two MLP calls; the feature stage (projection,
      gather, positional code) runs outside the checkpoint and keeps its
      outputs, the torch form of the JAX package's
      ``save_only_these_names("gathered_features")``; it needs the staged
      pair, which alone has a feature stage of its own
    - ``"dots"``: the whole chunk render, but the outputs of its unbatched
      matrix products (``aten.mm``, ``aten.addmm``: the MLPs' layers) are
      kept, the torch form of the JAX package's
      ``dots_with_no_batch_dims_saveable``; the gathers (kernel C) and the
      elementwise work run again
    """
    if remat not in (False, True, "features", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    if remat == "features":
        if not isinstance(query_fn, (tuple, list)):
            raise ValueError('remat="features" needs the staged (features_fn, mlp_fn) pair')
        features_fn, inner_mlp = query_fn

        def mlp_fn(feats, coarse):
            return checkpoint(inner_mlp, feats, coarse, use_reentrant=False)

        query_fn = (features_fn, mlp_fn)

    SB, B, _ = rays.shape
    outs = []
    for i, start in enumerate(range(0, B, ray_chunk)):
        chunk = rays[:, start : start + ray_chunk]
        if noise_chunks is not None:
            noise = noise_chunks[i]
        elif generator is not None:
            noise = draw_noise(chunk, cfg, generator, train)
        else:
            raise ValueError("pass a torch.Generator or pre-drawn noise")
        args = (query_fn, chunk, cfg, None, noise, want_weights, use_viewdirs, train)
        if remat is True:
            outs.append(checkpoint(render_rays, *args, use_reentrant=False))
        elif remat == "dots":
            outs.append(checkpoint(render_rays, *args, use_reentrant=False, context_fn=_save_dots))
        else:
            outs.append(render_rays(*args))
    return {
        branch: {k: torch.cat([o[branch][k] for o in outs], dim=1) for k in outs[0][branch]}
        for branch in outs[0]
    }


class NeRFRenderer:
    """Object API around the functional renderer (counterpart of
    ``NeRFRenderer`` in ``pixelnerf_tpu/render/renderer.py``: ``from_conf``,
    ``__call__``, ``bind``)."""

    def __init__(self, cfg: RenderConfig):
        self.cfg = cfg

    @classmethod
    def from_conf(cls, conf, white_bkgd: bool = False, lindisp: bool = False) -> "NeRFRenderer":
        return cls(RenderConfig.from_conf(conf, white_bkgd, lindisp))

    def __call__(
        self, query_fn: QueryFn, rays: torch.Tensor, generator=None, noise=None, train: bool = False,
        want_weights: bool = False, use_viewdirs: bool = True, ray_chunk: Optional[int] = None,
    ):
        """Render (SB, B, 8) rays, in chunks of ``ray_chunk`` rays when B
        exceeds it. ``noise`` is one pre-drawn dict, or with chunks a list
        of one dict per chunk."""
        if ray_chunk is None or rays.shape[1] <= ray_chunk:
            if isinstance(noise, (list, tuple)):
                noise = noise[0]
            return render_rays(
                query_fn, rays, self.cfg, generator, noise, want_weights, use_viewdirs, train
            )
        return render_rays_chunked(
            query_fn, rays, self.cfg, ray_chunk, generator, noise, want_weights, use_viewdirs, train
        )

    def bind(self, net, enc, simple_output: bool = False):
        """Bind a PixelNeRF net and a SceneEncoding into a rays -> render
        callable on ``net.query`` (unstaged).

        :param simple_output: return ``(rgb, depth)`` of the fine branch
            (the coarse one without fine samples) instead of the dict
        """

        def query_fn(xyz, viewdirs, coarse):
            return net.query(enc, xyz, viewdirs, coarse=coarse)

        def render(rays, generator=None, noise=None, train=False, want_weights=False, ray_chunk=None):
            out = self(
                query_fn, rays, generator, noise, train=train, want_weights=want_weights,
                use_viewdirs=net.use_viewdirs, ray_chunk=ray_chunk,
            )
            if simple_output:
                branch = out["fine"] if self.cfg.using_fine else out["coarse"]
                return branch["rgb"], branch["depth"]
            return out

        return render

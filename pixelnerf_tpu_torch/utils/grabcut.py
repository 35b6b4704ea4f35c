"""GrabCut, the port's own version of OpenCV's ``cv2.grabCut``.

OpenCV's algorithm (``imgproc/src/grabcut.cpp``), step for step:

- two Gaussian mixtures of 5 full-covariance components in BGR, one for
  the background (``BGD``, ``PR_BGD`` pixels), one for the foreground
  (``FGD``, ``PR_FGD``), packed as OpenCV's (1, 65) float64 models
  (weights 5, means 15, covariances 45), so that models pass between this
  module and ``cv2.grabCut``;
- ``INIT_WITH_RECT`` (the rect, clipped, ``PR_FGD``, the rest ``BGD``) or
  ``INIT_WITH_MASK`` fit each mixture to k-means labels (k-means++ centres
  with 3 candidates a step, 10 Lloyd iterations, K = min(5, samples));
- edge weights once per call: ``beta = 1 / (2 mean |dz|^2)`` over the
  left, up-left, up and up-right pairs, ``50 exp(-beta |dz|^2)`` for the
  straight neighbours and ``50 / sqrt(2)`` times that for the diagonals;
- each iteration: every pixel takes the component of its own mixture with
  the largest unweighted density; the mixtures are learnt again from those
  labels (not under ``EVAL_FREEZE_MODEL``); the graph's terminal links
  are ``-log`` of each mixture's density for ``PR_*`` pixels and 0 / 450
  for hard ones; a minimum cut relabels the ``PR_*`` pixels.

The per-pixel work (k-means, the densities, the component labels, the
mixtures' sums, the edge weights) runs in torch float64 on ``device``. Its
sums are of integer colours, exact in float64, so the learnt mixtures do
not depend on the device or on the order of the sums. The cut runs on the
host with ``scipy.sparse.csgraph.maximum_flow`` (Dinic), which takes
integer capacities:

- the hard pixels are merged into their terminals (their 450 links are
  never cut: a pixel's eight neighbour links sum to at most 342), so a
  ``PR_*`` pixel's links to hard neighbours become terminal links, and a
  density of 0 (an infinite link in OpenCV) makes its pixel hard too;
- each pixel's two terminal links are reduced by their minimum, as
  OpenCV's graph stores them, and all capacities are scaled to int32 by a
  factor chosen so that the sum of the source links (a bound of the flow)
  stays below 2**31;
- the source side is what the source reaches in the residual graph.

Ties between cuts of equal cost may fall otherwise than in OpenCV's
Boykov-Kolmogorov solver, and k-means draws from a numpy generator, not
OpenCV's RNG: the tests hold the learnt mixtures and a cut with frozen
mixtures to ``cv2`` and the whole segmentation to the JAX app's by IoU.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import breadth_first_order, maximum_flow

BGD, FGD, PR_BGD, PR_FGD = 0, 1, 2, 3
INIT_WITH_RECT, INIT_WITH_MASK, EVAL, EVAL_FREEZE_MODEL = 0, 1, 2, 3
K = 5
GAMMA = 50.0
LAMBDA = 9 * GAMMA
_F64 = torch.float64


class GrabCutError(ValueError):
    """A mask that leaves one of the two mixtures without a sample (where
    ``cv2.grabCut`` fails its assertion in ``initGMMs``)."""


# ---------------------------------------------------------------------------
# the mixtures


class GMM:
    """One mixture as OpenCV's ``GMM`` keeps it, on a device."""

    def __init__(self, model: torch.Tensor):
        self.model = model                      # (65,) float64
        self.coefs = model[:K]
        self.mean = model[K : 4 * K].view(K, 3)
        self.cov = model[4 * K :].view(K, 9)
        self.inv = torch.zeros(K, 9, dtype=_F64, device=model.device)
        self.det = torch.ones(K, dtype=_F64, device=model.device)
        self._invert(torch.ones(K, dtype=torch.bool, device=model.device), 0.0)

    def _invert(self, which: torch.Tensor, singular_fix: float):
        """``calcInverseCovAndDeterm`` for the components in ``which`` whose
        weight is above 0, in OpenCV's order of operations."""
        which = which & (self.coefs > 0)
        c = [self.cov[:, i] for i in range(9)]

        def det(c):
            return (c[0] * (c[4] * c[8] - c[5] * c[7]) - c[1] * (c[3] * c[8] - c[5] * c[6])
                    + c[2] * (c[3] * c[7] - c[4] * c[6]))

        d = det(c)
        if singular_fix > 0:
            fix = which & (d <= 1e-6)
            if bool(fix.any()):
                for i in (0, 4, 8):
                    self.cov[:, i] = torch.where(fix, self.cov[:, i] + singular_fix, self.cov[:, i])
                c = [self.cov[:, i] for i in range(9)]
                d = torch.where(fix, det(c), d)
        if bool((which & (d <= np.finfo(np.float64).eps)).any()):
            raise GrabCutError("a mixture component has a singular covariance")
        inv_d = 1.0 / torch.where(which, d, torch.ones_like(d))
        inv = torch.stack([
            (c[4] * c[8] - c[5] * c[7]) * inv_d, -(c[1] * c[8] - c[2] * c[7]) * inv_d,
            (c[1] * c[5] - c[2] * c[4]) * inv_d, -(c[3] * c[8] - c[5] * c[6]) * inv_d,
            (c[0] * c[8] - c[2] * c[6]) * inv_d, -(c[0] * c[5] - c[2] * c[3]) * inv_d,
            (c[3] * c[7] - c[4] * c[6]) * inv_d, -(c[0] * c[7] - c[1] * c[6]) * inv_d,
            (c[0] * c[4] - c[1] * c[3]) * inv_d,
        ], 1)                                   # inv[:, 3 * a + b] = inverseCovs[a][b]
        self.inv = torch.where(which[:, None], inv, self.inv)
        self.det = torch.where(which, d, self.det)

    def component_density(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3) colours -> (N, K): each component's ``det^-1/2 exp(-d'S^-1 d / 2)``,
        0 for a component of weight 0."""
        d = x[:, None, :] - self.mean[None]     # (N, K, 3)
        d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
        i = self.inv
        mult = (d0 * (d0 * i[:, 0] + d1 * i[:, 3] + d2 * i[:, 6])
                + d1 * (d0 * i[:, 1] + d1 * i[:, 4] + d2 * i[:, 7])
                + d2 * (d0 * i[:, 2] + d1 * i[:, 5] + d2 * i[:, 8]))
        p = (1.0 / torch.sqrt(self.det)) * torch.exp(-0.5 * mult)
        return torch.where(self.coefs > 0, p, torch.zeros_like(p))

    def density(self, p: torch.Tensor) -> torch.Tensor:
        """The mixture's density from ``component_density``: the weighted
        terms added one component after another, as OpenCV adds them."""
        res = torch.zeros(p.shape[0], dtype=_F64, device=p.device)
        for k in range(K):
            res = res + self.coefs[k] * p[:, k]
        return res

    def learn(self, x: torch.Tensor, labels: torch.Tensor):
        """``initLearning``, ``addSample`` for every (colour, label) and
        ``endLearning``: weights n / N, means, covariances ``E[xx'] - mm'``
        with 0.01 added to the diagonal of a near-singular one; a component
        without samples gets weight 0 and keeps its mean and covariance."""
        onehot = torch.nn.functional.one_hot(labels, K).to(_F64)          # (N, K)
        n = onehot.sum(0)
        sums = onehot.T @ x                                                 # exact: integer colours
        prods = onehot.T @ (x[:, :, None] * x[:, None, :]).reshape(-1, 9)
        has = n > 0
        total = n.sum()
        self.coefs.copy_(torch.where(has, n / total, torch.zeros_like(n)))
        inv_n = 1.0 / torch.where(has, n, torch.ones_like(n))
        m = sums * inv_n[:, None]
        mm = torch.stack([m[:, a] * m[:, b] for a in range(3) for b in range(3)], 1)
        cov = prods * inv_n[:, None] - mm
        self.mean.copy_(torch.where(has[:, None], m, self.mean))
        self.cov.copy_(torch.where(has[:, None], cov, self.cov))
        self._invert(has, 0.01)


def _kmeans(x: torch.Tensor, k: int, rng: np.random.Generator, iters: int = 10, trials: int = 3) -> torch.Tensor:
    """Labels of k-means (k-means++ centres with ``trials`` candidates a
    step, then Lloyd's iterations as OpenCV runs them: ``iters`` passes in
    all, the last one without a new assignment, an empty cluster refilled
    by the farthest sample of the largest) on (N, 3) float64 colours."""
    n = x.shape[0]
    k = min(k, n)

    def sqdist(c):
        return ((x - c) ** 2).sum(1)

    first = int(rng.integers(n))
    dist = sqdist(x[first])
    idx = [first]
    sum0 = float(dist.sum())
    for _ in range(1, k):
        best, best_i, best_d = math.inf, -1, None
        cum = torch.cumsum(dist, 0)
        for _ in range(trials):
            p = rng.random() * sum0
            ci = min(int(torch.searchsorted(cum, torch.tensor([p], dtype=_F64, device=x.device))), n - 1)
            d2 = torch.minimum(dist, sqdist(x[ci]))
            s = float(d2.sum())
            if s < best:
                best, best_i, best_d = s, ci, d2
        idx.append(best_i)
        dist, sum0 = best_d, best
    centers = x[idx]
    labels = None
    for it in range(1, max(iters, 2) + 1):
        if it > 1:
            onehot = torch.nn.functional.one_hot(labels, k).to(_F64)
            count = onehot.sum(0)
            sums = onehot.T @ x
            for e in torch.nonzero(count == 0).flatten().tolist():   # OpenCV's refill
                big = int(torch.argmax(count))
                far = torch.where(labels == big, sqdist(sums[big] / count[big]), torch.full_like(dist, -1.0))
                far_i = int(n - 1 - torch.argmax(torch.flip(far, [0])))    # the last farthest, as OpenCV's <=
                labels[far_i] = e
                count[big] -= 1
                count[e] += 1
                sums[big] -= x[far_i]
                sums[e] += x[far_i]
            new = sums / count[:, None]
            shift = float(((new - centers) ** 2).sum(1).max())
            centers = new
            if it == max(iters, 2) or shift <= np.finfo(np.float32).eps ** 2:
                break
        labels = torch.argmin(((x[:, None, :] - centers[None]) ** 2).sum(2), 1)
    return labels


# ---------------------------------------------------------------------------
# the graph


def _edge_weights(img: torch.Tensor):
    """[(dy, dx, weights)...] for the left, up-left, up and up-right
    neighbours, as OpenCV's ``calcBeta`` and ``calcNWeights``."""
    h, w, _ = img.shape
    pairs = [(0, 1), (1, 1), (1, 0), (1, -1)]    # (dy, dx): the neighbour at (y - dy, x - dx)

    def sq(dy, dx):
        a = img[dy:, max(dx, 0) : w + min(dx, 0)]
        b = img[: h - dy, max(-dx, 0) : w - max(dx, 0)]
        return ((a - b) ** 2).sum(-1)

    diffs = [sq(dy, dx) for dy, dx in pairs]
    total = float(sum(d.sum() for d in diffs))
    beta = 0.0 if total <= np.finfo(np.float64).eps else 1.0 / (2 * total / (4 * w * h - 3 * w - 3 * h + 2))
    diag = GAMMA / float(np.sqrt(np.float32(2.0)))   # OpenCV takes sqrt(2.0f)
    return [(dy, dx, (GAMMA if dy == 0 or dx == 0 else diag) * torch.exp(-beta * d))
            for (dy, dx), d in zip(pairs, diffs)]


class _Graph:
    """The cut's fixed part for one call: the ``PR_*`` pixels, the links
    between them, and each one's links to hard neighbours."""

    def __init__(self, mask: np.ndarray, weights):
        h, w = mask.shape
        soft = mask >= PR_BGD
        self.pixels = np.flatnonzero(soft)
        node = np.full(h * w, -1, np.int64)
        node[self.pixels] = np.arange(self.pixels.size)
        to_fgd = np.zeros(self.pixels.size)
        to_bgd = np.zeros(self.pixels.size)
        us, vs, ws = [], [], []
        flat = mask.ravel()
        for dy, dx, wt in weights:
            wt = wt.cpu().numpy()
            ys, xs = np.mgrid[dy:h, max(dx, 0) : w + min(dx, 0)]
            p = (ys * w + xs).ravel()
            q = ((ys - dy) * w + xs - dx).ravel()
            wt = wt.ravel()
            for a, b in ((p, q), (q, p)):          # a soft pixel's link to a hard one
                sel = soft.ravel()[a] & ~soft.ravel()[b]
                np.add.at(to_fgd, node[a[sel]], np.where(flat[b[sel]] == FGD, wt[sel], 0.0))
                np.add.at(to_bgd, node[a[sel]], np.where(flat[b[sel]] == BGD, wt[sel], 0.0))
            sel = soft.ravel()[p] & soft.ravel()[q]
            us.append(node[p[sel]])
            vs.append(node[q[sel]])
            ws.append(wt[sel])
        self.u, self.v, self.w = np.concatenate(us), np.concatenate(vs), np.concatenate(ws)
        self.to_fgd, self.to_bgd = to_fgd, to_bgd

    def source_side(self, from_source: np.ndarray, to_sink: np.ndarray) -> np.ndarray:
        """The min cut for these terminal links (per ``PR_*`` pixel): True
        where the pixel is on the source (foreground) side."""
        n = self.pixels.size
        src_inf, snk_inf = np.isinf(from_source), np.isinf(to_sink)
        forced_s = src_inf
        forced_t = snk_inf & ~src_inf
        free = ~(forced_s | forced_t)
        src = np.where(free, from_source, 0.0) + self.to_fgd
        snk = np.where(free, to_sink, 0.0) + self.to_bgd
        # a link to a pixel made hard by an infinite link is a terminal link
        u, v, w = self.u, self.v, self.w
        for a, b in ((u, v), (v, u)):
            sel = free[a] & ~free[b]
            np.add.at(src, a[sel], np.where(forced_s[b[sel]], w[sel], 0.0))
            np.add.at(snk, a[sel], np.where(forced_t[b[sel]], w[sel], 0.0))
        low = np.minimum(src, snk)
        src, snk = src - low, snk - low
        keep = free[u] & free[v]
        u, v, w = u[keep], v[keep], w[keep]
        total = float(src[free].sum())
        scale = min((2**31 - 1 - n) / max(total, 1e-300), 2**30 / max(float(w.max(initial=0.0)), 1e-300))
        s, t = n, n + 1
        ids = np.flatnonzero(free)
        cs = np.rint(src[ids] * scale).astype(np.int64)
        ct = np.rint(snk[ids] * scale).astype(np.int64)
        cw = np.rint(w * scale).astype(np.int64)
        rows = np.concatenate([u, v, np.full(ids.size, s), ids])
        cols = np.concatenate([v, u, ids, np.full(ids.size, t)])
        caps = np.concatenate([cw, cw, cs, ct])
        nz = caps > 0
        graph = csr_matrix((caps[nz].astype(np.int32), (rows[nz], cols[nz])), shape=(n + 2, n + 2))
        flow = maximum_flow(graph, s, t, method="dinic").flow
        residual = (graph - flow).tocsr()
        residual.data[residual.data < 0] = 0
        residual.eliminate_zeros()
        reach = breadth_first_order(residual, s, directed=True, return_predecessors=False)
        side = np.zeros(n + 2, bool)
        side[reach] = True
        return (side[:n] & free) | forced_s


# ---------------------------------------------------------------------------
# the entry point


def _models(model, device) -> Tuple[GMM, GMM]:
    if model is None:
        model = (np.zeros((1, 13 * K)), np.zeros((1, 13 * K)))
    return tuple(GMM(torch.as_tensor(np.asarray(m, np.float64).reshape(-1), device=device).clone())
                 for m in model)


def grabcut(img_bgr_u8: np.ndarray, mask: Optional[np.ndarray], rect: Optional[Tuple[int, int, int, int]],
            iters: int, mode: int, model=None, device="cpu",
            generator: Optional[np.random.Generator] = None, times: Optional[dict] = None):
    """``cv2.grabCut(img, mask, rect, bgd_model, fgd_model, iters, mode)``.

    :param img_bgr_u8: (H, W, 3) uint8, BGR.
    :param mask: (H, W) uint8 of ``BGD``/``FGD``/``PR_BGD``/``PR_FGD``
        (ignored and made from ``rect`` under ``INIT_WITH_RECT``).
    :param rect: (x, y, width, height) for ``INIT_WITH_RECT``.
    :param mode: ``INIT_WITH_RECT``, ``INIT_WITH_MASK``, ``EVAL`` or
        ``EVAL_FREEZE_MODEL``.
    :param model: (bgd, fgd) models as OpenCV's (1, 65) float64 arrays, for
        ``EVAL`` and ``EVAL_FREEZE_MODEL`` (the init modes fit new ones).
    :param device: where the per-pixel work runs.
    :param generator: the draws of k-means++ (default: seeded 0).
    :param times: if given, ``device_ms`` (the per-pixel work, until its
        results are on the host) and ``cut_ms`` (the host's graph and cut)
        are added to it.
    :return: (mask, (bgd_model, fgd_model)): the new mask and the models as
        (1, 65) float64 arrays.
    """
    if img_bgr_u8.dtype != np.uint8 or img_bgr_u8.ndim != 3 or img_bgr_u8.shape[2] != 3:
        raise ValueError("grabcut takes an (H, W, 3) uint8 image")
    h, w, _ = img_bgr_u8.shape
    times = {} if times is None else times
    times.setdefault("device_ms", 0.0)
    times.setdefault("cut_ms", 0.0)
    t0 = time.perf_counter()
    if mode == INIT_WITH_RECT:
        x0, y0 = max(0, rect[0]), max(0, rect[1])
        mask = np.full((h, w), BGD, np.uint8)
        mask[y0 : y0 + min(rect[3], h - y0), x0 : x0 + min(rect[2], w - x0)] = PR_FGD
    else:
        mask = np.array(mask, np.uint8)
        if mask.shape != (h, w) or mask.max(initial=0) > PR_FGD:
            raise ValueError("the mask must be (H, W) with values BGD, FGD, PR_BGD or PR_FGD")
    img = torch.as_tensor(img_bgr_u8, device=device).to(_F64)
    x = img.reshape(-1, 3)
    bgd, fgd = _models(model, device)
    if mode in (INIT_WITH_RECT, INIT_WITH_MASK):
        rng = np.random.default_rng(0) if generator is None else generator
        is_bgd = torch.as_tensor((mask == BGD) | (mask == PR_BGD), device=device).reshape(-1)
        if bool(is_bgd.all()) or not bool(is_bgd.any()):
            raise GrabCutError("the mask leaves the background or the foreground without a sample")
        for gmm, side in ((bgd, is_bgd), (fgd, ~is_bgd)):
            xs = x[side]
            gmm.learn(xs, _kmeans(xs, K, rng))
    if iters > 0:
        graph = _Graph(mask, _edge_weights(img))
        soft = torch.as_tensor(graph.pixels, device=device)
        times["device_ms"] += (time.perf_counter() - t0) * 1e3
        for _ in range(iters):
            t0 = time.perf_counter()
            is_bgd = torch.as_tensor((mask == BGD) | (mask == PR_BGD), device=device).reshape(-1)
            pb, pf = bgd.component_density(x), fgd.component_density(x)
            labels = torch.where(is_bgd, torch.argmax(pb, 1), torch.argmax(pf, 1))
            if mode != EVAL_FREEZE_MODEL:
                bgd.learn(x[is_bgd], labels[is_bgd])
                fgd.learn(x[~is_bgd], labels[~is_bgd])
                pb, pf = bgd.component_density(x[soft]), fgd.component_density(x[soft])
            else:
                pb, pf = pb[soft], pf[soft]
            links = torch.stack([-torch.log(bgd.density(pb)), -torch.log(fgd.density(pf))]).cpu().numpy()
            t1 = time.perf_counter()
            fg = graph.source_side(links[0], links[1])
            flat = mask.reshape(-1)
            flat[graph.pixels] = np.where(fg, PR_FGD, PR_BGD)
            times["device_ms"] += (t1 - t0) * 1e3
            times["cut_ms"] += (time.perf_counter() - t1) * 1e3
    else:
        times["device_ms"] += (time.perf_counter() - t0) * 1e3
    return mask, tuple(g.model.cpu().numpy().reshape(1, -1).copy() for g in (bgd, fgd))

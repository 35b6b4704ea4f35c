"""The image operations of the real-image preprocessor, each the port's own
version of the OpenCV function named beside it and equal to it bit for bit
(the tests hold each to ``cv2``, which the port itself never imports):

- :func:`ellipse_kernel`: ``getStructuringElement(MORPH_ELLIPSE, (k, k))``;
- :func:`dilate`, :func:`erode`, :func:`close`: ``dilate``, ``erode`` and
  ``morphologyEx(MORPH_CLOSE)`` of a 0/255 mask, the image border ignored
  (OpenCV's default border value);
- :func:`largest_component`: ``connectedComponentsWithStats(mask, 8)`` and
  the label of the largest area, ties to OpenCV's first label;
- :func:`fill_holes`: the background that a 4-connected ``floodFill`` from a
  one-pixel ring around the mask does not reach becomes foreground;
- :func:`find_external_contours`, :func:`contour_area`:
  ``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` (Suzuki and Abe's
  border following, OpenCV's point lists and list order) and
  ``contourArea``;
- :func:`fit_ellipse`: ``fitEllipse`` (OpenCV's ``fitEllipseNoDirect``);
- :func:`resize_area`: ``resize(INTER_AREA)`` of uint8 and float32 images;
- :func:`count_components`: the label count of
  ``connectedComponents(mask, 8)``, background included;
- :func:`gaussian_blur`: ``GaussianBlur(img, (0, 0), sigma)`` of a float32
  image (bit-equal where OpenCV's vector loops cover a row, see there).

Host code on numpy and scipy; masks are (H, W) uint8.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
from scipy import ndimage

f32 = np.float32


# ---------------------------------------------------------------------------
# morphology


@functools.lru_cache(maxsize=16)
def ellipse_kernel(k: int) -> np.ndarray:
    """The (k, k) uint8 elliptic structuring element: row i holds ones on
    ``[max(c - dx, 0), min(c + dx + 1, k))`` with r = c = k // 2, dy = i - r
    and dx = c * sqrt((r^2 - dy^2) / r^2) rounded half to even."""
    r = c = k // 2
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * (1.0 / (r * r))))) if r else 0
        out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    out.flags.writeable = False
    return out


def _morph(mask: np.ndarray, k: int, reduce, border: int) -> np.ndarray:
    kern = ellipse_kernel(k)
    a = k // 2
    h, w = mask.shape
    padded = np.pad(mask, a, constant_values=border)
    out = np.full_like(mask, border)
    for i, j in zip(*np.nonzero(kern)):
        reduce(out, padded[i : i + h, j : j + w], out=out)
    return out


def dilate(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(mask, ellipse_kernel(k))``: the border pads with 0."""
    return _morph(mask, k, np.maximum, 0)


def erode(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(mask, ellipse_kernel(k))``: the border pads with 255."""
    return _morph(mask, k, np.minimum, 255)


def close(mask: np.ndarray, k: int) -> np.ndarray:
    """``cv2.morphologyEx(mask, MORPH_CLOSE, ellipse_kernel(k))``."""
    return erode(dilate(mask, k), k)


# ---------------------------------------------------------------------------
# components and holes

_EIGHT = np.ones((3, 3), bool)


def largest_component(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of ``mask > 0`` as a 0/255 mask (a
    mask without foreground is returned as it is). On a tie the component
    that OpenCV labels first wins: its labels follow the first 2x2 block of
    each component in raster order of the blocks (its block-based
    labelling), not the first pixel."""
    lab, n = ndimage.label(mask > 0, structure=_EIGHT)
    if n == 0:
        return mask
    ys, xs = np.nonzero(lab)
    ids = lab[ys, xs] - 1
    block = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
    first = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(first, ids, block)
    area = np.bincount(ids, minlength=n)
    order = np.argsort(first, kind="stable")   # OpenCV's label order
    big = order[int(np.argmax(area[order]))] + 1
    return np.where(lab == big, 255, 0).astype(np.uint8)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """Foreground where ``mask > 0`` or where the background is enclosed: a
    background pixel that a 4-connected flood from a one-pixel background
    ring around the mask does not reach."""
    inv = np.pad(mask == 0, 1, constant_values=True)
    lab, _ = ndimage.label(inv)
    holes = (lab != lab[0, 0])[1:-1, 1:-1] & (mask == 0)
    return np.where((mask > 0) | holes, 255, 0).astype(np.uint8)


def count_components(mask: np.ndarray) -> int:
    """The ``n`` of ``cv2.connectedComponents(mask)``: the 8-connected
    components of ``mask > 0`` plus one for the background label."""
    return int(ndimage.label(mask > 0, structure=_EIGHT)[1]) + 1


# ---------------------------------------------------------------------------
# contours

# direction s -> (dx, dy): right, up-right, up, up-left, left, down-left, down, down-right
_CODE = [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)]
_RIGHT_BOUND = -126   # OpenCV's mark (nbd | -128) of a border pixel whose right neighbour is 0
_BORDER = 2           # its mark of any other pixel of an outer border


def _follow_outer(img: np.ndarray, y0: int, x0: int) -> List[Tuple[int, int]]:
    """Trace the outer border that starts at (y0, x0) of the padded int8
    image, marking its pixels as OpenCV's ``icvFetchContour`` does, and
    return its CHAIN_APPROX_SIMPLE points (x, y) in the padded frame."""
    def at(y, x, s):
        dx, dy = _CODE[s & 7]
        return y + dy, x + dx

    s = s_end = 4
    while True:                      # clockwise from the left neighbour
        s = (s - 1) & 7
        y1, x1 = at(y0, x0, s)
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:                   # a single pixel
        img[y0, x0] = _RIGHT_BOUND
        return [(x0, y0)]
    points = []
    y3, x3 = y0, x0
    prev_s = s ^ 4
    while True:
        s_end = s
        while True:                  # counter-clockwise from the last direction
            s += 1
            y4, x4 = at(y3, x3, s)
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:          # the search passed the right neighbour, which is 0
            img[y3, x3] = _RIGHT_BOUND
        elif img[y3, x3] == 1:
            img[y3, x3] = _BORDER
        if s != prev_s:
            points.append((x3, y3))
            prev_s = s
        if (y4, x4) == (y0, x0) and (y3, x3) == (y1, x1):
            return points
        y3, x3 = y4, x4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]``: each outer border that lies in no other,
    as an (n, 1, 2) int32 array of (x, y) points, the same start point,
    direction and compressed points as OpenCV's, the list in OpenCV's order
    (the last border found first).

    The image is scanned in raster order with a one-pixel zero frame; a
    pixel starts an outer border where it is 1 and its left neighbour 0,
    unless the last border pixel met on its row (the "lnbd") is marked as
    inside a border (> 0); the border is followed and marked as OpenCV's
    ``icvFetchContour`` marks it, and the scan resumes after its start."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        lnbd = 0
        x = 1
        while x < w + 2:
            # the next pixel whose value differs from its left neighbour's
            diff = np.flatnonzero(row[x:] != row[x - 1 : -1])
            if diff.size == 0:
                break
            x += int(diff[0])
            prev, p = int(row[x - 1]), int(row[x])
            if prev == 0 and p == 1:
                if row[lnbd] <= 0:
                    pts = _follow_outer(img, y, x)
                    found.append(np.array(pts, np.int32).reshape(-1, 1, 2) - 1)
                    lnbd = x
            elif p == 0 and prev >= 1:   # a hole's border: not traced in this mode
                if prev & -2:
                    lnbd = x - 1
            elif p & -2:
                lnbd = x
            x += 1
    return found[::-1]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)`` of integer points: half the absolute
    shoelace sum (its terms and partial sums are exact integers, so the
    order of the sum does not matter)."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])) * 0.5)


def fit_ellipse(points: np.ndarray):
    """``cv2.fitEllipse(points)`` (OpenCV's ``fitEllipseNoDirect``, Weiss's
    fits): ``((cx, cy), (width, height), angle)`` as float32 values, or
    None for fewer than 5 points.

    The points are centred in float32 and scaled to a mean L1 distance of
    100 / n; a least-squares fit of ``[-x^2, -y^2, -xy, x, y] g = 10000``,
    the centre from the conic's gradient, a second fit of the
    quadratic terms about that centre, then the axes and the angle.

    Where the first fit's design is singular (its smallest singular value
    under FLT_EPSILON of its largest: the points lie on a line or another
    conic without a centre), OpenCV nudges the points and fits again, and
    its result then differs from one call to the next; such contours raise
    ``NotImplementedError``."""
    pts = np.asarray(points).reshape(-1, 2).astype(f32)
    n = len(pts)
    if n < 5:
        return None
    c = np.cumsum(pts, axis=0, dtype=f32)[-1] / f32(n)   # Point2f sums: float32, in order
    d = pts - c
    s = float(np.cumsum(np.abs(d).sum(1, dtype=f32), dtype=np.float64)[-1])
    scale = 100.0 / (s if s > np.finfo(f32).eps else float(np.finfo(f32).eps))

    px = d[:, 0].astype(np.float64) * scale
    py = d[:, 1].astype(np.float64) * scale
    a = np.stack([-px * px, -py * py, -px * py, px, py], 1)
    sv = np.linalg.svd(a, compute_uv=False)
    if sv[0] * np.finfo(f32).eps > sv[4]:
        raise NotImplementedError(
            f"fit_ellipse: the {n} points admit no unique conic fit (OpenCV's fit of such points varies "
            "between calls)"
        )
    g = np.linalg.lstsq(a, np.full(n, 10000.0), rcond=None)[0]
    rp = np.linalg.lstsq(np.array([[2 * g[0], g[2]], [g[2], 2 * g[1]]]), g[3:5], rcond=None)[0]
    a2 = np.stack([(px - rp[0]) ** 2, (py - rp[1]) ** 2, (px - rp[0]) * (py - rp[1])], 1)
    g = np.linalg.lstsq(a2, np.ones(n), rcond=None)[0]
    angle = -0.5 * np.arctan2(g[2], g[1] - g[0])
    t = g[2] / np.sin(-2.0 * angle) if abs(g[2]) > 1e-8 else g[1] - g[0]
    radii = []
    for r in (abs(g[0] + g[1] - t), abs(g[0] + g[1] + t)):
        radii.append(np.sqrt(2.0 / r) if r > 1e-8 else r)
    cx = f32(rp[0] / scale) + c[0]
    cy = f32(rp[1] / scale) + c[1]
    width, height = f32(radii[0] * 2 / scale), f32(radii[1] * 2 / scale)
    deg = f32(angle * 180 / np.pi)
    if width > height:
        width, height = height, width
        deg = f32(90 + angle * 180 / np.pi)
    if deg < -180:
        deg += f32(360)
    if deg > 360:
        deg -= f32(360)
    return (f32(cx), f32(cy)), (width, height), deg


# ---------------------------------------------------------------------------
# INTER_AREA


def _area_tab(in_size: int, out_size: int):
    """OpenCV's ``computeResizeAreaTab`` as (dst, src, weight) per tap, in
    its order: a leading partial tap, the full taps, a trailing one; the
    partial taps under 1e-3 dropped, each weight cast to float32."""
    scale = in_size / out_size
    tab = []
    for d in range(out_size):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, in_size - fs1)
        s2 = min(int(np.floor(fs2)), in_size - 1)
        s1 = min(int(np.ceil(fs1)), s2)
        if s1 - fs1 > 1e-3:
            tab.append((d, s1 - 1, f32((s1 - fs1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, f32(1.0 / cell)))
        if fs2 - s2 > 1e-3:
            tab.append((d, s2, f32(min(min(fs2 - s2, 1.0), cell) / cell)))
    return tab


def _by_rank(tab):
    """The taps grouped by their rank within their output index: rank r of
    every output at once keeps each output's order of accumulation."""
    ranks, last, r = [], None, 0
    for d, s, wt in tab:
        r = r + 1 if d == last else 0
        last = d
        if r == len(ranks):
            ranks.append(([], [], []))
        for lst, v in zip(ranks[r], (d, s, wt)):
            lst.append(v)
    return [(np.array(d), np.array(s), np.array(wt, f32)) for d, s, wt in ranks]


def _area_table_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """OpenCV's ``ResizeArea_Invoker``: each source row summed tap by tap
    along x in float32, then each output row the first row's ``beta * buf``
    plus each further row's ``beta * buf``, in table order."""
    src = img.astype(f32)
    buf = np.zeros((src.shape[0], out_w) + src.shape[2:], f32)
    for d, s, wt in _by_rank(_area_tab(src.shape[1], out_w)):
        wt = wt.reshape((1, -1) + (1,) * (src.ndim - 2))
        buf[:, d] = buf[:, d] + src[:, s] * wt
    out = None
    for r, (d, s, wt) in enumerate(_by_rank(_area_tab(src.shape[0], out_h))):
        term = buf[s] * wt.reshape((-1,) + (1,) * (src.ndim - 1))
        if r == 0:
            out = np.zeros((out_h,) + buf.shape[1:], f32)
            out[d] = term
        else:
            out[d] = out[d] + term
    return out


def _area_fast(img: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """OpenCV's integer-factor path (``resizeAreaFast``)."""
    h, w = img.shape[:2]
    oh, ow = h // fy, w // fx
    blocks = img.reshape(oh, fy, ow, fx, *img.shape[2:])
    if img.dtype == np.uint8:
        total = blocks.astype(np.int32).sum(axis=(1, 3))
        if (fy, fx) == (2, 2):                            # its SIMD path rounds half up
            return ((total + 2) >> 2).astype(np.uint8)
        return _saturate_u8(total.astype(f32) * f32(1.0 / (fy * fx)))
    if (fy, fx) == (2, 2):                                # its SIMD path
        if img.ndim == 3 and img.shape[2] == 3:
            acc = ((blocks[:, 0, :, 0] + blocks[:, 0, :, 1]) + blocks[:, 1, :, 0]) + blocks[:, 1, :, 1]
        else:
            acc = (blocks[:, 0, :, 0] + blocks[:, 0, :, 1]) + (blocks[:, 1, :, 0] + blocks[:, 1, :, 1])
        return acc * f32(0.25)
    # its scalar loop: the block's samples in raster order, four at a time
    taps = [blocks[:, i, :, j] for i in range(fy) for j in range(fx)]
    acc = np.zeros_like(taps[0])
    k = 0
    while k <= len(taps) - 4:
        acc = acc + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
        k += 4
    for t in taps[k:]:
        acc = acc + t
    return acc * f32(1.0 / (fy * fx))


def _saturate_u8(x: np.ndarray) -> np.ndarray:
    """OpenCV's ``saturate_cast<uchar>`` of float32: half to even, clipped."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _linear_area_coefs(in_size: int, out_size: int):
    """OpenCV's INTER_AREA upscale, which is linear with its area-mode
    offsets: per output index the source index and the float32 fraction
    toward its successor."""
    inv = out_size / in_size
    scale = 1.0 / inv
    idx = np.zeros(out_size, np.int64)
    frac = np.zeros(out_size, f32)
    for d in range(out_size):
        s = int(np.floor(d * scale))
        fx = f32((d + 1) - (s + 1) * inv)
        idx[d] = s
        frac[d] = f32(0) if fx <= 0 else fx - f32(np.floor(fx))
    return idx, frac


def _fixed(frac: np.ndarray) -> np.ndarray:
    """(1 - f, f) as OpenCV's 11-bit fixed-point weights."""
    return np.rint(np.stack([f32(1) - frac, frac], -1) * f32(2048)).astype(np.int32)


def _linear_taps(in_size: int, out_size: int):
    """Per output index the source index, its successor and the float32
    fraction ``f`` (weights ``1 - f`` and ``f``) of OpenCV's linear pass
    with area-mode offsets;
    from the first index whose successor lies past the edge on, the last
    sample alone (``xmax`` in OpenCV's ``HResizeLinear``). Returns
    (i0, i1, frac, alone) with ``alone`` the number of such trailing
    indices."""
    i0, frac = _linear_area_coefs(in_size, out_size)
    edge = i0 >= in_size - 1
    i0, frac = np.where(edge, in_size - 1, i0), np.where(edge, f32(0), frac)
    alone = int(edge.sum())
    return i0, np.minimum(i0 + 1, in_size - 1), frac, alone


def _linear_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """OpenCV's linear INTER_AREA resize of a uint8 image (an upscale, or a
    resize that shrinks one axis and grows the other): the horizontal pass in
    exact integers, the vertical one as its 128-bit vector loop rounds it
    (each row's sum shifted right by 4 bits before a 16-bit high product
    with its weight, the two products' sum rounded by 2 bits)."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1).astype(np.int32)
    x0, x1, xf, alone = _linear_taps(w, out_w)
    xw = _fixed(xf)
    rows = src[:, x0] * xw[:, 0, None] + src[:, x1] * xw[:, 1, None]
    if alone:
        rows[:, out_w - alone:] = src[:, x0[out_w - alone:]] * 2048
    yi, yf = _linear_area_coefs(h, out_h)
    yw = _fixed(yf)
    s0 = rows[np.clip(yi, 0, h - 1)] >> 4
    s1 = rows[np.clip(yi + 1, 0, h - 1)] >> 4
    out = ((s0 * yw[:, 0, None, None]) >> 16) + ((s1 * yw[:, 1, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


def _linear_f32(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """OpenCV's linear INTER_AREA resize of a float32 image: a horizontal
    pass, then a vertical one, each ``a * w0 + b * w1`` in float32 with
    the two products rounded apart (no fused multiply-add); the vertical
    pass's rows clamped to the image, its weights not."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    x0, x1, xf, alone = _linear_taps(w, out_w)
    rows = src[:, x0] * (f32(1) - xf)[:, None] + src[:, x1] * xf[:, None]
    if alone:
        rows[:, out_w - alone:] = src[:, x0[out_w - alone:]]
    yi, yf = _linear_area_coefs(h, out_h)
    r0, r1 = rows[np.clip(yi, 0, h - 1)], rows[np.clip(yi + 1, 0, h - 1)]
    out = r0 * (f32(1) - yf)[:, None, None] + r1 * yf[:, None, None]
    return out.reshape((out_h, out_w) + img.shape[2:])


def resize_area(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of
    an (H, W) or (H, W, C) uint8 or float32 image.

    - A downscale (both axes) at a ratio that is not an integer per axis
      takes OpenCV's area table (``computeResizeAreaTab``) and its
      accumulation order in float32; bit-equal to OpenCV for both dtypes.
    - Integer factors take OpenCV's fast path: uint8 sums are exact integers
      scaled by float32 ``1 / area`` and rounded half to even (half up at
      2 x 2, its vector path); float32 sums follow its order (at 2 x 2 its
      vector path's, else the block's samples in raster order, four at a
      time, each four summed before they are added).
    - Any other resize (an upscale, or one that shrinks one axis and grows
      the other) is OpenCV's linear interpolation with area-mode offsets:
      for uint8 in 11-bit fixed point, for float32 in float32, a horizontal
      pass then a vertical one, without fused multiply-adds. Bit-equal to
      OpenCV for both dtypes.
    """
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_area takes uint8 or float32 images, not {img.dtype}")
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"cannot resize {h}x{w} to {out_h}x{out_w}")
    if out_h <= h and out_w <= w:
        sy, sx = h / out_h, w / out_w
        if sy == int(sy) and sx == int(sx):
            return _area_fast(img, int(sy), int(sx))
        out = _area_table_resize(img, out_h, out_w)
        return _saturate_u8(out) if img.dtype == np.uint8 else out
    if img.dtype == np.uint8:
        return _linear_u8(img, out_h, out_w)
    return _linear_f32(img, out_h, out_w)


# ---------------------------------------------------------------------------
# Gaussian blur


def gaussian_kernel(sigma: float) -> np.ndarray:
    """OpenCV's Gaussian kernel of a float image for ``ksize = (0, 0)``:
    ``round(8 sigma + 1) | 1`` taps, each ``exp(-x^2 / (2 sigma^2))``
    divided by the sum of all in float64 (``getGaussianKernelBitExact``'s
    order: the two halves summed once and doubled, the centre 1), then
    cast to float32."""
    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    scale = -0.125 / (sigma * sigma)
    half = [math.exp(float((2 * i + 1 - n) ** 2) * scale) for i in range((n - 1) // 2)]
    inv = 1.0 / (sum(half) * 2.0 + 1.0)
    taps = [v * inv for v in half]
    return np.array(taps + [inv] + taps[::-1], f32)


def _fma(a: np.ndarray, k: np.float32, acc: np.ndarray) -> np.ndarray:
    """``fma(a, k, acc)`` in float32: the product is exact in float64."""
    return (a.astype(np.float64) * np.float64(k) + acc).astype(f32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of an (H, W) float32 image,
    reflect-101 border: a row pass, then a column pass, in the order of
    OpenCV's AVX2 loops, whose multiply-adds are fused. The row pass sums
    its taps left to right, fused in the columns below ``4 floor(W / 4)``,
    product then add beyond (its scalar tail). The column pass starts from
    the centre row's product and adds each symmetric pair's sum times its
    tap, outward, fused in the columns below ``8 floor(W / 8)``. Bit-equal
    to OpenCV on the CPU tests but at 7 taps (sigma 0.7-0.9), where the
    last ``W mod 4`` columns (OpenCV's scalar tail, whose order there was
    not found) differ in about 1 value in 4,000 of the image by at most 2
    float32 ulps."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"gaussian_blur takes an (H, W) float32 image, not {img.dtype} {img.shape}")
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    h, w = img.shape
    padded = np.pad(img, ((0, 0), (r, r)), mode="reflect")
    fused = (w // 4) * 4
    rows = padded[:, :w] * k[0]
    for j in range(1, len(k)):
        tap = padded[:, j:j + w]
        rows = np.concatenate([_fma(tap[:, :fused], k[j], rows[:, :fused]),
                               rows[:, fused:] + tap[:, fused:] * k[j]], axis=1)
    padded = np.pad(rows, ((r, r), (0, 0)), mode="reflect")
    fused = (w // 8) * 8
    out = padded[r:r + h] * k[r]
    for j in range(1, r + 1):
        pair = padded[r + j:r + j + h] + padded[r - j:r - j + h]
        out = np.concatenate([_fma(pair[:, :fused], k[r + j], out[:, :fused]),
                              out[:, fused:] + pair[:, fused:] * k[r + j]], axis=1)
    return out

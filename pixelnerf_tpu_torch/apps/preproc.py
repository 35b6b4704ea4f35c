"""Real-image preprocessor (counterpart of ``pixelnerf_tpu/apps/preproc.py``).

Segments the foreground object, fits an ellipse to the mask contour, crops a
square region around it, composites onto white, and resizes to
``--size``, writing ``*_normalize.png`` for ``eval_real``.

Segmentation backends:
- detectron2 PointRend (the reference's choice) when installed;
- otherwise the port's GrabCut (``utils/grabcut.py``) seeded by a central
  prior: its per-pixel work on ``--device`` (the GPU by default), its cut
  on the host.

The port reads PNG and JPEG inputs with its own decoders
(``utils/image_io.py``: ``utils/png.py``, ``utils/jpeg.py``), as imageio
reads them, and writes PNG; a gray or 16-bit input raises ``ValueError``.
The image operations are the port's own (``utils/imgproc.py``), equal to
OpenCV's.

    python -m pixelnerf_tpu_torch.apps.preproc --input raw/ --output input/
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional

import numpy as np

from ..utils import grabcut as gc
from ..utils import image_io, imgproc, png


def _segment_pointrend(img_bgr, coco_class: int):
    from detectron2.config import get_cfg  # optional heavy dep
    from detectron2.engine import DefaultPredictor
    from detectron2.projects import point_rend

    cfg = get_cfg()
    point_rend.add_pointrend_config(cfg)
    cfg.merge_from_file(
        point_rend.__path__[0] + "/configs/InstanceSegmentation/"
        "pointrend_rcnn_R_50_FPN_3x_coco.yaml"
    )
    predictor = DefaultPredictor(cfg)
    out = predictor(img_bgr)["instances"]
    keep = out.pred_classes == coco_class
    if keep.sum() == 0:
        return None
    masks = out.pred_masks[keep].cpu().numpy()
    areas = masks.sum(axis=(1, 2))
    return masks[int(np.argmax(areas))].astype(np.uint8) * 255


def _cleanup_mask(mask):
    """Largest connected component + morphological close + hole fill —
    removes stray background blobs and closes interior holes (car windows
    etc.) that the color model misclassifies."""
    return imgproc.fill_holes(imgproc.close(imgproc.largest_component(mask), 7))


def _segment_grabcut(img_bgr, iters: int = 10, device="cuda", times: Optional[dict] = None):
    """Two-pass GrabCut seeded by a central prior, with mask cleanup.

    Pass 1 runs rect-initialized GrabCut; pass 2 re-derives trimap seeds
    from the cleaned pass-1 mask (eroded core = sure-FG, dilated complement
    = sure-BG) and refines with mask-initialized GrabCut. k-means draws
    from a generator seeded 0, so segmentation is deterministic.

    :param times: if given, receives the ms of each pass (``pass1``,
        ``pass2``, each with ``_device`` and ``_cut`` parts) and of the
        cleanup and trimap (``cleanup``).
    """
    times = {} if times is None else times
    h, w = img_bgr.shape[:2]
    # central prior: assume the object occupies the middle of the frame
    rect = (int(w * 0.08), int(h * 0.08), int(w * 0.84), int(h * 0.84))
    part = {}
    mask, model = gc.grabcut(img_bgr, None, rect, iters, gc.INIT_WITH_RECT, device=device,
                             generator=np.random.default_rng(0), times=part)
    times["pass1_device"], times["pass1_cut"] = part["device_ms"], part["cut_ms"]
    t0 = time.perf_counter()
    out = np.where((mask == gc.FGD) | (mask == gc.PR_FGD), 255, 0).astype(np.uint8)
    if out.sum() == 0:
        return None
    m1 = _cleanup_mask(out)
    sure_fg = imgproc.erode(m1, 15)
    sure_bg = imgproc.dilate(m1, 15) == 0
    mask2 = np.full((h, w), gc.PR_FGD, np.uint8)
    mask2[m1 == 0] = gc.PR_BGD
    mask2[sure_fg > 0] = gc.FGD
    mask2[sure_bg] = gc.BGD
    times["cleanup"] = (time.perf_counter() - t0) * 1e3
    part = {}
    try:
        mask2, _ = gc.grabcut(img_bgr, mask2, None, 5, gc.INIT_WITH_MASK, model=model, device=device,
                              generator=np.random.default_rng(0), times=part)
        t0 = time.perf_counter()
        out2 = np.where((mask2 == gc.FGD) | (mask2 == gc.PR_FGD), 255, 0).astype(np.uint8)
        if out2.sum():
            m1 = _cleanup_mask(out2)
        times["cleanup"] += (time.perf_counter() - t0) * 1e3
    except gc.GrabCutError:
        pass  # degenerate trimap (all one class) — keep the pass-1 mask
    times["pass2_device"], times["pass2_cut"] = part.get("device_ms", 0.0), part.get("cut_ms", 0.0)
    return m1


def fit_crop(mask: np.ndarray, scale_major: float = 0.8, scale_minor: float = 4.37):
    """The ellipse of the largest outer contour and the square crop about
    it: ``((cx, cy), (width, height), radius, (ccen, rcen))``, or None where
    the mask has no contour of 5 points or more."""
    contours = imgproc.find_external_contours(mask)
    if not contours:
        return None
    contour = max(contours, key=imgproc.contour_area)
    fit = imgproc.fit_ellipse(contour)
    if fit is None:
        return None
    (cx, cy), axes, _angle = fit
    # the fit reports (width, height) of the rotated rect, unsorted — the
    # reference sorts (preproc.py:243) before scaling
    minor, major = min(axes), max(axes)
    radius = int(np.ceil(max(minor * scale_minor, major * scale_major) / 2.0))
    return (cx, cy), axes, radius, (int(round(cx)), int(round(cy)))


def crop_and_resize(img_rgb: np.ndarray, mask: np.ndarray, crop_fit, size: int = 128) -> np.ndarray:
    """The white composite of ``img_rgb`` under ``mask``, cropped to the
    square of ``fit_crop``'s radius about its centre (padded with white
    past the image) and area-resized to (size, size)."""
    _, _, radius, (ccen, rcen) = crop_fit
    x0, y0 = ccen - radius, rcen - radius
    x1, y1 = ccen + radius, rcen + radius
    h, w = img_rgb.shape[:2]
    pad_l, pad_t = max(0, -x0), max(0, -y0)
    pad_r, pad_b = max(0, x1 - w), max(0, y1 - h)
    comp = img_rgb.astype(np.float32)
    m = (mask.astype(np.float32) / 255.0)[..., None]
    comp = comp * m + 255.0 * (1.0 - m)
    comp = np.pad(
        comp, ((pad_t, pad_b), (pad_l, pad_r), (0, 0)), constant_values=255.0
    )
    crop = comp[y0 + pad_t : y1 + pad_t, x0 + pad_l : x1 + pad_l]
    return imgproc.resize_area(crop.astype(np.uint8), size, size)


def normalize_image(img_rgb: np.ndarray, mask: np.ndarray, size: int = 128,
                    scale_major: float = 0.8, scale_minor: float = 4.37):
    """Ellipse-fit crop + white composite (reference preproc.py:240-298)."""
    crop_fit = fit_crop(mask, scale_major, scale_minor)
    if crop_fit is None:
        return None
    return crop_and_resize(img_rgb, mask, crop_fit, size)


def read_rgb(path: str) -> np.ndarray:
    """The RGB image at ``path``, a PNG or a JPEG (an alpha channel dropped,
    as the JAX app drops it)."""
    img = image_io.imread(path)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"{path}: expected an 8-bit RGB or RGBA image, got {img.dtype} of shape {img.shape}")
    return img[..., :3]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", type=str, default="raw")
    parser.add_argument("--output", type=str, default="input")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--coco_class", type=int, default=2, help="car")
    parser.add_argument("--backend", type=str, default="auto",
                        choices=["auto", "pointrend", "grabcut"])
    parser.add_argument("--scale", "-S", type=float, default=4.37,
                        help="bbox scaling rel the fitted ellipse's minor "
                        "axis (reference preproc.py:192-198)")
    parser.add_argument("--major_scale", "-M", type=float, default=0.8,
                        help="bbox scaling rel the fitted ellipse's major "
                        "axis; the larger radius wins "
                        "(reference preproc.py:199-206)")
    parser.add_argument("--const_border", action="store_true",
                        help="accepted for reference-CLI compatibility; "
                        "the normalize output is identical either way "
                        "(the mask pads to 0, so padded pixels composite "
                        "to white regardless of the image border mode — "
                        "reference preproc.py:272-277)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of GrabCut's per-pixel work (default cuda); the CPU only "
                        "when asked for")
    parser.add_argument("--cpu", action="store_true", help="run on the host CPU: the same as --device cpu")
    parser.add_argument("--gpu_id", type=str, default="0",
                        help="accepted for CLI compatibility with the other apps and ignored; the "
                        "device comes from --device")
    args = parser.parse_args(argv)
    if args.cpu:
        if args.device is not None and args.device.split(":")[0] != "cpu":
            parser.error(f"--cpu and --device {args.device} disagree")
        args.device = "cpu"
    elif args.device is None:
        args.device = "cuda"
    return args


def main(argv=None):
    """Run the app; returns {input path: its times and fit} for each image
    written (ms of the read, each GrabCut pass, the cleanup, the ellipse,
    the resize and the write; the mask's foreground share; the ellipse's
    centre and axes; the crop radius)."""
    args = parse_args(argv)

    if os.path.isdir(args.input):
        paths = sorted(
            p for p in glob.glob(os.path.join(args.input, "*"))
            if p.lower().endswith((".png", ".jpg", ".jpeg"))
            and not p.endswith("_normalize.png")
        )
    else:
        paths = sorted(glob.glob(args.input))
    os.makedirs(args.output, exist_ok=True)

    use_pointrend = args.backend in ("auto", "pointrend")
    if use_pointrend:
        try:
            import detectron2  # noqa: F401
        except ImportError:
            if args.backend == "pointrend":
                raise
            use_pointrend = False
            print("detectron2 unavailable; using GrabCut fallback segmentation")

    report = {}
    for path in paths:
        times = {}
        t0 = time.perf_counter()
        img = read_rgb(path)
        bgr = np.ascontiguousarray(img[..., ::-1])
        times["read"] = (time.perf_counter() - t0) * 1e3
        mask = (
            _segment_pointrend(bgr, args.coco_class)
            if use_pointrend
            else _segment_grabcut(bgr, device=args.device, times=times)
        )
        if mask is None:
            print(f"SKIP {path}: no object found")
            continue
        t0 = time.perf_counter()
        crop_fit = fit_crop(mask, args.major_scale, args.scale)
        times["ellipse"] = (time.perf_counter() - t0) * 1e3
        if crop_fit is None:
            print(f"SKIP {path}: degenerate mask")
            continue
        (cx, cy), axes, radius, _ = crop_fit
        if 2 * radius < args.size:
            print(f"{path}: the crop ({2 * radius} px) is narrower than --size {args.size}; upscaled as "
                  "OpenCV's INTER_AREA upscales")
        t0 = time.perf_counter()
        out = crop_and_resize(img, mask, crop_fit, args.size)
        times["resize"] = (time.perf_counter() - t0) * 1e3
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.output, f"{base}_normalize.png")
        t0 = time.perf_counter()
        png.imwrite(out_path, out)
        times["write"] = (time.perf_counter() - t0) * 1e3
        report[path] = {"ms": times, "foreground": float((mask > 0).mean()),
                        "center": (float(cx), float(cy)), "axes": tuple(float(a) for a in axes),
                        "radius": radius, "output": out_path}
        print("Wrote", out_path)
    return report


if __name__ == "__main__":
    main()

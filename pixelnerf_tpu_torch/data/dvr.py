"""DVR dataset reader (counterpart of ``pixelnerf_tpu/data/dvr.py``): the
NMR/3D-R2N2 ShapeNet renderings and the DTU real scenes of Niemeyer et al.

Layout ``<path>/<category>/<object>/{image/*.png, mask/*.png,
cameras.npz}`` with ``<category>/<list_prefix><stage>.lst`` naming the
objects of a split. Two sub-formats:

- ``shapenet``: pose from ``world_mat_inv`` (or the inverse of
  ``world_mat``), focal from ``camera_mat`` (``fx == fy`` asserted),
  rescaled from the [-1, 1] NMR convention with ``scale_focal``;
- ``dtu``: P = K [R | t] decomposed per view, the ``scale_mat``
  normalisation applied to the camera centre, and the intrinsics averaged
  over the object's views (per-view intrinsics are discarded, as the
  reference does).

The same dict and the same float32 values as the JAX reader. Images and
masks are decoded by the port's own readers (``utils/image_io.py``): an
object's PNG views in one ``png.imread_many``, its JPEG views one by one
(``utils/jpeg.py``); the projection matrices are
decomposed in numpy (:func:`decompose_projection`) with OpenCV's sign
conventions, so no imaging library is needed.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.image_io import imread_many
from .base import DatasetBase, image_to_tensor, mask_bbox, mask_to_tensor, resize_area_np

_SHAPENET_WORLD = np.array(
    [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32
)
_SHAPENET_CAM = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)
_DTU_FLIP = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)


def decompose_projection(P: np.ndarray):
    """P (3, 4) = s K [R | t] -> (K, R, camera centre), as
    ``cv2.decomposeProjectionMatrix`` gives them and the JAX reader
    normalises them (K / K[2, 2], the centre dehomogenised).

    An RQ decomposition of P's left 3x3 (a QR of its flipped transpose),
    brought to OpenCV's signs: R a proper rotation (K and R negated
    together where its determinant is negative), K[0, 0] and K[1, 1]
    positive (a rotation by 180 degrees about the axis they leave alone,
    ``D = diag(d0, d1, d0 d1)``, moved from K to R), then K divided by
    K[2, 2]. The centre is P's null vector, ``-M^-1 p4``, in float64.

    :return: (K (3, 3) float64, R (3, 3) float64, centre (3,) float64)
    """
    P = np.asarray(P, np.float64)
    M = P[:, :3]
    flip = np.eye(3)[::-1]
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip            # upper triangular
    R = flip @ q.T                   # orthogonal; M = K R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    d0 = 1.0 if K[0, 0] >= 0 else -1.0
    d1 = 1.0 if K[1, 1] >= 0 else -1.0
    D = np.diag([d0, d1, d0 * d1])
    K, R = K @ D, D @ R
    return K / K[2, 2], R, -np.linalg.solve(M, P[:, 3])


class DVRDataset(DatasetBase):
    def __init__(
        self,
        path,
        stage="train",
        list_prefix="softras_",
        image_size=None,
        sub_format="shapenet",
        scale_focal=True,
        max_imgs=100000,
        z_near=1.2,
        z_far=4.0,
        seed=1234,
        cache_cap=0,
    ):
        self.base_path = path
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        cats = [x for x in glob.glob(os.path.join(path, "*")) if os.path.isdir(x)]
        file_lists = [os.path.join(x, f"{list_prefix}{stage}.lst") for x in cats]

        all_objs = []
        for file_list in file_lists:
            if not os.path.exists(file_list):
                continue
            base_dir = os.path.dirname(file_list)
            cat = os.path.basename(base_dir)
            with open(file_list, "r") as f:
                all_objs.extend((cat, os.path.join(base_dir, x.strip())) for x in f if x.strip())
        self.all_objs = all_objs
        self.stage = stage
        self.image_size = image_size
        self.sub_format = sub_format
        self.scale_focal = scale_focal
        self.max_imgs = max_imgs
        self.z_near = z_near
        self.z_far = z_far
        self.lindisp = False
        # opt-in decoded-object cache (--override data.cache_cap=N); objects
        # that max_imgs subsamples are never cached, so that each pull
        # draws its views anew (the reference's semantics)
        self._cache_setup(cache_cap)
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.all_objs)

    def __getitem__(self, index):
        cached = self._cache_get(index)
        if cached is not None:
            return cached

        _, root_dir = self.all_objs[index]
        rgb_paths = sorted(
            x for x in glob.glob(os.path.join(root_dir, "image", "*")) if x.endswith((".jpg", ".png"))
        )
        mask_paths = sorted(glob.glob(os.path.join(root_dir, "mask", "*.png")))
        if len(mask_paths) == 0:
            mask_paths = [None] * len(rgb_paths)

        cacheable = len(rgb_paths) <= self.max_imgs
        if cacheable:
            sel_indices = np.arange(len(rgb_paths))
        else:
            sel_indices = self._rng.choice(len(rgb_paths), self.max_imgs, replace=False)
            rgb_paths = [rgb_paths[i] for i in sel_indices]
            mask_paths = [mask_paths[i] for i in sel_indices]

        all_cam = np.load(os.path.join(root_dir, "cameras.npz"))
        # the views the JAX reader's loop visits (zip stops at the shorter list)
        pairs = list(zip(rgb_paths, mask_paths))
        has_masks = mask_paths[0] is not None
        rgbs = imread_many([r for r, _ in pairs])
        mask_imgs = imread_many([m for _, m in pairs]) if has_masks else [None] * len(pairs)

        imgs, poses, masks, bboxes = [], [], [], []
        focal = None
        fx = fy = cx = cy = 0.0
        for idx, (rgb, mask) in enumerate(zip(rgbs, mask_imgs)):
            i = sel_indices[idx]
            img = rgb[..., :3]
            if self.scale_focal:
                x_scale = img.shape[1] / 2.0
                y_scale = img.shape[0] / 2.0
                xy_delta = 1.0
            else:
                x_scale = y_scale = 1.0
                xy_delta = 0.0

            if self.sub_format == "dtu":
                K, R, t = decompose_projection(all_cam[f"world_mat_{i}"][:3])
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = R.T
                pose[:3, 3] = t
                scale_mtx = all_cam.get(f"scale_mat_{i}")
                if scale_mtx is not None:
                    norm_trans = scale_mtx[:3, 3]
                    norm_scale = np.diagonal(scale_mtx[:3, :3])
                    pose[:3, 3] = (pose[:3, 3] - norm_trans) / norm_scale
                fx += K[0, 0] * x_scale
                fy += K[1, 1] * y_scale
                cx += (K[0, 2] + xy_delta) * x_scale
                cy += (K[1, 2] + xy_delta) * y_scale
                pose = _DTU_FLIP @ pose @ _DTU_FLIP
            else:
                inv_key, key = f"world_mat_inv_{i}", f"world_mat_{i}"
                if inv_key in all_cam:
                    pose = all_cam[inv_key]
                else:
                    m = all_cam[key]
                    if m.shape[0] == 3:
                        m = np.vstack([m, np.array([0, 0, 0, 1.0])])
                    pose = np.linalg.inv(m)
                intr = all_cam[f"camera_mat_{i}"]
                if abs(intr[0, 0] - intr[1, 1]) >= 1e-9:
                    raise ValueError(f"{root_dir}: view {i} has fx != fy")
                f_i = intr[0, 0] * x_scale
                if focal is None:
                    focal = f_i
                elif abs(f_i - focal) >= 1e-5:
                    raise ValueError(f"{root_dir}: inconsistent focal across views")
                pose = _SHAPENET_WORLD @ pose.astype(np.float32) @ _SHAPENET_CAM

            imgs.append(image_to_tensor(img))
            poses.append(pose.astype(np.float32))
            if mask is not None:
                mask = mask_to_tensor(mask)
                masks.append(mask)
                bboxes.append(mask_bbox(mask))

        images = np.stack(imgs).astype(np.float32)
        poses = np.stack(poses)

        result = {"path": root_dir, "img_id": index, "poses": poses}
        c = None
        if self.sub_format == "dtu":
            n = len(rgb_paths)
            focal = np.array([fx / n, fy / n], dtype=np.float32)
            c = np.array([cx / n, cy / n], dtype=np.float32)
            bboxes = None
        else:
            focal = np.float32(focal)
            bboxes = np.stack(bboxes).astype(np.float32) if bboxes else None

        masks_arr = np.stack(masks).astype(np.float32) if masks else None

        if self.image_size is not None and images.shape[1:3] != tuple(self.image_size):
            scale = self.image_size[0] / images.shape[1]
            focal = focal * scale
            if c is not None:
                c = c * scale
            if bboxes is not None:
                bboxes = bboxes * scale
            images = resize_area_np(images, *self.image_size)
            if masks_arr is not None:
                masks_arr = resize_area_np(masks_arr, *self.image_size)

        result["focal"] = focal
        result["images"] = images
        if c is not None:
            result["c"] = c
        if masks_arr is not None:
            result["masks"] = masks_arr
        if bboxes is not None:
            result["bbox"] = bboxes
        return self._cache_put(index, result) if cacheable else result

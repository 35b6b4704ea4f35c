"""SRN ShapeNet dataset reader (counterpart of ``pixelnerf_tpu/data/srn.py``).

Layout ``<path>_<stage>/<obj>/{intrinsics.txt, rgb/*, pose/*}``, with a
white-background mask inferred from the non-white pixels and a tight bbox
per view; NHWC float32 numpy output, the same dict as the JAX reader's.
Images are decoded by the port's own PNG reader (``utils/png.py``), all
of an object's views in one ``imread_many``.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.png import imread_many
from .base import DatasetBase, image_to_tensor, mask_bbox, resize_area_np

# SRN poses are OpenCV-style (y down, z forward); flip to the y-up/-z
# convention of the renderer
_COORD_TRANS = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


class SRNDataset(DatasetBase):
    def __init__(
        self, path, stage="train", image_size=(128, 128), world_scale=1.0,
        z_near=None, z_far=None, cache_cap=0,
    ):
        self.base_path = path + "_" + stage
        self.dataset_name = os.path.basename(path)
        self.stage = stage
        if not os.path.exists(self.base_path):
            raise FileNotFoundError(self.base_path)

        is_chair = "chair" in self.dataset_name
        if is_chair and stage == "train":
            # SRN's public chair set nests the training objects one level down
            nested = os.path.join(self.base_path, "chairs_2.0_train")
            if os.path.exists(nested):
                self.base_path = nested

        self.intrins = sorted(glob.glob(os.path.join(self.base_path, "*", "intrinsics.txt")))
        self.image_size = image_size
        self.world_scale = world_scale

        self.z_near, self.z_far = (1.25, 2.75) if is_chair else (0.8, 1.8)
        # explicit bounds (--override data.z_near=...) beat the class-name
        # defaults, for SRN-layout data holding scenes of other depth ranges
        if z_near is not None:
            self.z_near = float(z_near)
        if z_far is not None:
            self.z_far = float(z_far)
        self.lindisp = False
        # opt-in decoded-object cache (--override data.cache_cap=N)
        self._cache_setup(cache_cap)

    def __len__(self):
        return len(self.intrins)

    def __getitem__(self, index):
        cached = self._cache_get(index)
        if cached is not None:
            return cached

        intrin_path = self.intrins[index]
        dir_path = os.path.dirname(intrin_path)
        rgb_paths = sorted(glob.glob(os.path.join(dir_path, "rgb", "*")))
        pose_paths = sorted(glob.glob(os.path.join(dir_path, "pose", "*")))
        if len(rgb_paths) != len(pose_paths):
            raise ValueError(f"{dir_path}: {len(rgb_paths)} images but {len(pose_paths)} poses")

        with open(intrin_path, "r") as f:
            focal, cx, cy, _ = map(float, f.readline().split())

        # every view at once: the same values as the JAX reader's loop
        rgb = np.stack([img[..., :3] for img in imread_many(rgb_paths)])
        masks = ((rgb[..., 0] != 255) & (rgb[..., 1] != 255) & (rgb[..., 2] != 255))[..., None].astype(np.float32)
        images = image_to_tensor(rgb)
        poses = np.stack([np.loadtxt(p, dtype=np.float32).reshape(4, 4) for p in pose_paths]) @ _COORD_TRANS
        bboxes = np.stack([mask_bbox(m) for m in masks])

        if images.shape[1:3] != tuple(self.image_size):
            scale = self.image_size[0] / images.shape[1]
            focal *= scale
            cx *= scale
            cy *= scale
            bboxes *= scale
            images = resize_area_np(images, *self.image_size)
            masks = resize_area_np(masks, *self.image_size)

        if self.world_scale != 1.0:
            # scales focal as well as translation, as the reference does
            focal *= self.world_scale
            poses[:, :3, 3] *= self.world_scale

        return self._cache_put(index, {
            "path": dir_path,
            "img_id": index,
            "focal": np.float32(focal),
            "c": np.array([cx, cy], dtype=np.float32),
            "images": images.astype(np.float32),
            "masks": masks.astype(np.float32),
            "bbox": bboxes.astype(np.float32),
            "poses": poses.astype(np.float32),
        })

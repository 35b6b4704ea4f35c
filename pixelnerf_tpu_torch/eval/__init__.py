from .common import FullRenderer, depth_cmap, resize_area_like_cv2  # noqa: F401

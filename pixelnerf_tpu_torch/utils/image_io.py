"""The port's image reader: PNG (``utils/png.py``) and JPEG
(``utils/jpeg.py``), chosen by the file's signature as Pillow chooses, not by
its extension. Each returns what ``imageio.v2.imread`` returns."""
from __future__ import annotations

from typing import Sequence

from . import jpeg, png


def _kind(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(len(png.SIGNATURE))
    if head == png.SIGNATURE:
        return "png"
    if head[:2] == jpeg.SOI:
        return "jpeg"
    raise ValueError(f"{path}: neither a PNG nor a JPEG file (the port reads these two)")


def imread(path: str):
    """The image at ``path``, as ``imageio.v2.imread`` returns it."""
    return png.imread(path) if _kind(path) == "png" else jpeg.imread(path)


def imread_many(paths: Sequence[str]) -> list:
    """``[imread(p) for p in paths]``, in path order: the PNG files through
    ``png.imread_many`` (their rows reconstructed together), the JPEG files
    one by one."""
    kinds = [_kind(p) for p in paths]
    pngs = iter(png.imread_many([p for p, k in zip(paths, kinds) if k == "png"]))
    return [next(pngs) if k == "png" else jpeg.imread(p) for p, k in zip(paths, kinds)]

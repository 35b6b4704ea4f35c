from .common import FullRenderer  # noqa: F401

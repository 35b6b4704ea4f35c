from .geometry import (  # noqa: F401
    combine_interleaved,
    gen_rays,
    invert_pose,
    look_at,
    pose_spherical,
    repeat_interleave,
    unproj_map,
)

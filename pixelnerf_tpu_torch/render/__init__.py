from .renderer import (  # noqa: F401
    NeRFRenderer,
    RenderConfig,
    RenderSchedule,
    composite,
    composite_outputs,
    draw_noise,
    render_rays,
    render_rays_chunked,
    sample_coarse,
    sample_fine,
    sample_fine_depth,
)

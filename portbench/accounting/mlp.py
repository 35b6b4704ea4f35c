"""Operations of the conditioned ResnetFC field (the mathematics of
``models/resnetfc.py``): ``lin_in``, the latent injections ``lin_z`` before
``combine_layer``, ``n_blocks`` two-layer residual blocks, the mean over the
source views at ``combine_layer``, ``lin_out``. The matrix products are
counted, two operations a multiply-add; the bias adds, activations and the
mean (under 0.5% of the products at the published widths) are not, as the
tensor cores' peak counts only products."""
from __future__ import annotations


def mlp_point_flops(d_in: int, d_latent: int, d_hidden: int, n_blocks: int, combine_layer: int,
                    d_out: int = 4, num_views: int = 1, pad_in: int = None, pad_out: int = None) -> int:
    """Operations of one sample point through the field, conditioned on
    ``num_views`` source views: the layers before ``combine_layer`` run once
    a view, the rest once. ``pad_in`` and ``pad_out`` widen ``lin_in``'s
    input and ``lin_out``'s output to a kernel's padded widths (the
    benchmark's own counts leave them unset: the model's widths)."""
    d_in = pad_in or d_in
    d_out = pad_out or d_out
    before = min(combine_layer, n_blocks)
    n_lin_z = before if d_latent > 0 else 0
    per_view = 2 * d_hidden * (d_in + n_lin_z * d_latent + before * 2 * d_hidden)
    after = 2 * d_hidden * ((n_blocks - before) * 2 * d_hidden + d_out)
    return num_views * per_view + after


def field_rows_per_ray(n_coarse: int, n_fine: int) -> int:
    """Field evaluations a ray needs in the hierarchical render: the coarse
    MLP on the coarse samples, the fine MLP on the coarse and the new
    samples."""
    return n_coarse + (n_coarse + n_fine if n_fine > 0 else 0)


def model_d_in(model: dict) -> int:
    """The spatial code's width: xyz through the positional code, then the
    view direction."""
    code = model["code"]
    d = 3 * 2 * code["num_freqs"] + (3 if code["include_input"] else 0)
    return d + (3 if model["use_viewdirs"] else 0)


def config_point_flops(model: dict, num_views: int = 1) -> int:
    """:func:`mlp_point_flops` for a configuration's ``model`` tree."""
    m = model["mlp"]
    return mlp_point_flops(model_d_in(model), model["encoder"]["latent_size"], m["d_hidden"], m["n_blocks"],
                           m["combine_layer"], num_views=num_views)


def render_ray_flops(model: dict, renderer: dict, num_views: int) -> int:
    """The field's operations for one ray of a hierarchical render."""
    rows = field_rows_per_ray(renderer["n_coarse"], renderer["n_fine"])
    return rows * config_point_flops(model, num_views)

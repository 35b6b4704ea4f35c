"""The benchmark's operation and byte counts against PERF.md's kernel
bounds and against a count of the reference's own convolutions."""
import torch
from small_cells import spec  # noqa: F401  (puts the checkout on sys.path)

from portbench.accounting import encoder, gather, mlp, peaks


def test_kernel_b_row_at_its_padded_widths_is_perf_mds_7_08_mflop():
    # csrc/fused_mlp.cu pads lin_in's input to 128 columns and lin_out's output to 128
    assert mlp.mlp_point_flops(42, 512, 512, 5, 3, pad_in=128, pad_out=128) == 7_077_888


def test_a_16384_ray_srn_view_is_bound_at_18_8_ms_by_b():
    rows = 16384 * mlp.field_rows_per_ray(64, 32)
    ms = rows * mlp.mlp_point_flops(42, 512, 512, 5, 3, pad_in=128, pad_out=128) / peaks.BF16_FLOPS * 1e3
    assert rows == 16384 * 160
    assert round(ms, 1) == 18.8


def test_the_models_own_widths_count_less_than_the_kernels_padding():
    cfg = spec.load_json(spec.config_file("srn"))
    assert mlp.model_d_in(cfg["model"]) == 42
    assert mlp.config_point_flops(cfg["model"]) == 2 * 512 * (42 + 3 * 512 + 5 * 2 * 512 + 4)


def test_three_views_run_the_blocks_before_the_combine_once_a_view():
    one = mlp.mlp_point_flops(42, 512, 512, 5, 3)
    three = mlp.mlp_point_flops(42, 512, 512, 5, 3, num_views=3)
    after = 2 * 512 * (2 * 2 * 512 + 4)
    assert three - after == 3 * (one - after)


def test_kernel_a_bound_is_perf_mds_0_327_ms():
    # 1,048,576 points from a 4096 x 512 bf16 map whose rows they all touch
    moved = gather.gather_bytes(1_048_576, 512, 4096)
    assert round(moved / peaks.HBM_BYTES * 1e3, 3) == 0.327


def test_encoder_count_matches_the_convolutions_the_reference_runs():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.harness import weights
    from portbench.reference import encoder as ref_encoder

    cfg = spec.load_json(spec.config_file("srn"))
    w = weights.spec(cfg, 42)
    w = {n: torch.zeros(s) if n.startswith("encoder") else None for n, s, _ in w}
    w = {n: (v + 1 if n.endswith("running_var") else v) for n, v in w.items() if v is not None}
    with FlopCounterMode(display=False) as counter:
        ref_encoder.encode(w, torch.zeros(1, 64, 96, 3), cfg["model"]["encoder"])
    convs = sum(v for k, v in counter.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert convs == encoder.encoder_image_flops(cfg["model"]["encoder"], 64, 96)
    assert encoder.encoder_image_train_flops(cfg["model"]["encoder"], 64, 96) < 3 * convs

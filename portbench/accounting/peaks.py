"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit)."""

BF16_FLOPS = 989e12     # tensor cores, bf16 and fp16
F32_FLOPS = 67e12       # float32 off the tensor cores
HBM_BYTES = 3.35e12     # HBM3 bandwidth, bytes/s

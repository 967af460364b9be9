"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit). A roofline share is stated against these with the
card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12        # device memory
BF16_FLOPS = 989e12              # bf16 tensor cores
FP32_FLOPS = 67e12               # float32 outside the tensor cores

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit)."""

# the chip's highest dense rate short of fp8: no implementation that the
# correctness check accepts (float32, TF32 off) can pass it, so a share of
# it stays under 100 % whatever a later PR does to the matmuls
FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

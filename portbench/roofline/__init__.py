"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of the port's kernels (a frozen copy of ``chip_smoke.py``'s), and
the model FLOPs counted from the plain reference."""

# Published peaks of one H100 SXM at its full power limit of 700 W (NVIDIA's
# data sheet, dense rates): bf16 / fp16 tensor cores, fp32 outside the
# tensor cores, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

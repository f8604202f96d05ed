"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates), copied from ``repro_torch.roofline.H100_SXM`` so that
the yardstick does not move with the program."""

H100 = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}

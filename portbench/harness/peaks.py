"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit). A roofline or mfu share is stated against
these, with the card's power limit beside it."""
TF32_FLOPS = 495e12        # tensor cores, TF32
FP32_FLOPS = 67e12         # CUDA cores, float32
HBM_BYTES = 3.35e12        # HBM3 bandwidth, bytes/s

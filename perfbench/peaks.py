"""Published peaks of one NVIDIA H100 SXM5 80 GB at its 700 W limit (the
data sheet's dense rates, without sparsity), copied from the program's
``roofline/hw.py``.  A card set below 700 W runs slower under load, so a
share of these peaks is stated with the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 66.9e12
BF16_FLOPS = 989.4e12
HBM_BYTES = 80e9

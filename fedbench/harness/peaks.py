"""The chip's published peaks: NVIDIA H100 SXM5 80GB HBM3 data sheet,
dense rates without sparsity, at the 700 W power limit (the values of the
port's ``sharding/roofline.py``, copied so that the yardstick stays here).
Every share of a peak in this benchmark is against these numbers, with the
card's power limit printed beside it."""
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

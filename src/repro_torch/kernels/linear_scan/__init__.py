"""Gated linear recurrence / prefix-sum kernel (CUDA, ``csrc/linear_scan.cu``)."""

"""Flash-attention kernel (CUDA, ``csrc/flash_attention.cu``)."""

"""Flash-decode kernel (CUDA, ``csrc/decode_attention.cu``)."""

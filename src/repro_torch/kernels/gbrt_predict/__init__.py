"""GBRT ensemble kernels (CUDA, ``csrc/gbrt_predict.cu``)."""

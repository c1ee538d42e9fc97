"""The model zoo of the port: the dense LM so far (``lm.py``), its layers,
attention (through the flash-attention and flash-decode kernels), the
parameter substrate and the converter from the JAX package's params."""

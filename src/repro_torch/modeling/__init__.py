"""The model zoo of the port: the dense LM (``lm.py``) and the Mamba-2 LM
(``mamba.py``, SSD blocks in ``ssd.py`` through the SSD scan kernel), their
layers, attention (through the flash-attention and flash-decode kernels),
the parameter substrate and the converter from the JAX package's params."""

"""Sequential placement-state replay kernel (CUDA, ``csrc/state_replay.cu``)."""

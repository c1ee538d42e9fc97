"""Hand-written Hopper kernels of the port, one package per kernel.

Each ``<name>/kernel.py`` holds the launch wrapper of a CUDA kernel from
``repro_torch/csrc`` and its plain PyTorch version. A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises. Every wrapper counts its launches in a plain integer attribute
``launches`` (incremented where the kernel is launched and nowhere else);
``launch_counts``/``reset_launch_counts`` read and zero them all.

Importing this package imports torch only: the kernels are compiled
(``_build``) the first time a wrapper meets a CUDA tensor.
"""

from __future__ import annotations


def wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.gbrt_predict.kernel import (
        gbrt_predict_blocked,
        gbrt_predict_multi,
    )
    from repro_torch.kernels.linear_scan.kernel import linear_scan_bsd
    from repro_torch.kernels.state_replay.kernel import (
        state_replay,
        state_walk,
    )

    return {"gbrt_predict_multi": gbrt_predict_multi,
            "gbrt_predict_blocked": gbrt_predict_blocked,
            "linear_scan": linear_scan_bsd,
            "state_replay": state_replay,
            "state_walk": state_walk}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0

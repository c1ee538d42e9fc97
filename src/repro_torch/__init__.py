"""PyTorch/CUDA port of the edge-cloud serverless placement system.

The package mirrors ``repro`` (the JAX reference): ``core/`` holds the
placement system — models, Predictor, Decision Engine, the AWS twin, the
serve loop and the torch placement core; ``configs/``, ``modeling/`` and
``serving/`` the dense and Mamba-2 LMs and the live prototype that serves
them (executors, calibration, the live runtime; ``launch/serve.py`` is its
CLI); and ``kernels/`` the hand-written CUDA kernels for Hopper (sources in
``csrc/``) with their plain PyTorch versions.

Device policy: every entry point runs on the CUDA card. ``resolve_device``
turns the ``device=`` argument of an entry point into a ``torch.device``:
``None`` means ``cuda`` and raises when CUDA is absent; the CPU is used only
when the caller asks for it with ``device="cpu"``. Placement state is
float64 on every device (``DTYPE``).

Importing the package imports torch and numpy only; no kernel is compiled
and no kernel library is imported until a kernel meets a CUDA tensor.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` → ``cuda``; ``"cpu"`` (or a CPU ``torch.device``) → the CPU, on
    request only. Raises ``RuntimeError`` when CUDA is asked for (explicitly
    or by default) and is not available — there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev

"""Hand-written Hopper kernels of the port, one package per kernel.

Each ``<name>/kernel.py`` holds the launch wrapper of a CUDA kernel from
``repro_torch/csrc`` and its plain PyTorch version. A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises; where autograd would need a gradient through a CUDA launch,
a wrapper goes through an ``autograd.Function`` whose backward is a kernel
(K4 with K4b, K3's chunked regime with K3b, K6 with K6b) or raises
``NotImplementedError`` before it launches (the kernels without a
backward), so no gradient is dropped silently. Every wrapper counts its launches in a plain integer attribute
``launches`` (incremented where the kernel is launched and nowhere else);
``launch_counts``/``reset_launch_counts`` read and zero them all.
``recording`` tallies the launches of one thread alone, as a CUDA-graph
capture needs while other threads launch kernels of their own; its blocks
nest. A backward pass on the card runs on autograd's own device thread:
each Function keeps the tally open where its forward ran and counts its
backward kernel there, and a checkpointed layer (``carry_recording``) runs
its recompute, the forward kernels' relaunch, in that tally too, so a block
around ``loss.backward()`` sees both.

``counting`` is the dry run's mode: inside its block a model kernel's
wrapper (K3-K6, K3b, K4b, K6b) given fake or meta tensors runs nothing,
returns empty outputs of the right shapes and dtypes, and adds its kernel's
operation counts (``flops.py``) to the block's dict; on tensors with data
it launches or runs its plain version as ever. So a step traced over fake
tensors never steps a plain scan's Python loop over time.

Importing this package imports torch only: the kernels are compiled
(``_build``) the first time a wrapper meets a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import functools


def wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
    )
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
    )
    from repro_torch.kernels.gbrt_predict.kernel import (
        gbrt_predict_blocked,
        gbrt_predict_multi,
    )
    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_bsd,
        linear_scan_bwd_bsd,
    )
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_bwd_bhsd,
    )
    from repro_torch.kernels.state_replay.kernel import (
        state_replay,
        state_walk,
    )

    return {"gbrt_predict_multi": gbrt_predict_multi,
            "gbrt_predict_blocked": gbrt_predict_blocked,
            "linear_scan": linear_scan_bsd,
            "linear_scan_bwd": linear_scan_bwd_bsd,
            "state_replay": state_replay,
            "state_walk": state_walk,
            "flash_attention": flash_attention_bhsd,
            "flash_attention_bwd": flash_attention_bwd_bhsd,
            "decode_attention": decode_attention_bhd,
            "ssd_scan": ssd_scan_bhsd,
            "ssd_scan_bwd": ssd_scan_bwd_bhsd}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` and, where it has them, the
    per-route counts of its ``routes``."""
    for fn in wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", {}):
            fn.routes[route] = 0


@contextlib.contextmanager
def recording():
    """Tally, by kernel name, the launches that the calling thread makes
    inside the block, and those counted for it on other threads (K4b's,
    K3b's and K6b's, which autograd's device thread launches for the
    Function whose forward ran in the block; a ``carry_recording``
    function's);
    other launches of other threads are not seen. Yields the dict, filled
    when the block ends. Blocks nest: the launches of an inner block count
    in every block around it too. A launch counted for a block that has
    already closed (a backward run after the block around its forward
    ended) counts only in the wrappers' ``launches``."""
    from repro_torch.kernels import _build

    outer = _build.current_tally()
    _build._RECORDING.tally = tally = {}
    out: dict[str, int] = {}
    try:
        yield out
    finally:
        _build._RECORDING.tally = outer
        with _build._COUNT_LOCK:  # other threads may still count into it
            counts = dict(tally)
            if outer is not None:
                for fn, n in counts.items():
                    outer[fn] = outer.get(fn, 0) + n
        out.update({name: counts[fn] for name, fn in wrappers().items()
                    if fn in counts})


@contextlib.contextmanager
def counting():
    """Count the model kernels' calls on fake or meta tensors made by the
    calling thread inside the block (autograd runs a CPU graph's backward
    on the calling thread). Yields ``{kernel name: {"calls", "flops",
    "dense_flops"}}``, filled as the calls are made: ``flops`` the kernel's
    own work, ``dense_flops`` what ``FlopCounterMode`` counts over its
    plain version (``flops.py``). An inner block counts apart from the
    outer one."""
    from repro_torch.kernels import _build

    outer = getattr(_build._COUNTING, "tally", None)
    _build._COUNTING.tally = tally = {}
    try:
        yield tally
    finally:
        _build._COUNTING.tally = outer


def carry_recording(fn):
    """``fn`` bound to the ``recording`` block open on the calling thread
    now, if any: every later call, on whatever thread, tallies its
    launches there. For work that autograd replays on its own device
    thread, as a checkpointed layer's recompute (K3, K4 or K6 launched
    again) is."""
    from repro_torch.kernels import _build

    tally = _build.current_tally()
    if tally is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = _build.current_tally()
        _build._RECORDING.tally = tally
        try:
            return fn(*args, **kwargs)
        finally:
            _build._RECORDING.tally = saved
    return run

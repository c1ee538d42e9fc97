"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/kernels/<name>-<hash>.so`` at the root of the checkout
(``build/`` is git-ignored), compiled for Hopper (``sm_90a``) on first use.
Every source but the attention kernels (``flash_attention``, its backward
``flash_attention_bwd``, ``decode_attention``) is built with
``-fmad=false``: their parities with the plain versions (bit-equal in
float64) rest on no multiply and add being contracted into an FMA; the
attention kernels' softmax and dot products want their FMAs and are held to
a tolerance (``flags``). The hash covers the source, the headers of
``csrc`` it includes (``#include "<name>.cuh"``: ``fa_mma.cuh``, which the
attention kernels and the SSD backward include) and its flags, so an
edited source, header or flag rebuilds
and an unchanged one loads at once.
``build_all`` starts one ``nvcc`` per source, all together, and waits for
them; ``library`` builds a single missing one on demand. Nothing here runs
when the package is imported.

A wrapper counts each launch with ``counted``: in its ``launches`` and in
the ``recording`` tally open on the calling thread, or in the tally it is
given (``current_tally`` names the open one).

A wrapper passes tensor pointers and PyTorch's current stream as
``c_void_p`` and raises ``KernelLaunchError`` when the C function returns a
CUDA error code (the C side returns ``cudaGetLastError()`` right after the
launch, so a refused launch never passes silently). A kernel that cannot be
built raises it too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from repro_torch import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gbrt_predict", "linear_scan", "state_replay", "flash_attention",
           "flash_attention_bwd", "decode_attention", "ssd_scan",
           "ssd_scan_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# sources free to contract a multiply and an add into an FMA
FMAD_SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()  # guards every wrapper's ``launches``
_RECORDING = threading.local()  # .tally: {wrapper: launches} of this thread
_COUNTING = threading.local()  # .tally: {kernel: counts} of this thread
_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.M)


class KernelLaunchError(RuntimeError):
    """A kernel of the port could not be built, or the card refused its
    launch. Callers that turn executor errors into retryable failures
    re-raise it (``serving.placement.is_cuda_error``)."""


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise KernelLaunchError("nvcc not found: set CUDA_HOME to the CUDA "
                            "toolkit or put nvcc on PATH")


def flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + (() if name in FMAD_SOURCES else ("-fmad=false",))


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc`` it includes, in
    order."""
    src = CSRC / f"{name}.cu"
    heads = (CSRC / h.decode() for h in _INCLUDE.findall(src.read_bytes()))
    return [src] + [h for h in heads if h.is_file()]


def lib_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in sources(name))
    digest = hashlib.sha1(
        text + " ".join(flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: Path) -> list[str]:
    return [nvcc(), *flags(name), "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every listed source that has no current library, one ``nvcc``
    process per source, all started together. Returns per source the build
    seconds (0 when it was already built) and the compiler's output (ptxas
    register and shared-memory report). Raises if any build fails. The
    call is the span ``kernels.build`` (``repro_torch.spans``, when
    recording)."""
    with spans.span("kernels.build"):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        report: dict[str, dict] = {}
        t0 = time.perf_counter()
        for name in names:
            out = lib_path(name)
            if out.exists():
                report[name] = {"seconds": 0.0, "log": "", "path": str(out)}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(out)}
        if failed:
            raise KernelLaunchError("nvcc failed for " + "\n".join(failed))
        return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of library ``name`` with its ``argtypes`` declared and an
    ``int`` (CUDA error code) result, looked up once."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer, or NULL for ``None``. A DTensor is
    refused: a kernel takes plain tensors (a DTensor's ``to_local()``)."""
    if t is None:
        return ctypes.c_void_p(None)
    if type(t).__name__ == "DTensor":
        raise TypeError("a kernel takes plain tensors, got a DTensor; pass "
                        "its to_local()")
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, queried
    as PyTorch's compiled code does, without building a ``Stream`` object
    on every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def current_tally():
    """The tally of the innermost ``recording`` block open on the calling
    thread, or None."""
    return getattr(_RECORDING, "tally", None)


def counted(wrapper, tally=None) -> None:
    """Add one to ``wrapper.launches``: each wrapper calls this where it has
    launched its kernel, and nowhere else. The increment holds a lock, so
    threads that launch at once (sharded runtimes) lose no count. A launch
    is also tallied in ``tally`` when given (a launch made on another
    thread for a block of the caller's, as autograd's device thread runs
    K4b for the block around ``loss.backward()``), else in the calling
    thread's open ``repro_torch.kernels.recording`` block, if any. A tally
    whose block has already closed is read by no one: such a launch counts
    in ``launches`` only."""
    if tally is None:
        tally = current_tally()
    with _COUNT_LOCK:
        wrapper.launches += 1
        if tally is not None:
            tally[wrapper] = tally.get(wrapper, 0) + 1


def abstract(*tensors) -> bool:
    """Whether a ``repro_torch.kernels.counting`` block is open on the
    calling thread and one of ``tensors`` is a fake or a meta tensor: a
    wrapper then counts its kernel's operations (``count``) and returns
    empty outputs instead of running anything. Never true for a tensor
    with data, on any device."""
    if getattr(_COUNTING, "tally", None) is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor

    return any(t is not None and (t.is_meta or isinstance(t, FakeTensor))
               for t in tensors)


def count(name: str, work: float, dense: float) -> None:
    """Add one call of kernel ``name`` and its operations (``flops.py``:
    the kernel's own work, and what its plain version's products count) to
    the calling thread's open ``counting`` block."""
    entry = _COUNTING.tally.setdefault(
        name, {"calls": 0, "flops": 0.0, "dense_flops": 0.0})
    entry["calls"] += 1
    entry["flops"] += work
    entry["dense_flops"] += dense


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through a call on ``tensors``:
    grad mode is on and one of them requires a gradient."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` before a launch that autograd would have
    to differentiate through, for a kernel with no backward kernel: its
    output is written through ctypes and has no ``grad_fn``, so a backward
    pass would silently give no gradient to anything behind it. CPU tensors
    never get here (their plain versions are differentiable)."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{what}: the kernel has no backward on the card; call it under "
            "torch.no_grad() or on tensors that do not require a gradient")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelLaunchError(
            f"{what}: CUDA launch failed with error code {rc}")


def strides(*tensors) -> ctypes.Array:
    """All but the last element stride of each tensor in turn, as a C
    ``long long`` array (the attention kernels read strided views whose last
    dimension is contiguous)."""
    vals = [s for t in tensors for s in t.stride()[:-1]]
    return (ctypes.c_longlong * len(vals))(*vals)


P = ctypes.c_void_p
I32 = ctypes.c_int
F32 = ctypes.c_float
F64 = ctypes.c_double

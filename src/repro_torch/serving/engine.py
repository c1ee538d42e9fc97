"""Serving step builders, the CUDA-graph decode step and batched generation.

The port of ``repro.serving.engine``. ``make_prefill_step`` /
``make_decode_step`` return the step functions an executor runs:

    prefill_step(params, batch)        -> (logits (B, V) float32, cache)
    decode_step(params, cache, batch)  -> (logits (B, V) float32, cache)

(the decode step updates ``cache`` in place, see ``modeling/lm.py`` and
``modeling/mamba.py``). The audio encoder (``modeling/encoder.py``) is
served by the same step functions: its prefill step takes a
``{"frames": ...}`` batch (``"mask"`` optional) and returns (frame logits
(B, S, V) float32, None), and its decode step raises, as the reference's
does; it has no CUDA graph (the reference compiles none for it), and the
live executors serve the token families only.
``make_compiled_steps`` is the executor-facing entry: model, parameters drawn
on the executor's device from its seed, and the two steps in one call. Where
the reference compiles both steps with ``jax.jit``, an executor on the card
captures them in CUDA graphs at its cold start, the prefill for its prompt
shape (``PrefillGraph``) and the decode step (``DecodeGraph``), and replays
them for every warm execution; on the CPU both run eagerly.

``generate`` runs greedy or temperature decoding for a batch of prompts.
Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so
its tokens compare one for one with the reference's; temperature sampling
draws from a seeded ``torch.Generator`` (its draws differ from
``jax.random``'s).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch import resolve_device, spans
from repro_torch.modeling.registry import build_model

# one capture at a time in the process: a capture must not interleave with
# another capture's allocations
_CAPTURE_LOCK = threading.Lock()
# one lock per CUDA stream (``stream_lock``), taken before ``_CAPTURE_LOCK``
_STREAM_LOCKS: dict = {}
_STREAM_LOCKS_LOCK = threading.Lock()
# kernel launches replayed from prefill and decode graphs, by kernel name
_REPLAYED: dict[str, int] = {}
_REPLAYED_LOCK = threading.Lock()


def make_compiled_steps(model_cfg, seed: int = 0, device=None,
                        cache_len: int | None = None):
    """Build (model, params, prefill_fn, decode_fn) for one executor.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the CPU. Parameters are drawn from a generator on
    that device seeded with ``seed``. Each parameter goes through the
    model's ``serving_cast`` as soon as it is drawn, and its float32 master
    is dropped: a parameter the model uses in ``cfg.dtype`` is cast to it
    (the cast the model would make at every use, made once, so the numbers
    are the same and the resident weights take half the memory in bf16),
    one it uses in float32 stays float32."""
    device = resolve_device(device)
    model = build_model(model_cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = model.init(gen, device=device, cast=model.serving_cast)
    return (model, params, make_prefill_step(model, cache_len=cache_len),
            make_decode_step(model))


def serving_bytes(model_cfg) -> int:
    """Bytes of the parameters an executor holds (``make_compiled_steps``:
    each in the dtype its model's ``serving_cast`` keeps it in), from the
    specs alone."""
    model = build_model(model_cfg)
    probe = torch.empty((), dtype=torch.float32)
    return sum(int(np.prod(spec.shape))
               * model.serving_cast(path, probe).element_size()
               for path, spec in model.param_specs().items())


def make_prefill_step(model, cache_len: int | None = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return decode_step


def stream_lock(stream) -> threading.RLock:
    """The lock of ``stream``'s raw CUDA stream (re-entrant; one for all the
    ``torch.cuda.Stream`` objects that wrap it).

    ``torch.cuda.Stream()`` hands out streams round-robin from a small pool
    per device, so two executors, or an executor and a side stream of
    ``_capture``, can hold the same raw stream. A capture records whatever
    any thread puts on the capturing stream, or is broken by it. So every
    thread that runs work on a stream that may capture holds its lock for
    as long as it does: a capture there waits for that work, and that work
    waits for the capture. Work on one stream runs one after another on
    the card anyway."""
    with _STREAM_LOCKS_LOCK:
        return _STREAM_LOCKS.setdefault(stream, threading.RLock())


def _capture(fn, device, reset=None):
    """Capture ``fn()`` in a CUDA graph on ``device``: one warm-up call
    first (as graph capture wants), then ``reset()`` when given, then the
    capture. Returns (graph, what the captured call returned, the
    kernel launches the capture recorded for the calling thread alone, by
    kernel name).

    Warm-up and capture run on the caller's current stream, where an
    executor replays the graph, unless that is the device's default
    stream, which cannot capture (then on a side stream). A captured cuBLAS
    call keeps the workspace PyTorch holds for its (handle, stream), so
    graphs captured on one stream share a workspace: captured on torch's
    one default capture stream, the graphs of executors that replay them at
    once on their own streams (``serve_async``'s worker threads) raced on
    it, and at llama3.2-1b's full width such replays never finished.
    Captured where they replay, graphs that share a workspace share a
    stream and run one after another. The stream's ``stream_lock`` is held
    from the warm-up to the end of the capture; the wait for it and for
    ``_CAPTURE_LOCK`` is the span ``cold.capture_lock``."""
    from repro_torch import kernels

    current = torch.cuda.current_stream(device)
    on = current
    if current == torch.cuda.default_stream(device):
        on = torch.cuda.Stream(device=device)
    with contextlib.ExitStack() as held:
        with spans.span("cold.capture_lock"):
            held.enter_context(stream_lock(on))
            held.enter_context(_CAPTURE_LOCK)
        if on is not current:
            on.wait_stream(current)
        with torch.cuda.stream(on):  # warm-up, as graph capture wants
            fn()
        current.wait_stream(on)
        if reset is not None:
            reset()
        graph = torch.cuda.CUDAGraph()
        with kernels.recording() as captured, \
                torch.cuda.graph(graph, stream=on,
                                 capture_error_mode="thread_local"):
            out = fn()
    return graph, out, captured


def _replay(graph, launches: dict[str, int]) -> None:
    graph.replay()
    with _REPLAYED_LOCK:
        for name, n in launches.items():
            _REPLAYED[name] = _REPLAYED.get(name, 0) + n


class PrefillGraph:
    """A prefill captured in a CUDA graph for one prompt shape.

    ``tokens`` (B, S) fixes the shape and the device. The graph reads the
    prompt from its static ``tokens`` tensor and leaves the last token's
    logits and a fresh cache (of any family, ``pos`` included) in static
    tensors, which every ``run`` overwrites: copy the cache out (as
    ``DecodeGraph.load`` does) before the next run. The prefill of every
    family captures: no host copy, sync or host-side read of a device value
    runs inside it (the cache's ``pos`` is a fill on the device).

    Launches are tallied as ``DecodeGraph`` tallies them:
    ``launches_per_replay`` (recorded for the capturing thread alone) is
    added to ``replayed_launches`` at every run; the wrappers' own counts
    see the warm-up and the capture only."""

    def __init__(self, prefill_fn, params, tokens: torch.Tensor):
        self.params = params  # the graph reads them: keep them alive
        self.tokens = tokens.clone()
        self.graph, (self.logits, self.cache), self.launches_per_replay = \
            _capture(lambda: prefill_fn(params, {"tokens": self.tokens}),
                     self.tokens.device)

    def run(self) -> tuple[torch.Tensor, dict]:
        """One prefill of ``self.tokens``; returns the (static) logits and
        cache."""
        _replay(self.graph, self.launches_per_replay)
        return self.logits, self.cache


class DecodeGraph:
    """A decode step captured in a CUDA graph over static buffers.

    ``cache`` (a prefill's output, of any family) fixes the shapes and the
    device. The graph reads the token from ``token`` and the position from
    the static cache's ``pos`` tensor; it updates the cache in place (the
    dense family writes the token's K/V at the clamped slot, the hybrid
    family at its ring slot, the SSM and hybrid families their states and
    conv windows), advances ``pos`` and leaves the logits in ``logits``, all
    on the device. ``load`` copies a fresh cache in before a run of ``step``
    calls.

    The wrappers' launch counts (``repro_torch.kernels``) count the kernels
    that the warm-up and the capture launch, and no replay. The graphs keep
    their own tally instead: ``launches_per_replay`` (by kernel name,
    recorded for the capturing thread alone) is added to
    ``replayed_launches`` at every replay."""

    def __init__(self, decode_fn, params, cache: dict):
        self.params = params  # the graph reads them: keep them alive
        self.cache = {k: v.clone() for k, v in cache.items()}
        # every family's cache entries but "pos" are (layers, batch, ...)
        ref = next(v for k, v in cache.items() if k != "pos")
        self.token = torch.zeros(ref.shape[1], dtype=torch.int32,
                                 device=ref.device)
        self.graph, (self.logits, _), self.launches_per_replay = _capture(
            lambda: decode_fn(params, self.cache, {"token": self.token}),
            ref.device, reset=lambda: self.load(cache))

    def load(self, cache: dict) -> None:
        for k, v in cache.items():
            self.cache[k].copy_(v)

    def step(self) -> torch.Tensor:
        """One decode step of token ``self.token``; returns the (static)
        logits tensor."""
        _replay(self.graph, self.launches_per_replay)
        return self.logits


def replayed_launches() -> dict[str, int]:
    """Kernel launches run by ``PrefillGraph`` and ``DecodeGraph`` replays
    since the last ``reset_replayed_launches``, by kernel name (not in the
    wrappers' ``launches``)."""
    with _REPLAYED_LOCK:
        return dict(_REPLAYED)


def reset_replayed_launches() -> None:
    with _REPLAYED_LOCK:
        _REPLAYED.clear()


def _sample(logits, generator, temperature: float = 0.0):
    if temperature and temperature > 0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(model, params, tokens, *, max_new_tokens: int, cache_len: int,
             temperature: float = 0.0, seed: int = 0,
             prefill_fn=None, decode_fn=None):
    """Greedy/temperature generation. tokens: (B, S) int32 prompt batch on
    the parameters' device. Returns (B, max_new_tokens) int32. Pass the
    executor's ``prefill_fn`` / ``decode_fn`` to reuse them."""
    prefill_fn = prefill_fn or make_prefill_step(model, cache_len)
    decode_fn = decode_fn or make_decode_step(model)
    gen = torch.Generator(device=tokens.device)
    gen.manual_seed(seed)
    logits, cache = prefill_fn(params, {"tokens": tokens})
    out = []
    for i in range(max_new_tokens):
        tok = _sample(logits, gen, temperature).to(torch.int32)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_fn(params, cache, {"token": tok})
    return torch.stack(out, dim=1)


def batch_prompts(prompts: list[np.ndarray], pad_to: int, pad_id: int = 0):
    """Left-pad a ragged prompt list into a (B, pad_to) batch."""
    B = len(prompts)
    out = np.full((B, pad_to), pad_id, np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)[-pad_to:]
        out[i, pad_to - len(p):] = p
    return out

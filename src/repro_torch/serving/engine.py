"""Serving step builders, the CUDA-graph decode step and batched generation.

The port of ``repro.serving.engine``. ``make_prefill_step`` /
``make_decode_step`` return the step functions an executor runs:

    prefill_step(params, batch)        -> (logits (B, V) float32, cache)
    decode_step(params, cache, batch)  -> (logits (B, V) float32, cache)

(the decode step updates ``cache`` in place, see ``modeling/lm.py`` and
``modeling/mamba.py``).
``make_compiled_steps`` is the executor-facing entry: model, parameters drawn
on the executor's device from its seed, and the two steps in one call. Where
the reference compiles the steps with ``jax.jit``, an executor on the card
captures its decode step in a CUDA graph (``DecodeGraph``) at its cold start
and replays it for every warm decode; PyTorch runs the prefill eagerly.

``generate`` runs greedy or temperature decoding for a batch of prompts.
Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so
its tokens compare one for one with the reference's; temperature sampling
draws from a seeded ``torch.Generator`` (its draws differ from
``jax.random``'s).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.modeling.registry import build_model

# one capture at a time in the process: a capture must not interleave with
# another capture's allocations
_CAPTURE_LOCK = threading.Lock()
# kernel launches replayed from decode graphs, by kernel name
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


def make_prefill_step(model, cache_len: int | None = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return decode_step


class DecodeGraph:
    """A decode step captured in a CUDA graph over static buffers.

    ``cache`` (a prefill's output, of any family) fixes the shapes and the
    device. The graph reads the token from ``token`` and the position from
    the static cache's ``pos`` tensor; it updates the cache in place (the
    dense family writes the token's K/V at the clamped slot, the SSM family
    its states and conv windows), advances ``pos`` and leaves the logits in
    ``logits``, all on the device. ``load`` copies a fresh cache in before a
    run of ``step`` calls.

    The wrappers' launch counts (``repro_torch.kernels``) count the kernels
    that the warm-up and the capture launch, and no replay. The graphs keep
    their own tally instead: ``launches_per_replay`` (by kernel name,
    recorded for the capturing thread alone) is added to
    ``replayed_launches`` at every replay."""

    def __init__(self, decode_fn, params, cache: dict):
        from repro_torch import kernels

        self.params = params  # the graph reads them: keep them alive
        self.cache = {k: v.clone() for k, v in cache.items()}
        # every family's cache entries but "pos" are (layers, batch, ...)
        ref = next(v for k, v in cache.items() if k != "pos")
        self.token = torch.zeros(ref.shape[1], dtype=torch.int32,
                                 device=ref.device)
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(device=self.token.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up, as graph capture wants
                decode_fn(params, self.cache, {"token": self.token})
            torch.cuda.current_stream().wait_stream(side)
            self.load(cache)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.recording() as captured, \
                    torch.cuda.graph(self.graph,
                                     capture_error_mode="thread_local"):
                self.logits, _ = decode_fn(params, self.cache,
                                           {"token": self.token})
        self.launches_per_replay = captured

    def load(self, cache: dict) -> None:
        for k, v in cache.items():
            self.cache[k].copy_(v)

    def step(self) -> torch.Tensor:
        """One decode step of token ``self.token``; returns the (static)
        logits tensor."""
        self.graph.replay()
        with _REPLAYED_LOCK:
            for name, n in self.launches_per_replay.items():
                _REPLAYED[name] = _REPLAYED.get(name, 0) + n
        return self.logits


def replayed_launches() -> dict[str, int]:
    """Kernel launches run by ``DecodeGraph`` replays since the last
    ``reset_replayed_launches``, by kernel name (not in the wrappers'
    ``launches``)."""
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

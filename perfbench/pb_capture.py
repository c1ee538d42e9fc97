"""What the benchmark reads from the program while it serves, taken by
wrapping the program's calls from outside (nothing in the program is
changed):

- every execution of a serving executor (``LiveExecutor.execute``): its
  target, the executor's seed, the decode steps it ran (decode
  graph replays on the card; eager decode steps on the CPU, less the cold
  start's warm-up), the execution record the program returns (feed, start,
  comp, store, queue, cold), the logits it served last, which the program
  copies to the host and discards (kept here as a float32 copy made on the
  executor's own stream), and, for a model with a K/V cache, the cache's
  last slot after the last decode step (every layer's key and value, which
  the dense family's decode steps write there; a bf16 copy made alike);
- the prompt: the program's executors prefill a fixed prompt of zeros; the
  benchmark writes token ids drawn from each executor's seed into it before
  its first prefill (its graph captures them), so that prompts differ
  between executors and a decode step's state leaves a point that its
  zero tokens would keep; the decode token stays the program's;
- the decision engine's ``place_many``: its host seconds and the tasks it
  placed (a span wrapped on the engine instance).

While ``Capture.annotate`` is on, executions and decision passes also
open ``torch.profiler.record_function`` ranges for a traced window (the
profiler keeps those of the main thread; the pool's worker threads' are
lost, so gaps are named by CUDA runtime calls instead).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def prompt(seed: int, vocab: int, shape) -> torch.Tensor:
    """The prompt an executor of ``seed`` is given: token ids drawn from
    its seed, in the shape of the program's prompt."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, vocab, size=tuple(shape)),
                           dtype=torch.int32)


def _served(logits, cache):
    """Copies of what an execution served: its last logits (float32, flat)
    and, where the cache holds keys and values (``(layers, batch, slots,
    kv heads, head dim)``), every layer's K and V in the last slot of the
    first row, which each decode step of the dense family writes."""
    kept = logits.float().reshape(-1).clone()
    if cache is None or "k" not in cache or "v" not in cache \
            or not cache["k"].is_floating_point():
        return kept, None
    return kept, torch.stack([cache["k"][:, 0, -1], cache["v"][:, 0, -1]],
                             1).clone()


@dataclass
class Execution:
    target: str
    seed: int
    steps: int
    record: object          # the program's ExecutionRecord
    logits: torch.Tensor | None
    kv: torch.Tensor | None  # (layers, 2, kv heads, head dim) or None
    traced: bool
    t_end: float


@dataclass
class Capture:
    annotate: bool = False
    tracing: bool = False
    execs: list = field(default_factory=list)
    inputs: dict = field(default_factory=dict)  # executor seed -> (prompt, token)
    place_s: float = 0.0
    place_tasks: int = 0
    cold_now: int = 0     # executors drawing weights and capturing now
    cold_most: int = 0    # the most at once
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _tl: threading.local = field(default_factory=threading.local)
    _undo: list = field(default_factory=list)

    def reset(self) -> None:
        with self._lock:
            self.execs = []
            self.place_s = 0.0
            self.place_tasks = 0

    def _range(self, name: str):
        return torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()

    def _patch(self, owner, attr, wrapper) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, owner.__dict__.get(attr, None)
                           if isinstance(owner, type) else None, orig))
        setattr(owner, attr, wrapper(orig))

    def install(self) -> None:
        """Wrap the program's classes; undone by ``uninstall``."""
        from repro_torch.serving import engine, executors

        cap, tl = self, self._tl

        def compiled_steps(orig):
            def make_compiled_steps(model_cfg, seed=0, device=None,
                                    cache_len=None):
                with cap._lock:
                    cap.cold_now += 1
                    cap.cold_most = max(cap.cold_most, cap.cold_now)
                    now = cap.cold_now
                if torch.cuda.is_available():
                    print(f"[perfbench] cold start of executor {seed}: {now} "
                          f"at once, {torch.cuda.memory_allocated() / 2**30:.2f}"
                          " GiB allocated", file=sys.stderr, flush=True)
                try:
                    model, params, prefill_fn, decode_fn = orig(
                        model_cfg, seed=seed, device=device,
                        cache_len=cache_len)
                finally:
                    with cap._lock:
                        cap.cold_now -= 1
                seen: set = set()

                def prefill_step(p, batch):
                    toks = batch["tokens"]
                    if id(toks) not in seen and not (
                            toks.is_cuda
                            and torch.cuda.is_current_stream_capturing()):
                        seen.add(id(toks))
                        toks.copy_(prompt(seed, model_cfg.vocab,
                                          toks.shape).to(toks.device))
                    tl.prompt = toks
                    return prefill_fn(p, batch)

                def decode_step(p, cache, batch):
                    logits, cache = decode_fn(p, cache, batch)
                    tl.logits, tl.token = logits, batch["token"]
                    tl.cache = cache
                    tl.steps = getattr(tl, "steps", 0) + 1
                    return logits, cache
                return model, params, prefill_step, decode_step
            return make_compiled_steps

        def graph_step(orig):
            def step(graph):
                logits = orig(graph)
                tl.logits, tl.token = logits, graph.token
                tl.cache = graph.cache
                tl.graph_steps = getattr(tl, "graph_steps", 0) + 1
                return logits
            return step

        def graph_run(orig):
            def run(graph):
                tl.prompt = graph.tokens
                return orig(graph)
            return run

        def execute(orig):
            def run(ex, n_tokens, payload_bytes):
                tl.steps = tl.graph_steps = 0
                tl.logits = tl.cache = None
                with cap._range("pb.execute"):
                    rec = orig(ex, n_tokens, payload_bytes)
                on_card = ex.stream is not None
                steps = tl.graph_steps if on_card \
                    else tl.steps - (1 if rec.cold else 0)
                kept = kv = None
                if tl.logits is not None:
                    if on_card:
                        # the executor's stream may be another's, which may
                        # be capturing: take its lock, as the program does
                        with engine.stream_lock(ex.stream), \
                                torch.cuda.stream(ex.stream):
                            kept, kv = _served(tl.logits, tl.cache)
                            ex.stream.synchronize()
                    else:
                        kept, kv = _served(tl.logits, tl.cache)
                if ex.seed not in cap.inputs and tl.logits is not None:
                    cap.inputs[ex.seed] = (
                        prompt(ex.seed, ex.model_cfg.vocab,
                               tl.prompt.shape).reshape(-1).tolist(),
                        int(tl.token.reshape(-1)[0]))
                e = Execution(ex.spec.name, ex.seed, steps, rec, kept, kv,
                              cap.tracing, time.perf_counter())
                with cap._lock:
                    cap.execs.append(e)
                return rec
            return run

        self._patch(executors, "make_compiled_steps", compiled_steps)
        self._patch(engine.DecodeGraph, "step", graph_step)
        self._patch(engine.PrefillGraph, "run", graph_run)
        self._patch(executors.LiveExecutor, "execute", execute)

    def wrap_engine(self, engine) -> None:
        """Time ``engine.place_many`` (the instance's, not the class's)."""
        cap = self
        orig = engine.place_many

        def place_many(tasks, *a, **kw):
            with cap._range("pb.place_many"):
                t0 = time.perf_counter()
                out = orig(tasks, *a, **kw)
                dt = time.perf_counter() - t0
            with cap._lock:
                cap.place_s += dt
                cap.place_tasks += len(tasks)
            return out

        engine.place_many = place_many

    def uninstall(self) -> None:
        for owner, attr, own, orig in reversed(self._undo):
            if isinstance(owner, type) and own is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._undo = []

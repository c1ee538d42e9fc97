#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together: ``ssd_scan_bwd``, K6b, among
   them) and print the build seconds and the ptxas resource lines; count the tensor-core instructions
   (``HMMA``/``HGMMA``) per kernel in the built ``flash_attention`` and
   ``decode_attention`` libraries' SASS (``cuobjdump -sass``), failing if
   either bf16 kernel has none, and in ``flash_attention_bwd``'s, failing
   if K4b's bf16 dk/dv or dq kernel (``fa_bwd_dkdv_tc``, ``fa_bwd_dq_tc``)
   has none;
2. hold each kernel against its plain PyTorch version at the shapes its main
   path gives it: the GBRT kernels (K1 multi-config, K2 blocked; each a step
   table built on the card per call, then a lookup) bit-equal in float64 and
   in float32, on the first chunk's sizes and on an adversarial column of
   the same width (every break of the model, each break's two float
   neighbours, NaN, +-inf and +-0.0), each timed from a CUDA graph
   (``ms``, device time) and eagerly (``eager_ms``), with its bound for the
   table method's work (``bound_ms``) beside the old walk's
   (``walk_bound_ms``), K2's route per call, and for K1 the torch core's
   host-table route (``torch.searchsorted`` + ``torch.gather`` over the
   host's step tables, without their build) timed on the card
   (``table_route_ms``); the linear scan (K3) bit-equal in its
   exact-fold regime as the float64 surplus prefix of a 65,536-row chunk
   (65,537 rows with the seed), and within 5e-5 in its chunked regime in
   float32 at an RG-LRU shape (B=2, S=4096, D=1024) and at
   recurrentgemma-9b's (D=4096: its serving prefill, S=32, and S=4096);
   its row also records
   whether ``torch.cumsum`` gives the left fold's bits on that prefix
   (``library_bit_equal``, ``library_max_ulps``), the time of a one-thread
   chain of 65,537 dependent float64 adds in registers from the same
   library (``chain_floor_ms``, the exact fold's floor) and the RG-LRU
   shape's byte bound; the state replay bit-equal
   on a 65,536-row chunk of the stream (its plain version, a per-row loop,
   runs on CPU copies of the same inputs) under the walk's MinLatency codes
   and again under its MinCost codes (``min_cost_ms``), its row recording
   the time of a launch told that the walk overflowed (``skip_ms``), the
   chain floor
   (``state_replay_chain_floor``: one named-barrier hand-off of a float64
   per dispatch row of the largest config, ``chain_floor_ms``) and the
   launch's warps, segment rows, scanners per pool and shared memory as the
   library computes them (``state_replay_layout``), which the host's mirror
   must equal; and so the sequential decision
   walk, whose codes are the replay's input there as on the main path, once
   more on the same chunk under MinCost (``min_cost_ms``), its row also
   recording the chain floor (``state_walk_chain_floor``: R steps of one
   block barrier and a float64 handed from one thread to every warp,
   ``chain_floor_ms``) and the launch's warps, ring rows, scan split and
   shared memory as the library computes them (``state_walk_layout``),
   which the host's mirror of them must equal;
   flash attention (K4) at llama3.2-1b's prefill shape (q (1, 32, 32, 64),
   k/v (1, 8, 32, 64), causal) and at S=2048 (causal, and windowed), and at
   recurrentgemma-9b's (head_dim 256, 16 query heads on one KV head, window
   2048: its serving prefill, S=32, and S=4096 in bf16 and float32), and
   at hubert-xlarge's encoder attention, non-causal at head_dim 80 (q/k/v
   (8, 16, 781, 80) in bf16 and float32, also against ``attention_ref``,
   and (1, 16, 32768, 80) in bf16, whose plain version runs in blocks of
   1,024 query rows), and
   flash decode (K5) at llama's decode shape (k/v (1, 8, 32, 64), length
   33), at B=4, S=4096 with ragged lengths and one length above S, and at
   recurrentgemma-9b's (head_dim 256, one KV head: its 32-slot serving
   ring and a full 2,048-slot one, in bf16 and float32), and at the
   decoder's head_dim 128 (K4 at olmoe-1b-7b's prefill, q/k/v (1, 16, 32,
   128), and at internvl2-26b's, q (1, 48, 1056, 128) k/v (1, 8, 1056,
   128); K5 at olmoe's decode step, k/v (1, 16, 32, 128), length 33),
   and at llama3.2-1b's launch cells (K4 at prefill_32k's q/k/v (1, 32 /
   8, 32768, 64) causal in bf16, its plain version in blocks of 1,024
   query rows over the keys they see; K5 at decode_32k's 16 sequences
   over full 32,768-slot caches, k/v (16, 8, 32768, 64)), within 5e-5 in
   float32 and 3e-2 in bf16, K4 in bf16 also each output row within 2**-6
   of its largest |output|, which planted faults must exceed (hubert's:
   the last partial key tile left unmasked, a key tile dropped; llama's
   prefill_32k: a key tile below the diagonal dropped, the last query
   tile's diagonal tile unmasked) (the Griffin and head_dim-128 shapes also
   against the literal oracles ``attention_ref`` and
   ``decode_attention_ref`` within the same limits), K5 in bf16 also
   each (batch, head) row within 2**-6 of its largest |output| (``row_err``; two planted faults, a dropped
   split and one masked slot let through, must exceed that limit:
   ``fault_row_err``), its row recording the split count at each
   shape (``nsplit``, ``chunk``); the SSD scan (K6) in bf16 and float32 on the
   inputs mamba2-780m's first layer gives it at full width, at the serving
   prefill (x (1, 48, 32, 64), B/C (1, 32, 128), one chunk), at S=300 (3
   chunks of 128, the last padded) and at b=2, S=4096 (32 chunks), y within
   1e-4 in float32 and within 3e-2 of max(1, |y|) in bf16, in bf16 also
   each (batch, head) row of y within 2**-6 of its largest |y|
   (``row_err``) and the mean error within 2**-12 of the mean |y|
   (``mean_err``; three planted faults, scores x from the hi bf16 term
   alone, a dropped diagonal score tile and a zeroed head group, must each
   exceed one of the two: ``fault_row_err``), the float32 state within
   1e-4, and at S=300 in float32 also against the literal oracle
   ``ssd_ref`` within the CPU plain version's own gap to it plus 1e-4;
   each shape records its route (one launch, or the three chunk-parallel
   ones) and its bound, in bf16 every product at the bf16 tensor-core rate
   (the products with a float32 operand three times, one per bf16 term),
   in float32 all at the float32 rate. Kernel, plain and
   library times come from CUDA events
   (the plain CPU runs of walk and replay from the host clock); the
   attention and SSD rows time each call from a CUDA graph of many calls
   (device time, without the host's launch overhead, which ``eager_ms``
   keeps); the attention rows' library call is
   ``F.scaled_dot_product_attention``, and no single PyTorch call computes
   the SSD scan;
3. serve the placement stream — the STT app on 4 Lambda memory configs and a
   3-device edge fleet (speeds 1.0/1.0/0.6, least-predicted-wait balancer),
   262,144 bursty tasks in chunks of 65,536 — through
   ``PlacementRuntime.serve_stream(array_backend="torch")`` on the card under
   ``MinLatencyPolicy(c_max=2.97e-5, alpha=0.02)`` and
   ``MinCostPolicy(deadline_ms=250)``, each held against the port's numpy
   oracle run with ``device="cpu"`` (target codes and cold/feasible flags
   identical, floats within 1e-9), and the MinCost stream once more with
   ``array_backend="numpy"`` on the card (its host prediction pass runs K2,
   once per config and chunk, on its table route), which must be identical
   to the oracle; K1 runs once per chunk. Every kernel's launch count is
   zeroed just before the run that drives it and read just after; each must
   be > 0, the fallback-chunk count 0, and the residency counters clean;
3b. the what-if planner's path (``plan``; each part logs its seconds,
   tasks/s, launches and verdict): (a) serve the MinLatency stream once more
   on the card with ``keep_inputs=True`` (floats within 1e-9 of phase 3's
   oracle), ``capture`` it with its observed latencies, round-trip the
   trace through JSONL and NPZ (each ``equal``) and replay it through
   ``serve_stream(TraceWorkload(trace).chunks(65_536))``: bit-identical to
   the card stream; (b) record IR, FD and STT, 262,144 Poisson arrivals
   each (``twin.poisson(seed=3)``; the reference bench serves 500,000 per
   app), merge them, and evaluate one candidate (the fleet above, MinLatency
   as in phase 3) through ``Planner.evaluate`` in sequential, thread and
   spawned-process mode: per-shard records identical across the modes, each
   shard K1 once per chunk and at least one walk, replay and linear scan;
   (c) the 8 candidates of ``bench_runtime.run_trace_planner`` (1-4
   devices x edge-only / mixed) in a halving search (3 rungs, the smallest
   2,048) over (b)'s STT trace, in threads, SLO 95% within 40 s: the winner
   meets it, is verified on the full trace and is the cheapest that meets
   it (over (a)'s bursty trace no candidate meets it); (d) the same 8 as a
   grid over (a)'s first 16,384 tasks on the card and with the numpy
   oracle on the CPU: ranking, n and attainment identical, floats within
   1e-9; (e) FD, 65,536 tasks in chunks of 16,384, under the faults of
   ``examples/chaos_serve.py`` (``edge1`` out from 35% to 65% of the span,
   15% transient errors on config 1792) with retries and a breaker, on the
   card against the numpy oracle (decisions and retries identical, floats
   within 1e-9), then captured with its ``FaultSpec`` and replayed with
   ``fault_spec_of``: bit-identical;
4. build llama3.2-1b (16 layers, d_model 2048, 1.5 B parameters), then
   mamba2-780m (48 layers, d_model 1536, 857 M parameters), then
   recurrentgemma-9b (d_model 4096, 10.4 B parameters; here cut to 5 of
   its 38 layers, one (rec, rec, attn) group and the (rec, rec) tail) at
   full width on the card from a seeded generator, in float32, and a CPU
   copy of the same weights; run a (1, 32) prefill and 8 teacher-forced
   decode steps (llama's past its cache, through the reference's clamped
   write; recurrentgemma's wrapping its 32-slot ring) on both, and hold the
   card's logits and cache (K3, K4, K5, K6, cuBLAS) to the CPU's (plain
   versions) within ``FULL_WIDTH_TOL``; for mamba2-780m also a 300-token
   prefill (3 chunks, the last padded) within ``SSM_LONG_TOL``, for
   recurrentgemma-9b a 2,304-token one (past its window) within
   ``FULL_WIDTH_TOL``; then, in bf16 at full depth as an executor serves
   each model, hold a decode step replayed from its CUDA graph to the
   eager step (bit-equal over 8 steps) and the prefill replayed from its
   CUDA graph to the eager prefill (logits and every cache tensor
   bit-equal, on two prompts), and time prefill (eager and graph) and
   decode; the same for olmoe-1b-7b (64 experts, top-8; float32 at full
   width and 2 of its 16 layers, where the card must also route as the
   CPU does: the same experts chosen and the same assignments kept for
   every token of every layer and step, the smallest top-k margin printed;
   bf16 at full depth), then llama3.2-1b with the int8 KV cache in bf16
   at full depth (logits over 8 decode steps within 2% of the
   unquantized model's scale on the same weights, the prefill and decode
   graphs bit-equal to the eager steps, the int8 K/V and scales
   included), then internvl2-26b (float32 at full width and 2 of its 48
   layers, card vs CPU, a prefill of 1,024 vision embeddings and 32
   tokens and 8 decode steps; one bf16 eager prefill with the vision
   prefix at full depth, 37.0 GiB of weights: time, peak memory, finite
   logits); then hubert-xlarge, the audio encoder (945 M parameters,
   non-causal attention at head_dim 80): float32 at full width and 2 of
   its 48 layers, card vs CPU, one (1, 256) batch of frames masked at its
   ``mask_prob``: encode logits, loss and every gradient within
   ``FULL_WIDTH_TOL`` (K4 once a layer); then bf16 at full depth as
   ``make_compiled_steps`` holds it, an encode at (B, S) = (8, 781) and at
   (1, 32768) through its prefill step, each with K4 48 launches, finite
   float32 logits, its median ms and the peak memory;
5. serve live, for each of the four models: calibrate the slice catalog at
   full width (slices of 2, 4 and 8 chips; of 4 and 8 for
   recurrentgemma-9b, of which three executors fit on the card; 8 tasks, 1
   cold start each) and serve 48 Poisson requests (20/s, 96 tokens on
   average) under ``MinLatencyPolicy(c_max=0.004, alpha=0.02)`` through
   ``make_live_runtime(...).serve`` on the card. Every task must be served
   and none fail or be shed, the peak allocated memory must stay under 90%
   of the card, and the model's kernels (counts zeroed just before the
   serve, read just after, with the graphs' replays) must have launched:
   K4 and K5 for llama3.2-1b, whose prefill graphs replay K4 and decode
   graphs K5, ``n_layers`` launches each; K6 for mamba2-780m, whose prefill
   graphs replay it ``n_layers`` times and decode graphs no kernel of the
   port; K3, K4 and K5 for recurrentgemma-9b, whose prefill graphs replay
   K3 once per recurrent layer and K4 once per attention layer, and decode
   graphs K5 once per attention layer; K4 and K5 for olmoe-1b-7b (slices
   of 2, 4 and 8), as for llama3.2-1b;
6. launch K4 in float32 100 times at its card test's first case,
   (1, 32, 32, 8, 64) causal, after the live serves in this process: every
   output must have the same bits (recorded in K4's row with each side's
   distance from a float64 softmax);
7. train (the training slice): K4b (``flash_attention_bwd``), fed the
   row log-sum-exp K4 writes (itself held to the plain version's within
   ``LSE_TOL``), against its plain version at llama3.2-1b's training
   attention (q (2, 32, 2048, 64), 8 KV heads, causal) and
   recurrentgemma-9b's (q (1, 16, 4096, 256), one KV head, window 2048),
   each in bf16 and float32: float32 within 5e-5 of max(1, |grad|), bf16
   each row within 2^-6 of its largest |grad|, and three planted faults
   (``delta`` dropped, the window's edge off by one, one GQA head left out
   of dK) must each break the bf16 limit; its time, achieved TFLOP/s (the
   five products of the work, ``tflops``, and the seven it runs,
   ``run_tflops``), its head split, its plain version's time, SDPA's
   forward + backward
   less its forward (``library_ms``) and its bound (the recompute of S and
   four products). Then one float32 training step of llama3.2-1b at full
   width and 2 layers on the card against the CPU (loss, global grad norm,
   every gradient, the AdamW update); the slice, llama3.2-1b at full width
   and depth trained 10 steps through ``train()`` in bf16 with float32
   master parameters and ``remat="full"`` at B=2, S=2048 (K4 32 and K4b 16
   launches a step, losses finite; median step ms, tokens/s, peak memory,
   one step's device time by kind of kernel, K4b's by kernel); and on the
   ``examples/train_100m_torch.py`` configuration two runs from one seed
   (equal losses) and a run killed at step 6 and restarted from its
   checkpoint (within rtol 1e-5 of the uninterrupted run), whose last
   checkpoint ``elastic_restore`` places on the card's host mesh (each
   parameter and moment a DTensor with its logical axes' placements, its
   local tensor bit-equal to ``restore_latest``'s). Beside K4b:
   K3b (``linear_scan_bwd``) against its plain version at
   recurrentgemma-9b's training recurrence ((1, 4096, 4096) float32) within
   5e-5 of max(1, |grad|), two planted faults (the final state's seed
   dropped, a read unshifted) outside it; K6b (``ssd_scan_bwd``) at
   mamba2-780m's first layer's inputs at B=2, S=2048 (16 chunks), fed K6's
   workspace of chunk states, float32 within 1e-4 of max(1, |grad|), bf16
   rows within 2^-6 of their largest |grad| and three planted faults (the
   reverse sum of dcum dropped, the carry from the next chunk dropped, one
   head left out of dB) outside it; each run twice, bit-equal, timed with
   its plain version and bound. Float32 steps of mamba2-780m (2 layers,
   S=256) and recurrentgemma-9b (3 layers, S=160) at full width, card vs
   CPU, held as llama's. Two more slices through ``train()``, bf16 on
   float32 masters, remat "full", 10 steps: mamba2-780m at full width and
   depth, B=2, S=2048 (K6 96 and K6b 48 launches a step), and
   recurrentgemma-9b at full width cut to 3 layers (one (rec, rec, attn)
   group), B=1, S=4096 (K3 4, K3b 2, K4 2, K4b 1 a step); olmoe-1b-7b at
   full width cut to 4 of its 16 layers, B=2, S=2048 (K4 8 and K4b 4 a
   step; beside it K4b at its training attention, q/k/v (2, 16, 2048,
   128), and a float32 step of 2 layers, card vs CPU, the aux loss
   included); hubert-xlarge at full width and depth, B=8, S=781 (K4 96
   and K4b 48 a step; beside it K4b at its attention, q/k/v (8, 16, 781,
   80) non-causal, bf16 with the planted faults and float32, and a float32
   step of 2 layers, card vs CPU, S=256); every slice's
   losses finite and falling and its peak allocated memory under 90% of
   the card. This phase reads its launches from ``kernels.recording()``
   blocks around each step (the float32 steps, the slices' 10 steps and
   each profiled step), which see the backward kernels and the remat's
   forward kernels though autograd launches them on its own device thread;
7b. the launch layer (``launch``): llama3.2-1b's train_4k, prefill_32k
   and decode_32k cells built by ``launch.steps.build_cell`` on the host
   mesh (``make_host_mesh``: the card as a (1, 1) ("data", "model") mesh
   on a one-process group) at full width, their peaks reckoned by
   ``analyze_cell`` (train_4k would drop to batch 1 past 90% of the
   card), materialized at global batches 2, 1 and 16 (cut from 256, 32
   and 128; printed) and each run once with no context to warm it, then
   5 times under ``sharding_ctx(mesh, cell.rules)`` and 5 times with no
   context, in turn, on arguments materialized anew each run: every
   run's outputs bit-equal to the first's (the train cell's loss and
   updated parameters, the serving cells' logits and caches), K4 32 and
   K4b 16, K4 16, K5 16 launches a run; a line per cell with its median
   step ms on CUDA events and every run's, beside the card,
   ``analyze_cell``'s FLOPs at that batch and the achieved TFLOP/s at the
   median; meanwhile ``python -m
   repro_torch.launch.dryrun --arch llama3.2-1b --mesh both`` runs in a
   subprocess on the CPU (256- and 512-device fake meshes), which must
   exit 0, its rows printed;
7c. the documented entry points (``examples``): each of the nine
   ``examples/<name>_torch.py`` counterparts of the reference's examples,
   its ``run(device=...)`` called in this process at the reference's sizes
   (quickstart, placement_sim, fleet_sim: the twin on host numpy;
   resident_serve: 2,000 bursty tasks in 512-row chunks through
   ``array_backend="torch"`` (K1, K3, the walk, the replay), which must
   make the numpy oracle's decisions with floats within 1e-9, then a
   3-chunk resident stream and its continuation; multi_app_serve and
   plan_capacity: K2 on 16,384- and 8,192-row chunks, the planner's halving
   search on the torch core; chaos_serve; serve_placement: the smoke-size
   llama3.2-1b live; async_serve: its live part on the full-width
   llama3.2-1b (in place of the reference's 32-wide toy), ``serve`` and
   ``serve_async`` over 3 edge executors and slices s2 and s8, 60 requests
   at 2000/s, every one served and none failed, then the twin parity on
   5,000 bursty tasks), each line with its seconds, its headline numbers,
   its launches and its graphs' replays (counts zeroed just before each
   example); K1, K2, K3, K4, K5, the walk and the replay must each launch
   in the phase;
8. print the card's name and power limit, one ``{"kernels": [...]}`` JSON
   line (K1-K6, K3b, K4b, K6b, walk and replay), and as the last line
   ``{"ok": true, "device": {...}}``.

A kernel's ``launches`` are its wrapper's count over its main paths' runs
(the placement stream, the encoder's two recorded encodes, the live serves,
the training slices, the launch cells and the examples): the calls that
launched it (or recorded it into a CUDA graph at a capture). The launches
that prefill and decode graph replays run are counted apart, as
``graph_replayed``, from the graphs' own tally
(``serving.engine.replayed_launches``). ``examples_launches`` and
``examples_graph_replayed`` are the examples phase's share of each. Both
counts add up every path's calls at that path's own shapes: K4's and K5's
take in each live serve's model at its own width and depth and
serve_placement's 64-wide smoke-size llama3.2-1b (most of K5's graph
replays), while a row's times and bound are those of the shapes it names.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIGS = (1280, 1536, 1792, 2048)
FLEET = {"edge0": 1.0, "edge1": 1.0, "edge2": 0.6}
N_TASKS, CHUNK = 262_144, 65_536
C_MAX, ALPHA, DEADLINE_MS = 2.97e-5, 0.02, 250.0
FLOAT_TOL = 1e-9
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the float64 / float32 vector
# rates (no tensor cores) and the dense bf16 tensor-core rate, at the full
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12}
ATTN_TOL = {"float32": 5e-5, "bfloat16": 3e-2}
# K5 in bf16 is also held per (batch, head) row: the row's largest error
# within DEC_ROW_TOL of its largest |output| (2 to 4 bf16 ulps of it). A
# decode output has std sqrt(e / length) for N(0, 1) inputs at D = 64, near
# 0.03 at long caches, where 3e-2 alone is about one typical output; the
# planted faults in fd_case show that this limit sees a dropped split
DEC_ROW_TOL = 2.0 ** -6
# K6 vs its plain version: float32 y within 1e-4; bf16 y within 3e-2 of
# max(1, |y|) (an absolute bound up to |y| = 1, a relative one above: the
# model's y reaches 27-52, where one bf16 ulp exceeds 3e-2); the float32
# state within SSD_STATE_TOL
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
SSD_STATE_TOL = 1e-4
# K6's bf16 y is also held against its own scale: each (batch, head) row's
# largest error within SSD_ROW_TOL of the row's largest |y| (2 to 4 bf16
# ulps of it, as K5), and the mean error over y within SSD_MEAN_TOL of the
# mean |y|. A sound kernel differs from the plain version only where their
# float32 sums round to different bf16 neighbours, a few elements in a
# thousand; a kernel that took scores x from the hi bf16 term alone moves
# most elements by about one ulp (a mean error of 1.5e-3 of the mean |y|,
# 6x SSD_MEAN_TOL, on the CPU: tests/test_torch_ssm.py), which no limit on
# the largest error can tell from one rounding flip at a row's largest |y|.
# The planted faults of ssd_faults show that the two limits see each fault
SSD_ROW_TOL = 2.0 ** -6
SSD_MEAN_TOL = 2.0 ** -12
# card (K4, K5, K6, cuBLAS in float32, TF32 off) vs CPU logits and caches of
# the full-width models in float32: summation order differs across 16 / 48
# layers. For the 300-token Mamba prefill the CPU's own chunked SSD lies
# 1.9e-4 from the literal recurrence in y (tests/test_torch_ssm.py::
# test_chunked_ssd_gap_at_full_width_head_shape), above 1e-4: there the
# tolerance is that gap with a 2.6x margin.
FULL_WIDTH_TOL = 1e-4
SSM_LONG_TOL = 5e-4
# phase 3b (plan): the what-if planner's path. (b) serves three 262,144-task
# apps (the reference bench, benchmarks/bench_runtime.py:626, serves 500,000
# per app: cut to phase 3's stream size for the run's time); (d) holds the
# card's planner to the numpy oracle on a prefix (the full-size oracle would
# take minutes at ~4,000 tasks/s); (e) serves FD under the chaos example's
# faults (examples/chaos_serve.py)
PLAN_APPS, N_SHARD, N_ORACLE, N_FAULT = ("IR", "FD", "STT"), 262_144, 16_384, \
    65_536
FAULT_CHUNK = 16_384
PLAN_SLO_MS, PLAN_SLO_TARGET, PLAN_RATE = 40_000.0, 0.95, 0.05
ARCH, SSM_ARCH = "llama3.2-1b", "mamba2-780m"
PROMPT_LEN, DECODE_STEPS, SSM_LONG_PROMPT = 32, 8, 300
# recurrentgemma-9b (10.4 B parameters): its float32 card-vs-CPU check runs
# at full width with the depth cut to 5 layers, one (rec, rec, attn) group
# and the (rec, rec) tail (41.8 GB of float32 weights at full depth would
# sit on the card and again on the host); its long prefill (past the
# 2,048-token window: the mask bites and the ring rolls by 256) is held to
# FULL_WIDTH_TOL as the short one is: the last token's arithmetic differs
# from a short prompt's only in the window's 2,048 keys and in the length
# of the recurrence, whose rounding errors decay with a < 1. Its bf16
# checks and its live serve run all 38 layers. A bf16 executor holds 19.1
# GB of bf16 and 3.5 GB of float32 weights, so at most three fit under the
# live serve's 90% memory limit: it serves two cloud slices and the edge
HYBRID_ARCH, HYBRID_DEPTH, HYBRID_LONG_PROMPT = "recurrentgemma-9b", 5, 2304
WINDOW = 2048  # recurrentgemma-9b's local-attention window
# olmoe-1b-7b (64 experts, top-8; 6.92 B parameters, 12.9 GiB an executor
# in bf16): its float32 card-vs-CPU check runs at full width and 2 of its
# 16 layers (every prefill and decode step runs the expert products over
# all 64 experts x 40 slots, which makes the CPU's side slow at full
# depth), the routing held equal too; its bf16 checks, its live serve and
# its training slice's width are full. internvl2-26b: float32 at full
# width and 2 of 48 layers with its 1,024-embedding vision prefix and 32
# tokens, then one bf16 eager prefill at full depth (37.0 GiB of weights)
MOE_ARCH, MOE_DEPTH = "olmoe-1b-7b", 2
VLM_ARCH, VLM_DEPTH = "internvl2-26b", 2
# llama3.2-1b with the int8 KV cache, bf16: the logits over 8 decode steps
# within KV_QUANT_TOL of the unquantized model's largest |logit| (the
# reference's tests/test_perf_knobs.py::test_kv_quant_decode_close)
KV_QUANT_TOL = 0.02
LIVE_SLICES = {ARCH: (2, 4, 8), SSM_ARCH: (2, 4, 8), HYBRID_ARCH: (4, 8),
               MOE_ARCH: (2, 4, 8)}
LIVE_C_MAX, LIVE_ALPHA = 0.004, 0.02
# the kernels each arch's live serve must launch (eagerly or from a graph)
LIVE_KERNELS = {ARCH: ("flash_attention", "decode_attention"),
                SSM_ARCH: ("ssd_scan",),
                HYBRID_ARCH: ("linear_scan", "flash_attention",
                              "decode_attention"),
                MOE_ARCH: ("flash_attention", "decode_attention")}

# phase 7 (train): K4b at llama3.2-1b's training attention and at
# recurrentgemma-9b's (B, H, Hkv, S, D). Float32 gradients within
# K4B_F32_TOL of max(1, |plain|) (the reference's float32 kernel tolerance);
# bf16 ones per row within K4B_ROW_TOL of the row's largest |grad| (the
# K5/K6 rule: 2 to 4 bf16 ulps of it), that scale floored at K4B_ROW_FLOOR
# of the tensor's largest |grad| for the rows whose exact gradient is 0
# (the first causal query's dq: float32 noise on both sides)
TRAIN_ATTN, GRIFFIN_ATTN = (2, 32, 8, 2048, 64), (1, 16, 1, 4096, 256)
K4B_F32_TOL, K4B_ROW_TOL, K4B_ROW_FLOOR = 5e-5, 2.0 ** -6, 2.0 ** -12
# K4's row log-sum-exp (natural log of the scaled scores) against the plain
# version's on the same inputs: both float32 over the same float32 scores
# (bf16 operands are exact in float32), differing in summation order and
# K4's exp2 approximation (2 ulp) over at most a few thousand terms, and
# in the bf16 kernel's log2-unit running max; lse is ~1-20 here, where
# float32 rounds at ~1e-6
LSE_TOL = 1e-4
# (b) the float32 step of llama3.2-1b at full width, cut to 2 layers (the
# CPU's step at full depth would take minutes), card vs CPU: loss and
# global grad norm within FULL_WIDTH_TOL, every gradient's max |diff|
# within STEP_GRAD_TOL of its max |grad| (summation order differs: cuBLAS,
# K4/K4b against the CPU's matmuls and plain versions); the card's AdamW
# update within ADAMW_TOL of the CPU's on the card's gradients (lr 1e-3)
STEP_LAYERS, STEP_B, STEP_S = 2, 1, 128
STEP_GRAD_TOL, ADAMW_TOL = 1e-4, 1e-6
# (c) the slice: llama3.2-1b at full width and depth, B=2, S=2048 (two
# 1,024-token loss chunks), 10 steps
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 10
# (a') K3b at recurrentgemma-9b's training recurrence (B, S, d_rnn) and K6b
# at mamba2-780m's layer inputs at its slice's (B, S), against their plain
# versions: float32 gradients within K3B_TOL (K3's own forward limit) and
# K6B_TOL (K6's float32 limit) of max(1, |grad|), element by element (K6b's
# sums over the scores, dcum and dA run in float64 on both sides, so the
# terms that cancel do so exactly); bf16 (K6b) each row within K4B_ROW_TOL
# of its largest |grad|, floored as K4b's; planted faults must break them:
# K3b's the float32 limit, K6b's the bf16 row limit
K3B_SHAPE = (1, 4096, 4096)
K3B_TOL, K6B_TOL = 5e-5, 1e-4
# (b') the float32 steps of mamba2-780m (2 layers) and recurrentgemma-9b
# (3 layers: one (rec, rec, attn) group) at full width, card vs CPU, held as
# llama's: S spans 2 chunks of K6 (128 rows) and of K3 (128 rows)
SSM_STEP_LAYERS, SSM_STEP_S = 2, 256
HYBRID_STEP_LAYERS, HYBRID_STEP_S = 3, 160
# (c') the slices: mamba2-780m at full width and depth, B=2, S=2048 (16 K6
# chunks of 128); recurrentgemma-9b at full width cut to 3 layers (its 38
# would take 155.6 GiB of float32 masters, gradients and moments; 3 take
# 41.0 GiB, 2.10 B of its 2.75 B parameters in the embedding and
# unembedding), B=1, S=4096 (past the 2,048 window). Each 10 steps, peak
# allocated memory under PEAK_FRACTION of the card
SSM_TRAIN_B, SSM_TRAIN_S = 2, 2048
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_B, HYBRID_TRAIN_S = 3, 1, 4096
# olmoe-1b-7b at full width cut to 4 of its 16 layers (1.88 B parameters:
# 30 GiB of float32 masters, gradients and moments; all 16 would take
# ~111 GB), B=2, S=2048; K4b at its training attention (B, H, Hkv, S, D):
# head_dim 128, multi-head
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S = 4, 2, 2048
MOE_ATTN = (2, 16, 16, 2048, 128)
PEAK_FRACTION = 0.9
# hubert-xlarge, the audio encoder (945 M parameters, head_dim 80, its
# attention non-causal): HuBERT's pretraining crops of 250,000 samples at
# 16 kHz through the 320x frontend stub are 781 frames; prefill_32k's
# sequence is 32,768 frames (its batch of 32 cut to 1). Phase 4: float32 at
# full width and AUDIO_DEPTH of 48 layers, card vs CPU, on one (1, AUDIO_S)
# batch masked at the config's mask_prob; bf16 encodes at full depth of
# each (B, S) of AUDIO_ENCODES. K4 and K4b at its attention (B, H, Hkv, S,
# D): phases 2 and 7. Phase 7: a float32 step of AUDIO_DEPTH layers, card
# vs CPU, and the slice at full width and depth, (B, S) = (8, 781)
AUDIO_ARCH, AUDIO_DEPTH, AUDIO_S = "hubert-xlarge", 2, 256
AUDIO_ENCODES = ((8, 781), (1, 32_768))
AUDIO_ATTN, AUDIO_LONG_ATTN = (8, 16, 16, 781, 80), (1, 16, 16, 32_768, 80)
# llama3.2-1b's prefill_32k attention (B, H, Hkv, S, D) at batch 1, and its
# decode_32k step (B, H, Hkv, 1, S, D) at batch 16
LLAMA_LONG_ATTN = (1, 32, 8, 32_768, 64)
LLAMA_DECODE_32K = (16, 32, 8, 1, 32_768, 64)
AUDIO_TRAIN_B, AUDIO_TRAIN_S = 8, 781

DECISION_COLS = ("predicted_cold", "feasible")
FLOAT_COLS = ("predicted_latency_ms", "predicted_cost", "allowed_cost")
ALL_COLS = FLOAT_COLS + DECISION_COLS + (
    "actual_latency_ms", "actual_cost", "actual_cold", "completion_ms",
    "queue_wait_ms", "exec_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not in this directory ({e})",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build, sass = timed("build", phase_build)
    ctx = timed("stream", make_stream)
    rows = timed("kernels", phase_kernels, ctx, dev)
    rows += timed("attention", phase_attention, dev)
    rows += timed("ssd", phase_ssd, dev)
    serve = timed("serve", phase_serve, ctx, dev)
    timed("plan", phase_plan, ctx, dev, serve["oracle"])
    timed("model", phase_model, dev, ARCH)
    timed("model ssm", phase_model, dev, SSM_ARCH, SSM_LONG_PROMPT,
          SSM_LONG_TOL)
    timed("model hybrid", phase_model, dev, HYBRID_ARCH, HYBRID_LONG_PROMPT,
          FULL_WIDTH_TOL, HYBRID_DEPTH)
    timed("model moe", phase_model, dev, MOE_ARCH, 0, FULL_WIDTH_TOL,
          MOE_DEPTH)
    timed("model kv_quant", phase_kv_quant, dev)
    timed("model vlm", phase_vlm, dev)
    audio = timed("model audio", phase_audio, dev)
    lives = [timed("live", phase_live, dev, ARCH),
             timed("live ssm", phase_live, dev, SSM_ARCH),
             timed("live hybrid", phase_live, dev, HYBRID_ARCH),
             timed("live moe", phase_live, dev, MOE_ARCH)]
    repeat = timed("k4 f32 repeat", fa_f32_repeat, dev)
    trained = timed("train", phase_train, dev, card)
    rows += trained["rows"]
    launched = timed("launch", phase_launch, dev, card)
    examples = timed("examples", phase_examples, dev, card)
    # each kernel's launches over its main paths' runs: the placement
    # stream's, the encoder's encodes, every live serve's, the training
    # slices', the launch cells' and the examples' (counts zeroed before
    # each; the live serves and the examples also count graph replays)
    launches = dict(serve["launches"])
    for path in (audio, trained, launched):
        for name, n in path["launches"].items():
            launches[name] = launches.get(name, 0) + n
    replayed = {}
    for live in lives + [examples]:
        for name, n in live["launches"].items():
            launches[name] = launches.get(name, 0) + n
        for name, n in live["graph_replayed"].items():
            replayed[name] = replayed.get(name, 0) + n
    for row in rows:
        if row["name"] in sass:
            row["tensor_core_instructions"] = sass[row["name"]]
        row["launches"] = launches[row["name"]]
        row["examples_launches"] = examples["launches"].get(row["name"], 0)
        row["examples_graph_replayed"] = \
            examples["graph_replayed"].get(row["name"], 0)
        row["graph_replayed"] = replayed.get(row["name"], 0)
        if row["name"] == "flash_attention":
            row.update(repeat)
        if row["launches"] + row["graph_replayed"] <= 0:
            fail(f"{row['name']} was never launched on its main path")
    log(f"build seconds: {json.dumps(build)}")
    log(f"total seconds: {time.perf_counter() - t_start:.1f}")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------------------------------ phase 1
def phase_build() -> tuple[dict, dict]:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(report)} libraries in {secs:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if re.search(r"Used \d+ registers|Compiling entry|spill", line):
                log(f"[build] {name}: {line.strip()}")
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = {}
    for lib, tc_kernels in (("flash_attention", ("fa_tc_kernel",)),
                            ("decode_attention", ("dec_tc_kernel",)),
                            ("flash_attention_bwd", ("fa_bwd_dkdv_tc",
                                                     "fa_bwd_dq_tc"))):
        sass[lib] = tensor_core_counts(_build.lib_path(lib), cuobjdump)
        log(f"[build] {lib} tensor-core instructions per kernel: "
            f"{json.dumps(sass[lib])}")
        for tc_kernel in tc_kernels:
            tc = {k: n for k, n in sass[lib].items() if tc_kernel in k}
            if not tc or min(tc.values()) <= 0:
                fail(f"the bf16 {lib} kernel {tc_kernel} runs no "
                     f"tensor-core instruction: {sass[lib]}")
    return ({"total": round(secs, 2),
             **{n: round(r["seconds"], 2) for n, r in report.items()}}, sass)


def tensor_core_counts(lib: Path, cuobjdump: Path) -> dict[str, int]:
    """``HMMA``/``HGMMA`` instructions per kernel (demangled name) in the
    SASS of a built library."""
    exe = str(cuobjdump) if cuobjdump.is_file() else "cuobjdump"
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    names = list(counts)
    demangled = names
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        demangled = out if len(out) == len(names) else names
    short = (re.sub(r"^void |\(anonymous namespace\)::", "", d).split("(")[0]
             for d in demangled)
    return {d: counts[n] for n, d in zip(names, short)}


# ------------------------------------------------------------ the stream
def make_stream() -> dict:
    from repro_torch.core.fit import fit_app
    from repro_torch.core.workload import BurstyWorkload

    t0 = time.perf_counter()
    twin, models = fit_app("STT", seed=0, n_inputs=120, configs=CONFIGS)
    wl = BurstyWorkload(rate_per_s=40.0, size_sampler=twin.sample_input,
                        burst_multiplier=6.0, mean_quiet_s=15.0,
                        mean_burst_s=6.0, seed=7)
    chunks = list(wl.chunks(N_TASKS, CHUNK))
    log(f"[stream] fitted models and {N_TASKS} tasks in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"twin": twin, "models": models, "chunks": chunks}


def runtime(ctx, policy, device):
    from repro_torch.core.decision import DecisionEngine
    from repro_torch.core.fit import build_fleet_predictor
    from repro_torch.core.runtime import PlacementRuntime, TwinBackend

    pred = build_fleet_predictor(ctx["models"], dict(FLEET), configs=CONFIGS)
    eng = DecisionEngine(predictor=pred, policy=policy, device=device)
    backend = TwinBackend(ctx["twin"], seed=0, edge_names=tuple(FLEET),
                          edge_speed=FLEET)
    return PlacementRuntime(eng, backend)


# ------------------------------------------------------------------ phase 2
def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's per-call launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, as graph capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    ms = cuda_ms(g.replay, 3) / reps
    del g
    return ms


def kernel_device_us(fn, reps: int = 50) -> dict[str, float]:
    """Device microseconds per call of each CUDA kernel that ``fn``
    launches, by kernel name, from ``torch.profiler`` over ``reps``
    calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0.0)
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            out[name.split("(")[0].split("<")[0]] = us / reps
    if not out:
        fail("torch.profiler recorded no device time")
    return out


def max_ulps(a, b) -> int:
    """Largest distance in units in the last place between two float64
    tensors (signed values mapped onto one ordered integer line)."""
    import numpy as np

    ia, ib = (t.detach().cpu().numpy().view(np.int64) for t in (a, b))
    lo = np.int64(-2**63)
    ka, kb = (np.where(i < 0, lo - i, i) for i in (ia, ib))
    return int(np.abs(ka - kb).max()) if ka.size else 0


def chain_floor_ms(n: int, dev) -> float:
    """Time of one thread adding a float64 step n times, each add waiting on
    the last, in registers (``linear_scan_chain_floor``, built in the
    linear-scan library): the floor of an exact fold over n rows."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty(1, dtype=torch.float64, device=dev)
    fn = _build.function("linear_scan", "linear_scan_chain_floor",
                         [_build.P, _build.F64, _build.I32, _build.P])

    def run():
        _build.check(fn(_build.ptr(out), 1e-9, n, _build.stream_of(out)),
                     "linear_scan_chain_floor")

    ms = cuda_ms(run, 20)
    if abs(float(out) - n * 1e-9) > 1e-6 * n * 1e-9:
        fail(f"the chain floor's sum {float(out)} is not {n} x 1e-9")
    return ms


def walk_chain_floor_ms(n: int, warps: int, dev) -> float:
    """Time of n dependent steps of one block of ``warps`` warps, each step
    one block barrier and a float64 that one thread writes to shared memory
    and every warp reads and folds (``state_walk_chain_floor``, built in the
    state-replay library): the floor of the walk's R-row chain."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty(1 + warps, dtype=torch.float64, device=dev)
    fn = _build.function("state_replay", "state_walk_chain_floor",
                         [_build.P, _build.F64, _build.I32, _build.I32,
                          _build.P])

    def run():
        _build.check(fn(_build.ptr(out), 1e-9, n, warps,
                        _build.stream_of(out)), "state_walk_chain_floor")

    ms = cuda_ms(run, 5)
    if abs(float(out[0]) - n * 1e-9) > 1e-6 * n * 1e-9:
        fail(f"the walk's chain floor ends at {float(out[0])}, not {n} x 1e-9")
    return ms


def replay_chain_floor_ms(steps: int, warps: int, dev) -> float:
    """Time of ``steps`` hand-offs of a float64 from one thread to every
    warp of a ``warps``-warp group, one named barrier each
    (``state_replay_chain_floor``): the floor of the replay's chain of a
    config's dispatch rows."""
    import torch

    from repro_torch.kernels import _build

    out = torch.empty(1 + warps, dtype=torch.float64, device=dev)
    fn = _build.function("state_replay", "state_replay_chain_floor",
                         [_build.P, _build.F64, _build.I32, _build.I32,
                          _build.P])

    def run():
        _build.check(fn(_build.ptr(out), 1e-9, steps, warps,
                        _build.stream_of(out)), "state_replay_chain_floor")

    ms = cuda_ms(run, 5)
    if abs(float(out[0]) - steps * 1e-9) > 1e-6 * steps * 1e-9:
        fail(f"the replay's chain floor ends at {float(out[0])}, not "
             f"{steps} x 1e-9")
    return ms


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    import torch

    return float((a.double().cpu() - b.double().cpu()).abs().max()) \
        if a.numel() else 0.0


def bits_equal(a, b) -> bool:
    """Bit-identical tensors, on any devices (float ones compared as their
    bits, so -0.0 differs from +0.0 and NaN equals a NaN of the same bits),
    on ``a``'s device, 2^28 elements at a time (``torch.equal`` holds a
    bool tensor of its inputs' size)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.detach().contiguous(), b.detach().to(a.device).contiguous()
    ints = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    a, b, n = a.reshape(-1), b.reshape(-1), 1 << 28
    return all(torch.equal(a[i:i + n], b[i:i + n])
               for i in range(0, a.numel(), n))


def search_steps(n: int) -> int:
    """Compares of a binary search over n sorted values, the last one
    aside: ceil(log2 n)."""
    return max(n - 1, 0).bit_length()


def adversarial(breaks, fill, npd, rng):
    """A numpy column of ``len(fill)`` values of dtype ``npd``: every
    finite break of the +inf-padded ``breaks`` rows, each break's two float
    neighbours, NaN, +-inf and +-0.0 (as many as fit), then ``fill``, in an
    order drawn from the numpy generator ``rng``."""
    import numpy as np

    b = np.asarray(breaks, npd).ravel()
    b = np.unique(b[b != np.inf])
    special = np.concatenate([
        b, np.nextafter(b, npd(-np.inf)), np.nextafter(b, npd(np.inf)),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], npd)])
    n = len(fill)
    return rng.permutation(np.concatenate(
        [special, np.asarray(fill, npd)])[:n])


def host_step_tables(model, dev):
    """The torch core's host tables ``BR``, ``VL`` for ``model`` at every
    config's memory, built by the core's own code."""
    import torch

    from repro_torch.core.predictor import const1_serving_table
    from repro_torch.core.torch_core import padded_step_tables

    return tuple(torch.as_tensor(a, device=dev) for a in padded_step_tables(
        [const1_serving_table(model, float(m)) for m in CONFIGS]))


def row(name, source, replaces, ms, plain_ms, err, nbytes, ops, dtype,
        library_ms=None, bound_at=None, **extra) -> dict:
    """One kernel's line; ``dtype`` names the peak rate of its bound, unless
    ``bound_at`` gives the (ms, "bytes" or "operations") bound itself."""
    b_ms, b_by = bound_at or bound(nbytes, ops, dtype)
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms}
    out.update(extra)
    log(f"[kernel] {json.dumps(out)}")
    return out


def phase_kernels(ctx, dev) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.core.decision import LeastPredictedWaitBalancer
    from repro_torch.kernels.gbrt_predict.kernel import (
        gbrt_predict_blocked,
        gbrt_predict_blocked_plain,
        gbrt_predict_multi,
        gbrt_predict_multi_plain,
        step_table,
    )
    from repro_torch.kernels.gbrt_predict.ops import (
        kernel_operands,
        multi_kernel_operands,
    )
    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_bsd,
        linear_scan_plain,
        scan_regime,
    )
    from repro_torch.kernels.state_replay.kernel import (
        REPLAY_SPLIT,
        replay_launch_layout,
        replay_ring_rows,
        replay_warps,
        smem_bytes,
        state_replay,
        state_replay_plain,
        state_walk,
        state_walk_plain,
        walk_launch_layout,
        walk_ring_rows,
        walk_smem_bytes,
        walk_split,
        walk_warps,
    )

    f64, f32 = torch.float64, torch.float32
    model = ctx["models"].comp_cloud
    chunk = ctx["chunks"][0]
    N = len(chunk)
    rows = []

    # ---- K1: every config's ensemble over the chunk's size column --------
    sizes = torch.as_tensor(np.asarray(chunk.size, np.float64), device=dev)
    mem = torch.tensor([float(m) for m in CONFIGS], dtype=f64, device=dev)
    models = [model] * len(CONFIGS)
    k1_ops = {dt: multi_kernel_operands(models, dt, dev) for dt in (f64, f32)}
    errs = {}
    for dt in (f64, f32):
        F, TH, LV, LR, BASE, depth = k1_ops[dt]
        npd = np.float64 if dt == f64 else np.float32
        adv = torch.as_tensor(adversarial(
            step_table(TH).breaks.cpu().numpy(), chunk.size, npd,
            np.random.default_rng(0)), device=dev)
        for case, col in (("chunk", sizes.to(dt)), ("adversarial", adv)):
            args = (col, mem.to(dt), LR, BASE, F, TH, LV)
            got = gbrt_predict_multi(*args, depth=depth)
            want = gbrt_predict_multi_plain(*args, depth=depth)
            errs[dt, case] = max_err(got, want)
            if not bits_equal(got, want):
                fail(f"K1 {dt} on the {case} column differs from its plain "
                     f"version ({errs[dt, case]})")
    F, TH, LV, LR, BASE, depth = k1_ops[f64]
    counts = step_table(TH).counts
    args = (sizes, mem, LR, BASE, F, TH, LV)
    C, T, I = F.shape
    L = LV.shape[2]
    host_br, host_vl = host_step_tables(model, dev)

    def k1():
        return gbrt_predict_multi(*args, depth=depth)

    def table_route():
        idx = torch.searchsorted(host_br, sizes.expand(C, N).contiguous(),
                                 side="left")
        return torch.gather(host_vl, 1, idx).T

    k1_bytes = N * 8 + 3 * C * 8 + C * T * (I * 12 + L * 8) + N * C * 8
    walk_ms, walk_by = bound(k1_bytes, N * C * T * (depth + 2), "float64")
    rows.append(row(
        "gbrt_predict_multi", "src/repro_torch/csrc/gbrt_predict.cu",
        "src/repro/kernels/gbrt_predict/kernel.py:126",
        graph_ms(k1, 20),
        cuda_ms(lambda: gbrt_predict_multi_plain(*args, depth=depth), 2),
        errs[f64, "chunk"], k1_bytes,
        sum((n + 1) * T * (depth + 2) + N * (search_steps(n + 1) + 1)
            for n in counts), "float64",
        eager_ms=cuda_ms(k1, 20), device_us=kernel_device_us(k1),
        walk_bound_ms=walk_ms, walk_bound_by=walk_by,
        table_route_ms=graph_ms(table_route, 20),
        table_route_bit_equal=bits_equal(table_route(), k1()),
        breaks=list(counts), max_abs_err_f32=errs[f32, "chunk"],
        adversarial_max_abs_err=max(errs[dt, "adversarial"]
                                    for dt in (f64, f32)),
        shape=f"N={N} C={C} T={T} I={I} L={L} f64"))

    # ---- K2: one ensemble over (N, 2) rows (the host prediction pass) ----
    x2 = torch.stack([sizes, torch.full_like(sizes, 1792.0)], 1).contiguous()
    kw = dict(depth=model.config.max_depth, lr=model.config.learning_rate,
              base=model.base)
    routes = []
    for dt in (f64, f32):
        feats, thr, lvs = kernel_operands(model, dt, dev)
        npd = np.float64 if dt == f64 else np.float32
        bnp = step_table(thr).breaks.cpu().numpy()
        rng = np.random.default_rng(0)
        adv = torch.as_tensor(np.stack([
            adversarial(bnp[:1], chunk.size, npd, rng),
            adversarial(bnp[1:], np.resize(np.asarray(CONFIGS, np.float64), N),
                        npd, rng)], 1), device=dev)
        for case, xs2 in (("chunk", x2.to(dt)), ("adversarial", adv)):
            before = dict(gbrt_predict_blocked.routes)
            got = gbrt_predict_blocked(xs2, feats, thr, lvs, **kw)
            routes.append(next(k for k, v in
                               gbrt_predict_blocked.routes.items()
                               if v != before[k]))
            want = gbrt_predict_blocked_plain(xs2, feats, thr, lvs, **kw)
            errs[dt, case] = max_err(got, want)
            if not bits_equal(got, want):
                fail(f"K2 {dt} on the {case} rows differs from its plain "
                     f"version ({errs[dt, case]})")
    if set(routes) != {"table"}:
        fail(f"K2 at (N, 2) did not take its table route: {routes}")
    feats, thr, lvs = kernel_operands(model, f64, dev)
    T, I = feats.shape
    L = lvs.shape[1]
    depth = model.config.max_depth
    counts, cells = step_table(thr).counts, step_table(thr).cells

    def k2():
        return gbrt_predict_blocked(x2, feats, thr, lvs, **kw)

    k2_bytes = N * 2 * 8 + T * (I * 12 + L * 8) + N * 8
    walk_ms, walk_by = bound(k2_bytes, N * T * (depth + 2), "float64")
    rows.append(row(
        "gbrt_predict_blocked", "src/repro_torch/csrc/gbrt_predict.cu",
        "src/repro/kernels/gbrt_predict/kernel.py:166",
        graph_ms(k2, 20),
        cuda_ms(lambda: gbrt_predict_blocked_plain(x2, feats, thr, lvs, **kw),
                2),
        errs[f64, "chunk"], k2_bytes,
        cells * T * (depth + 2) + N * (search_steps(cells) + 1), "float64",
        eager_ms=cuda_ms(k2, 20), device_us=kernel_device_us(k2),
        walk_bound_ms=walk_ms, walk_bound_by=walk_by, routes=routes,
        breaks=list(counts), cells=cells,
        max_abs_err_f32=errs[f32, "chunk"],
        adversarial_max_abs_err=max(errs[dt, "adversarial"]
                                    for dt in (f64, f32)),
        shape=f"N={N} F=2 T={T} I={I} L={L} f64"))

    # ---- K3: surplus prefix in float64 (exact fold); RG-LRU shapes in
    # float32 (chunked scan): (2, 4096, 1024), and Griffin's at its real
    # width (d_rnn 4096), its serving prefill (1, 32, 4096) and a
    # 4,096-token prompt (1, 4096, 4096)
    g = torch.Generator(device="cpu").manual_seed(0)
    rglru = {tag: rglru_case(shape, dev, g)
             for tag, shape in (("rglru_f32", (2, 4096, 1024)),
                                ("griffin_s32", (1, 32, 4096)),
                                ("griffin_s4096", (1, 4096, 4096)))}
    delta = torch.as_tensor(
        np.concatenate([[1.3e-3], np.random.default_rng(0).normal(
            0.0, 2e-5, N)]), device=dev)[None, :, None].contiguous()
    got, _ = linear_scan_bsd(delta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, _ = linear_scan_plain(delta)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if scan_regime(delta, None) != "fold":
        fail("K3 float64 does not take the exact fold")
    if not torch.equal(got, want):
        fail(f"K3 float64 prefix differs by {max_err(got, want)}")
    flat = delta.view(-1)
    lib = torch.cumsum(flat, 0)
    rows.append(row(
        "linear_scan", "src/repro_torch/csrc/linear_scan.cu",
        "src/repro/kernels/linear_scan/kernel.py:55",
        cuda_ms(lambda: linear_scan_bsd(delta), 20), plain_ms,
        max_err(got, want), 2 * (N + 1) * 8 + 8, N + 1, "float64",
        library_ms=cuda_ms(lambda: torch.cumsum(flat, 0), 20),
        library_bit_equal=torch.equal(lib, got.view(-1)),
        library_max_ulps=max_ulps(lib, got.view(-1)),
        chain_floor_ms=chain_floor_ms(N + 1, dev),
        shape=f"B=1 S={N + 1} D=1 f64 (surplus prefix); rglru: B=2 S=4096 "
              f"D=1024 f32 gated; griffin_s32 / griffin_s4096: B=1 S=32 / "
              f"4096 D=4096 f32 gated (recurrentgemma-9b's RG-LRU)",
        **{f"{tag}_{k}": v for tag, c in rglru.items()
           for k, v in c.items()},
        limit="exact fold: the S-step chain of dependent float64 adds; "
              "chunked scan: bytes"))

    # ---- state walk + state replay on chunk 0 of the stream --------------
    from repro_torch.core import torch_core
    from repro_torch.core.decision import MinLatencyPolicy

    rt = runtime(ctx, MinLatencyPolicy(c_max=C_MAX, alpha=ALPHA), dev)
    if type(rt.engine.balancer) is not LeastPredictedWaitBalancer:
        fail("the slice's engine must use the least-predicted-wait balancer")
    core = torch_core.core_for(rt.engine)
    if core is None:
        fail("the slice's engine is not eligible for the torch core")
    # the pool the main path's first chunk grows to on its one regrow
    nc, nd, cap = core.n_cloud, core.n_dev, core.cap_limit
    P = core._predict(sizes, torch.as_tensor(
        np.asarray(chunk.bytes, np.float64), device=dev))
    nows = torch.as_tensor(np.asarray(chunk.arrival_ms, np.float64),
                           device=dev)
    seed = dict(
        busy0=torch.full((nc, cap), float("inf"), dtype=f64, device=dev),
        last0=torch.full((nc, cap), float("-inf"), dtype=f64, device=dev),
        cnt0=torch.zeros(nc, dtype=torch.int32, device=dev),
        t_idl=core.t_idl, lpw=True, ecomp=P["ECOMP"],
        h0=torch.zeros(nd, dtype=f64, device=dev))
    walk_in = dict(seed, elat=P["ELAT"], latw=P["LATW"], latc=P["LATC"],
                   costc=P["COSTC"], occw=P["OCCW"], occc=P["OCCC"],
                   minlat=True, c_max=C_MAX, alpha=ALPHA,
                   s0=torch.zeros((), dtype=f64, device=dev))
    replay_in = dict(seed, edge_col=core.edge_col, occw=P["OCCW"],
                     occc=P["OCCC"])

    def on_cpu(d):
        return {k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in d.items()}

    guess, ovf = state_walk(nows, N, **walk_in)
    t0 = time.perf_counter()
    want, _ = state_walk_plain(nows.cpu(), N, **on_cpu(walk_in))
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(guess.cpu(), want) or int(ovf.sum()):
        fail("state_walk differs from its plain version (or overflowed)")
    # the same chunk under MinCost: every row goes to the edge
    cost_in = dict(walk_in, minlat=False, deadline=DEADLINE_MS, s0=None)
    cost_codes, cost_ovf = state_walk(nows, N, **cost_in)
    t0 = time.perf_counter()
    want_cost, _ = state_walk_plain(nows.cpu(), N, **on_cpu(cost_in))
    walk_cost_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(cost_codes.cpu(), want_cost) or int(cost_ovf.sum()):
        fail("state_walk under MinCost differs from its plain version")

    def replay_check(codes, what):
        """The replay under ``codes`` bit-equal to its plain version (on CPU
        copies, host-timed); returns the plain run's ms."""
        got = state_replay(nows, codes, **replay_in)
        t0 = time.perf_counter()
        want = state_replay_plain(nows.cpu(), codes.cpu(), **on_cpu(replay_in))
        plain = (time.perf_counter() - t0) * 1e3
        for field, a_, b_ in zip(got._fields, got, want):
            if not torch.equal(a_.cpu(), b_):
                fail(f"state_replay {field} differs from its plain version "
                     f"under {what} codes")
        if int(got.overflow.sum()):
            fail(f"state_replay check overflowed its pool ({what})")
        return got, plain

    got, replay_plain_ms = replay_check(guess, "MinLatency")
    _, replay_cost_plain_ms = replay_check(cost_codes, "MinCost")
    cnt = got.cnt.cpu().numpy()
    codes = np.bincount(guess.cpu().numpy(), minlength=nc + 1).tolist()
    live = float(cnt.sum()) / 2.0      # mean live slots over the chunk
    pools = 2 * nc * cap * 16 + nc * 8  # seed in, final pools out
    shape = (f"R={N} nc={nc} nd={nd} cap={cap} pools_end={cnt.tolist()} "
             f"codes={codes}")
    # the launch as the library makes it; the host's mirror must agree
    warps, ring_rows, split, smem = walk_launch_layout(nd, nc, cap)
    mirror = (walk_warps(nc), walk_ring_rows(nd, nc), walk_split(nc),
              walk_smem_bytes(nd, nc, cap))
    if mirror != (warps, ring_rows, split, smem):
        fail(f"the walk's host layout {mirror} differs from the library's "
             f"{(warps, ring_rows, split, smem)}")
    r_layout = replay_launch_layout(nd, nc, cap)
    r_mirror = (replay_warps(), replay_ring_rows(nd), REPLAY_SPLIT,
                smem_bytes(nd, nc, cap))
    log(f"[replay] layout (warps, segment rows, scanners per pool, shared "
        f"bytes): library {r_layout}, host mirror {r_mirror}")
    if r_mirror != r_layout:
        fail(f"the replay's host layout {r_mirror} differs from the "
             f"library's {r_layout}")
    replay_ms = cuda_ms(lambda: state_replay(nows, guess, **replay_in), 3)
    replay_cost_ms = cuda_ms(lambda: state_replay(nows, cost_codes,
                                                  **replay_in), 3)
    # after a walk that overflowed a pool the replay gets its flags and
    # returns at once (the main path's regrow walk)
    overflowed = torch.ones(nc, dtype=torch.int32, device=dev)
    replay_skip_ms = cuda_ms(lambda: state_replay(
        nows, guess, skip=overflowed, **replay_in), 20)
    longest = max(codes[:nc])  # the largest config's dispatch chain
    rows.append(row(
        "state_walk", "src/repro_torch/csrc/state_replay.cu",
        "src/repro/core/jax_core.py:770",
        cuda_ms(lambda: state_walk(nows, N, **walk_in), 3), walk_plain_ms,
        0.0, N * (8 + 2 * nd * 8 + 5 * nc * 8 + 4) + pools,
        N * (live * 3 + nd * 4 + (nc + 1) * 6), "float64", shape=shape,
        plain_device="cpu",
        chain_floor_ms=walk_chain_floor_ms(N, warps, dev),
        warps=warps, ring_rows=ring_rows, split=split, smem_bytes=smem,
        min_cost_ms=cuda_ms(lambda: state_walk(nows, N, **cost_in), 3),
        min_cost_plain_ms=walk_cost_plain_ms,
        min_cost_codes=np.bincount(cost_codes.cpu().numpy(),
                                   minlength=nc + 1).tolist(),
        limit="latency of the R-step dependent chain (one block barrier "
              "per row)"))
    rows.append(row(
        "state_replay", "src/repro_torch/csrc/state_replay.cu",
        "src/repro/core/jax_core.py:521", replay_ms,
        replay_plain_ms, 0.0,
        N * (8 + 4 + nd * 8 + nc * 16) + N * (nd * 8 + 4 + nc) + pools,
        N * (nd * 4 + live * 3 + nc), "float64", shape=shape,
        plain_device="cpu",
        chain_floor_ms=replay_chain_floor_ms(longest, r_layout[0] - 1, dev),
        chain_floor_steps=longest, warps=r_layout[0],
        ring_rows=r_layout[1], split=r_layout[2], smem_bytes=r_layout[3],
        min_cost_ms=replay_cost_ms, skip_ms=replay_skip_ms,
        min_cost_plain_ms=replay_cost_plain_ms,
        min_cost_codes=np.bincount(cost_codes.cpu().numpy(),
                                   minlength=nc + 1).tolist(),
        limit="latency of the largest config's chain of dispatch rows (one "
              "named barrier each); under MinCost the edge rows' chain"))
    return rows


def rglru_case(shape, dev, gen) -> dict:
    """K3's chunked float32 regime at one RG-LRU shape against its plain
    version (within 5e-5): the eager call's time (``ms``, as the row's
    ``rglru_f32_ms`` has been since it was added), the device time from a
    CUDA graph (``graph_ms``), the plain version's time and the byte
    bound."""
    import torch

    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_bsd,
        linear_scan_plain,
        scan_regime,
    )

    xs = torch.randn(shape, generator=gen).to(dev)
    a = torch.rand(shape, generator=gen).mul_(0.9).add_(0.1).to(dev)
    if scan_regime(xs, a) != "chunked":
        fail(f"K3 float32 gated at {shape} does not take the chunked scan")
    y, st = linear_scan_bsd(xs, a)
    yp, sp = linear_scan_plain(xs, a)
    err = max(max_err(y, yp), max_err(st, sp))
    if err > 5e-5:
        fail(f"K3 float32 at {shape} differs from its plain version by {err}")
    kernel = lambda: linear_scan_bsd(xs, a)  # noqa: E731
    b_ms, b_by = bound(4 * (3 * xs.numel() + st.numel()), 2 * xs.numel(),
                       "float32")
    return {"ms": cuda_ms(kernel, 20), "graph_ms": graph_ms(kernel, 20),
            "plain_ms": cuda_ms(lambda: linear_scan_plain(xs, a), 1),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}


# ------------------------------------------------------- phase 2, attention
def attn_inputs(shape, dtype, dev, seed):
    import numpy as np
    import torch

    B, H, Hkv, Sq, Skv, D = shape
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, H, Sq, D)), dtype=dtype).to(dev)
    k = torch.as_tensor(rng.normal(size=(B, Hkv, Skv, D)), dtype=dtype).to(dev)
    v = torch.as_tensor(rng.normal(size=(B, Hkv, Skv, D)), dtype=dtype).to(dev)
    return q, k, v


K4_TK = 64  # the key tile of K4's bf16 tensor-core kernel at D > 64


def fa_planted(k, v, fault):
    """K/V as a K4 with one fault planted would read them, for the plain
    version to compute that kernel's output (non-causal shapes): ``tail``
    leaves the last key tile's rows past Skv unmasked, read as the zeros
    the kernel's tile loads put there (score 0, value 0); ``drop_tile``
    leaves out the second key tile."""
    import torch

    Skv = k.shape[2]
    if fault == "tail":
        pad = -Skv % K4_TK
        return tuple(torch.nn.functional.pad(t, (0, 0, 0, pad))
                     for t in (k, v))
    keep = torch.cat([torch.arange(K4_TK), torch.arange(2 * K4_TK, Skv)])
    keep = keep.to(k.device)
    return k[:, :, keep], v[:, :, keep]


def fa_case(shape, dtype, dev, causal, window, reps, ref=False,
            plain_rows=0, faults=()):
    """K4 vs its plain version (and SDPA's time) at one shape; with ``ref``
    also vs the literal oracle ``attention_ref`` (in the model's layout).
    ``plain_rows`` (unwindowed shapes only) runs the plain version over
    that many query rows at a time, each block against every key, or with
    ``causal`` against the keys up to its last row (``causal_rows_plain``;
    the rows are independent: the same values), where its full (Sq, Skv)
    float32 score matrix would not fit on the card. In bf16 each (batch,
    head, query) row of the output must also lie within DEC_ROW_TOL of its
    largest |output| (``row_err``): at long causal shapes a typical output
    is smaller than ATTN_TOL. The outputs of the planted ``faults``
    (unwindowed bf16; ``fa_planted``'s for non-causal shapes,
    ``causal_rows_plain``'s for causal ones, which need ``plain_rows``),
    computed plainly, must break that limit (``fault_row_err``; their
    absolute errors beside it, ``fault_err``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        _mask,
        flash_attention_bhsd,
        flash_attention_plain,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = attn_inputs(shape, dtype, dev, seed=shape[4] + window)
    B, H, Hkv, Sq, Skv, D = shape
    kw = dict(causal=causal, window=window)
    if plain_rows and (window or (causal and Sq != Skv)):
        fail("fa_case: the plain version runs in query blocks only without "
             "a window, and causal ones only on square shapes")

    if faults and (window or dtype != torch.bfloat16
                   or (causal and not plain_rows)):
        fail("fa_case: planted faults are for unwindowed bf16 shapes, "
             "causal ones with plain_rows")

    def plain(k=k, v=v, fault=None):
        if not plain_rows:
            return flash_attention_plain(q, k, v, **kw)
        if causal:
            return torch.cat([causal_rows_plain(q, k, v, i, plain_rows,
                                                fault)
                              for i in range(0, Sq, plain_rows)], dim=2)
        return torch.cat([flash_attention_plain(q[:, :, i:i + plain_rows],
                                                k, v, **kw)
                          for i in range(0, Sq, plain_rows)], dim=2)

    got = flash_attention_bhsd(q, k, v, **kw)
    want = plain()
    torch.cuda.synchronize()
    err = max_err(got, want)
    name = str(dtype).split(".")[-1]
    if err > ATTN_TOL[name]:
        fail(f"K4 {shape} {name} causal={causal} window={window} differs "
             f"from its plain version by {err}")
    row_err, fault_row_err, fault_err = None, {}, {}
    if dtype == torch.bfloat16:
        row_err = k4b_row_err((got,), (want,))
        if row_err > DEC_ROW_TOL:
            fail(f"K4 {shape} bf16 causal={causal} window={window}: a row "
                 f"differs from the plain version by {row_err} of its "
                 f"largest |output| (limit {DEC_ROW_TOL})")
    if faults:
        for f in faults:
            bad = plain(fault=f) if causal else plain(*fa_planted(k, v, f))
            fault_row_err[f] = k4b_row_err((bad,), (want,))
            fault_err[f] = max_err(bad, want)
            del bad
        log(f"[k4] {shape} bf16 causal={causal}: row error {row_err}, "
            f"planted faults {json.dumps(fault_row_err)}, limit "
            f"{DEC_ROW_TOL}; their absolute errors {json.dumps(fault_err)}, "
            f"limit {ATTN_TOL[name]}")
        missed = [f for f, e in fault_row_err.items() if e <= DEC_ROW_TOL]
        if missed:
            fail(f"K4 {shape}: the row limit {DEC_ROW_TOL} misses planted "
                 f"faults {missed}: {fault_row_err}")
    del want
    ref_err = None
    if ref:
        oracle = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), **kw)
        ref_err = max_err(got, oracle.transpose(1, 2))
        del oracle
        if ref_err > ATTN_TOL[name]:
            fail(f"K4 {shape} {name} causal={causal} window={window} differs "
                 f"from attention_ref by {ref_err}")
    del got
    if causal or window:
        mask = _mask(Sq, Skv, causal, window, dev)
        pairs = int(mask.sum())  # the (q, k) pairs this mask leaves live
    else:
        mask, pairs = None, Sq * Skv
    if window:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    esz = q.element_size()
    kernel = lambda: flash_attention_bhsd(q, k, v, **kw)  # noqa: E731
    return dict(
        ms=graph_ms(kernel, reps), eager_ms=cuda_ms(kernel, reps),
        plain_ms=cuda_ms(plain, 1, warmup=0) if plain_rows
        else graph_ms(plain, max(reps // 10, 2)),
        library_ms=graph_ms(sdpa, reps), err=err, ref_err=ref_err,
        row_err=row_err, fault_row_err=fault_row_err, fault_err=fault_err,
        nbytes=esz * (2 * q.numel() + k.numel() + v.numel()),
        ops=4.0 * B * H * pairs * D, dtype=name)


def causal_rows_plain(q, k, v, i, rows, fault=None):
    """``flash_attention_plain``'s causal output for the query rows i to
    i + rows - 1 of a square shape, over the keys 0 to i + rows - 1 they
    can see: the same float32 formulas, its mask offset by i. ``fault``
    plants one in the mask, as a K4 with that fault would compute:
    ``drop_tile`` leaves out the second key tile (keys K4_TK to
    2 K4_TK - 1) below the diagonal; ``late_diag`` lets each row of the
    last query tile see the whole of that tile, its future keys too."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import NEG_INF

    B, H, _, D = q.shape
    Hkv = k.shape[1]
    n = min(rows, q.shape[2] - i)
    qb = q[:, :, i:i + n].float().reshape(B, Hkv, H // Hkv, n, D)
    kb, vb = k[:, :, :i + n].float(), v[:, :, :i + n].float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qb, kb) * (1.0 / (D ** 0.5))
    kpos = torch.arange(i + n, device=q.device)[None, :]
    qpos = (i + torch.arange(n, device=q.device))[:, None]
    mask = kpos <= qpos
    if fault == "drop_tile":
        mask &= (kpos < K4_TK) | (kpos >= 2 * K4_TK)
    elif fault == "late_diag":
        last = q.shape[2] - K4_TK
        mask |= (qpos >= last) & (kpos >= last)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, vb) \
        / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, n, D).to(q.dtype)


def square(shape):
    """(B, H, Hkv, S, D) -> ``fa_case``'s (B, H, Hkv, S, S, D)."""
    B, H, Hkv, S, D = shape
    return (B, H, Hkv, S, S, D)


def fa_f32_repeat(dev, n: int = 100) -> dict:
    """K4 in float32 at the card test's first case, (B, S, H, Hkv, D) =
    (1, 32, 32, 8, 64) causal, launched ``n`` times after the live serves of
    phase 5 in this process: every output must have the same bits. Also
    each side's distance from a float64 softmax: the kernel's and the CPU
    plain version's."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd,
        flash_attention_plain,
    )

    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
               for shape in ((1, 32, 32, 64), (1, 8, 32, 64), (1, 8, 32, 64)))
    qc, kc, vc = (t.to(dev) for t in (q, k, v))
    outs = [flash_attention_bhsd(qc, kc, vc, causal=True) for _ in range(n)]
    torch.cuda.synchronize()
    outs = [o.cpu() for o in outs]
    differ = sum(not torch.equal(o, outs[0]) for o in outs)
    kd = k.double().repeat_interleave(4, 1)
    vd = v.double().repeat_interleave(4, 1)
    s = q.double() @ kd.transpose(2, 3) / 8.0
    s = s.masked_fill(~torch.ones(32, 32, dtype=torch.bool).tril(),
                      float("-inf"))
    exact = torch.softmax(s, -1) @ vd
    want = flash_attention_plain(q, k, v, causal=True)
    res = {"f32_repeat_launches": n, "f32_repeat_differ": differ,
           "f32_repeat_vs_f64": float((outs[0].double() - exact).abs().max()),
           "f32_plain_vs_f64": float((want.double() - exact).abs().max()),
           "f32_repeat_vs_plain": max_err(outs[0], want)}
    log(f"[k4] float32 (1, 32, 32, 8, 64) causal x {n} after the live "
        f"serves: {json.dumps(res)}")
    if differ or res["f32_repeat_vs_plain"] > ATTN_TOL["float32"]:
        fail(f"K4 float32 is not bit-stable over {n} launches or differs "
             f"from its plain version: {res}")
    return res


def row_rel_err(got, want) -> float:
    """The largest, over (batch, head) rows, of a row's max |got - want|
    over its max |want| (inf where a zero row of ``want`` is not matched
    exactly)."""
    import torch

    g, w = (t.double().cpu().reshape(-1, t.shape[-1]) for t in (got, want))
    err, scale = (g - w).abs().amax(-1), w.abs().amax(-1)
    ratio = torch.where(scale > 0, err / scale.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def masked_decode(q, k, v, valid):
    """The plain decode over the slots ``valid`` (B, S) marks, in q's
    dtype: ``decode_attention_plain``'s math with a mask it cannot take
    from lengths, to plant a fault."""
    import torch

    B, H, _, D = q.shape
    Hkv = k.shape[1]
    qf = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) / D ** 0.5
    m = valid[:, None, None, :]
    s = torch.where(m, s, -2.0e38)
    p = torch.where(m, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float()) \
        / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, 1, D).to(q.dtype)


def fd_faults(q, k, v, lens, got, nsplit, chunk) -> dict:
    """The bf16 row limit against two planted faults, read on the card:
    the output of a kernel that drops one split (the second; the last
    16-slot tile when the cache is one split) or lets one masked slot
    through (each length + 1) is computed plainly on the card and held
    against the kernel's own output. Fails if the limit would pass
    either."""
    import torch

    S = k.shape[2]
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < lens.long()[:, None]
    lo, hi = (chunk, 2 * chunk) if nsplit > 1 else (S - 16, S)
    faults = {"drop_split": valid & ((pos < lo) | (pos >= hi))}
    if bool((lens < S).any()):
        faults["extra_slot"] = pos < lens.long()[:, None] + 1
    out = {}
    for tag, mask in faults.items():
        out[tag] = row_rel_err(masked_decode(q, k, v, mask), got)
        if out[tag] <= DEC_ROW_TOL:
            fail(f"K5's bf16 row limit {DEC_ROW_TOL} would pass a kernel "
                 f"with the planted fault {tag} (row error {out[tag]})")
    return out


def fd_case(shape, dtype, dev, lengths, reps, ref=False):
    """K5 vs its plain version (and SDPA's time) at one shape; with ``ref``
    also vs the literal oracle ``decode_attention_ref`` (in the model's
    layout)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_bhd,
        decode_attention_plain,
        decode_splits,
        sm_count,
    )
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    q, k, v = attn_inputs(shape, dtype, dev, seed=shape[4] + 1)
    B, H, Hkv, _, S, D = shape
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = decode_attention_bhd(q, k, v, lens)
    want = decode_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    err, rel = max_err(got, want), row_rel_err(got, want)
    name = str(dtype).split(".")[-1]
    if err > ATTN_TOL[name] or (name == "bfloat16" and rel > DEC_ROW_TOL):
        fail(f"K5 {shape} {name} lengths={lengths} differs from its plain "
             f"version by {err} (row error {rel})")
    ref_err = None
    if ref:
        oracle = decode_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                      lens)
        ref_err = max_err(got, oracle.transpose(1, 2))
        if ref_err > ATTN_TOL[name]:
            fail(f"K5 {shape} {name} lengths={lengths} differs from "
                 f"decode_attention_ref by {ref_err}")
    valid = torch.arange(S, device=dev)[None, :] < lens.long()[:, None]
    mask = valid[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    live = int(valid.sum())  # the cache slots this run's lengths leave live
    esz = q.element_size()
    kernel = lambda: decode_attention_bhd(q, k, v, lens)  # noqa: E731
    nsplit, chunk = decode_splits(B, Hkv, H // Hkv, S, sm_count(q.device))
    faults = fd_faults(q, k, v, lens, got, nsplit, chunk) \
        if name == "bfloat16" else {}
    return dict(
        nsplit=nsplit, chunk=chunk, row_err=rel, faults=faults,
        ms=graph_ms(kernel, reps), eager_ms=cuda_ms(kernel, reps),
        plain_ms=graph_ms(lambda: decode_attention_plain(q, k, v, lens),
                          max(reps // 10, 2)),
        library_ms=graph_ms(sdpa, reps), err=err, ref_err=ref_err,
        nbytes=esz * (2 * q.numel() + 2 * live * Hkv * D) + 4 * B,
        ops=4.0 * H * live * D, dtype=name)


def phase_attention(dev) -> list[dict]:
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, H, Hkv, Sq, Skv, D): llama3.2-1b's prefill of a (1, 32) prompt
    path = (1, 32, 8, 32, 32, 64)
    fa = fa_case(path, bf16, dev, True, 0, 200)
    fa32 = fa_case(path, f32, dev, True, 0, 200)
    big = (1, 32, 8, 2048, 2048, 64)
    fab = fa_case(big, bf16, dev, True, 0, 20)
    faw = fa_case(big, bf16, dev, True, 256, 20)
    extra = {f"{tag}_{key}": c[key] for tag, c in
             (("f32", fa32), ("s2048", fab), ("s2048_w256", faw))
             for key in ("ms", "plain_ms", "library_ms", "err")}
    extra["eager_ms"], extra["row_err"] = fa["eager_ms"], fa["row_err"]
    for tag, c in (("s2048", fab), ("s2048_w256", faw)):
        extra[f"{tag}_bound_ms"] = bound(c["nbytes"], c["ops"], c["dtype"])[0]
        extra[f"{tag}_row_err"] = c["row_err"]
    # recurrentgemma-9b's local attention (head_dim 256, MQA, window 2048):
    # its serving prefill, and a 4,096-token prompt past the window
    g32 = (1, 16, 1, PROMPT_LEN, PROMPT_LEN, 256)
    g4k = (1, 16, 1, 4096, 4096, 256)
    griffin = {"griffin_s32": fa_case(g32, bf16, dev, True, WINDOW, 200,
                                      ref=True),
               "griffin_s4096": fa_case(g4k, bf16, dev, True, WINDOW, 10,
                                        ref=True),
               "griffin_s4096_f32": fa_case(g4k, f32, dev, True, WINDOW, 5,
                                            ref=True),
               # the decoder's head_dim-128 shapes: olmoe-1b-7b's serving
               # prefill (16 heads, multi-head) and internvl2-26b's prefill
               # of 1,024 vision embeddings and 32 tokens (48 query heads on
               # 8 KV heads)
               "olmoe_s32": fa_case((1, 16, 16, PROMPT_LEN, PROMPT_LEN, 128),
                                    bf16, dev, True, 0, 200, ref=True),
               "internvl2_s1056": fa_case((1, 48, 8, 1056, 1056, 128), bf16,
                                          dev, True, 0, 20, ref=True),
               # hubert-xlarge's encoder attention, non-causal at head_dim
               # 80 (the 128-wide instantiation, 48 of its columns zero): a
               # batch of HuBERT's 781-frame crops, and prefill_32k's
               # 32,768-frame sequence (its plain version in query blocks)
               # (in bf16 each output row is also held to its own scale,
               # with planted faults: the last partial key tile unmasked
               # (781 = 12 x 64 + 13) and a key tile dropped)
               "hubert_s781": fa_case(square(AUDIO_ATTN), bf16, dev, False,
                                      0, 20, ref=True,
                                      faults=("tail", "drop_tile")),
               "hubert_s781_f32": fa_case(square(AUDIO_ATTN), f32, dev,
                                          False, 0, 5, ref=True),
               "hubert_s32768": fa_case(square(AUDIO_LONG_ATTN), bf16, dev,
                                        False, 0, 2, plain_rows=1024,
                                        faults=("drop_tile",)),
               # llama3.2-1b's prefill_32k cell (the launch phase): one
               # 32,768-token prompt, causal (the plain version in blocks of
               # 1,024 query rows over the keys they see), with planted
               # faults: a key tile below the diagonal dropped, and the
               # last query tile's diagonal tile unmasked
               "llama_s32768": fa_case(square(LLAMA_LONG_ATTN), bf16, dev,
                                       True, 0, 5, plain_rows=1024,
                                       faults=("drop_tile", "late_diag"))}
    extra["row_tol"] = DEC_ROW_TOL
    for tag, c in griffin.items():
        extra.update({f"{tag}_{key}": c[key] for key in
                      ("ms", "eager_ms", "plain_ms", "library_ms", "err",
                       "ref_err")})
        if c["row_err"] is not None:
            extra[f"{tag}_row_err"] = c["row_err"]
        if c["fault_row_err"]:
            extra[f"{tag}_fault_row_err"] = c["fault_row_err"]
            extra[f"{tag}_fault_err"] = c["fault_err"]
        extra[f"{tag}_bound_ms"], extra[f"{tag}_bound_by"] = bound(
            c["nbytes"], c["ops"], c["dtype"])
    rows = [row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:98", fa["ms"],
                fa["plain_ms"], fa["err"], fa["nbytes"], fa["ops"], "bfloat16",
                library_ms=fa["library_ms"],
                shape="q (1, 32, 32, 64) k/v (1, 8, 32, 64) bf16 causal; "
                      "s2048: q (1, 32, 2048, 64) k/v (1, 8, 2048, 64); "
                      "griffin_s32 / griffin_s4096: q (1, 16, 32 / 4096, "
                      "256) k/v (1, 1, 32 / 4096, 256) causal, window 2048 "
                      "(recurrentgemma-9b), ref_err against attention_ref; "
                      "olmoe_s32: q/k/v (1, 16, 32, 128) causal "
                      "(olmoe-1b-7b's prefill); internvl2_s1056: q (1, 48, "
                      "1056, 128) k/v (1, 8, 1056, 128) causal "
                      "(internvl2-26b's vision prefix and 32 tokens); "
                      "hubert_s781 / hubert_s32768: q/k/v (8, 16, 781, 80) "
                      "/ (1, 16, 32768, 80) non-causal (hubert-xlarge's "
                      "encoder: 781-frame crops, prefill_32k's sequence; "
                      "hubert_s32768's plain version in blocks of 1,024 "
                      "query rows), bf16, and the first in float32 (the "
                      "first also against attention_ref); "
                      "llama_s32768: q (1, 32, 32768, 64) k/v (1, 8, 32768, "
                      "64) causal bf16 (llama3.2-1b's prefill_32k cell), the "
                      "plain version in blocks of 1,024 query rows; in bf16 "
                      "each output row within row_tol of its largest "
                      "|output| (row_err), planted faults breaking it "
                      "(fault_row_err, their absolute errors fault_err: "
                      "tail = the last partial key tile unmasked, drop_tile "
                      "= a key tile left out, the second, below the "
                      "diagonal where causal, late_diag = the last query "
                      "tile's diagonal tile unmasked)",
                **extra)]
    # (B, H, Hkv, 1, S, D): a decode step of the serving executor, whose
    # lengths run past its 32-slot cache (pos + 1 >= 33)
    path = (1, 32, 8, 1, 32, 64)
    fd = fd_case(path, bf16, dev, [33], 200)
    fd32 = fd_case(path, f32, dev, [33], 200)
    big = (4, 32, 8, 1, 4096, 64)
    fdb = fd_case(big, bf16, dev, [4096 + 7, 1000, 3001, 17], 50)
    extra = {f"{tag}_{key}": c[key] for tag, c in
             (("f32", fd32), ("b4_s4096", fdb))
             for key in ("ms", "plain_ms", "library_ms", "err")}
    extra["nsplit"], extra["chunk"] = fd["nsplit"], fd["chunk"]
    extra["row_tol"] = DEC_ROW_TOL
    for tag, c in (("", fd), ("b4_s4096_", fdb)):
        extra[f"{tag}row_err"] = c["row_err"]
        extra[f"{tag}fault_row_err"] = c["faults"]
    extra["b4_s4096_nsplit"] = fdb["nsplit"]
    extra["b4_s4096_chunk"] = fdb["chunk"]
    extra["b4_s4096_eager_ms"] = fdb["eager_ms"]
    extra["eager_ms"] = fd["eager_ms"]
    extra["b4_s4096_bound_ms"] = bound(fdb["nbytes"], fdb["ops"],
                                       fdb["dtype"])[0]
    # recurrentgemma-9b's decode (head_dim 256, MQA): the serving ring of
    # 32 slots (full after the first step), and a 2,048-slot ring (the
    # window), full
    g32 = (1, 16, 1, 1, PROMPT_LEN, 256)
    g2k = (1, 16, 1, 1, WINDOW, 256)
    griffin = {"griffin_s32": fd_case(g32, bf16, dev, [PROMPT_LEN], 200,
                                      ref=True),
               "griffin_s2048": fd_case(g2k, bf16, dev, [WINDOW], 50,
                                        ref=True),
               "griffin_s2048_f32": fd_case(g2k, f32, dev, [WINDOW], 50,
                                            ref=True),
               # olmoe-1b-7b's decode step: 16 heads on 16 KV heads at
               # head_dim 128, past its 32-slot serving cache (length 33)
               "olmoe_s32": fd_case((1, 16, 16, 1, PROMPT_LEN, 128), bf16,
                                    dev, [PROMPT_LEN + 1], 200, ref=True),
               # llama3.2-1b's decode_32k cell (the launch phase): 16
               # sequences over full 32,768-slot caches
               "llama_b16_s32768": fd_case(LLAMA_DECODE_32K, bf16, dev,
                                           [LLAMA_DECODE_32K[4]]
                                           * LLAMA_DECODE_32K[0], 20)}
    for tag, c in griffin.items():
        extra.update({f"{tag}_{key}": c[key] for key in
                      ("ms", "eager_ms", "plain_ms", "library_ms", "err",
                       "ref_err", "nsplit", "chunk", "row_err")})
        extra[f"{tag}_bound_ms"], extra[f"{tag}_bound_by"] = bound(
            c["nbytes"], c["ops"], c["dtype"])
        if c["faults"]:
            extra[f"{tag}_fault_row_err"] = c["faults"]
    rows.append(row("decode_attention",
                    "src/repro_torch/csrc/decode_attention.cu",
                    "src/repro/kernels/decode_attention/kernel.py:75",
                    fd["ms"], fd["plain_ms"], fd["err"], fd["nbytes"],
                    fd["ops"], "bfloat16", library_ms=fd["library_ms"],
                    shape="q (1, 32, 1, 64) k/v (1, 8, 32, 64) bf16 length "
                          "33; b4_s4096: k/v (4, 8, 4096, 64) lengths "
                          "4103/1000/3001/17; griffin_s32 / griffin_s2048: q "
                          "(1, 16, 1, 256) k/v (1, 1, 32 / 2048, 256) full "
                          "(recurrentgemma-9b), ref_err against "
                          "decode_attention_ref; olmoe_s32: q (1, 16, 1, "
                          "128) k/v (1, 16, 32, 128) length 33 "
                          "(olmoe-1b-7b's decode step); llama_b16_s32768: q "
                          "(16, 32, 1, 64) k/v (16, 8, 32768, 64) full "
                          "(llama3.2-1b's decode_32k cell at batch 16)",
                    **extra))
    return rows


# ------------------------------------------------------ phase 2, SSD scan
def ssd_layer_inputs(dev, shapes) -> tuple[dict, int]:
    """K6's inputs as mamba2-780m's first layer gives them at full width:
    the layer's weights from a seeded generator on the card, token
    embeddings drawn N(0, 1) as the embedding table is; the model's layout
    (x (b, S, 48, 64), dt (b, S, 48), B/C slices of the conv output), for
    each (b, S) of ``shapes``. Returns them and the config's chunk."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.modeling.layers import rms_norm
    from repro_torch.modeling.mamba import MambaLM
    from repro_torch.modeling.module import init_params
    from repro_torch.modeling.rglru import causal_conv1d
    from repro_torch.modeling.ssd import softplus, ssd_dims

    cfg = get_config(SSM_ARCH).with_updates(n_layers=1, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    specs = {k: v for k, v in MambaLM(cfg).param_specs().items()
             if k.startswith("layers/")}
    p = {k[len("layers/"):]: v[0]
         for k, v in init_params(gen, specs, device=dev).items()}
    d_inner, nh, hd, ds = ssd_dims(cfg)
    out = {}
    for b, S in shapes:
        h = rms_norm(torch.randn((b, S, cfg.d_model), generator=gen,
                                 device=dev), p["ln/scale"])
        z = h @ p["mixer/in_proj"]
        xbc = F.silu(causal_conv1d(z[..., d_inner:2 * d_inner + 2 * ds],
                                   p["mixer/conv/w"], p["mixer/conv/b"]))
        out[(b, S)] = (xbc[..., :d_inner].reshape(b, S, nh, hd),
                       softplus(z[..., 2 * d_inner + 2 * ds:]
                                + p["mixer/dt_bias"]),
                       -torch.exp(p["mixer/a_log"]),
                       xbc[..., d_inner:d_inner + ds], xbc[..., d_inner + ds:])
    return out, cfg.ssm_chunk


def ssd_y_errs(got, want) -> tuple[float, float]:
    """The largest, over (batch, head) rows of y (b, H, S, hd), of the
    row's max |got - want| over its max |want| (inf where a zero row of
    ``want`` is not matched exactly); and the mean |got - want| over the
    mean |want|."""
    import torch

    b, H = want.shape[:2]
    g, w = (t.double().cpu().reshape(b * H, -1) for t in (got, want))
    err, scale = (g - w).abs(), w.abs()
    e, m = err.amax(-1), scale.amax(-1)
    ratio = torch.where(m > 0, e / m.clamp_min(1e-300),
                        torch.where(e > 0, float("inf"), 0.0))
    mean = float(err.mean() / scale.mean()) if float(scale.mean()) > 0 \
        else (0.0 if float(err.max()) == 0 else float("inf"))
    return float(ratio.max()), mean


def ssd_planted(x, dt, A, B, C, chunk, fault):
    """y of ``ssd_scan_plain``'s math with one fault of the bf16 kernel
    planted: ``hi_only`` takes scores x from the scores' hi bf16 term alone;
    ``drop_tile`` drops the last 16 x 8 score tile on the diagonal of every
    chunk; ``zero_group`` writes 0 for the first group of 8 heads."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.kernel import NEG_INF

    b, H, S, hd = x.shape
    Q = min(chunk, S)
    pad = (-S) % Q
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, pad))
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    mb = max((Q + 15) // 16 - 1, 0)  # the last 16-row block of a chunk
    r0, c0 = 16 * mb, min(8 * (2 * mb + 1), max(Q - 8, 0))
    h = torch.zeros((b, H, hd, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for k in range(0, S + pad, Q):
        xc, dtc = xf[:, :, k:k + Q], dtf[:, :, k:k + Q]
        bc, cc = Bf[:, k:k + Q], Cf[:, k:k + Q]
        cum = torch.cumsum((dtc * A.float()[None, :, None]).double(),
                           -1).float()
        total = cum[..., -1:]
        L = torch.exp(torch.where(causal, cum[..., :, None]
                                  - cum[..., None, :], NEG_INF))
        sc = (cc @ bc.transpose(1, 2))[:, None] * L * dtc[..., None, :]
        if fault == "hi_only":
            sc = sc.bfloat16().float()
        elif fault == "drop_tile":
            sc[..., r0:r0 + 16, c0:c0 + 8] = 0.0
        ys.append(sc @ xc + (cc[:, None] @ h.transpose(2, 3))
                  * torch.exp(cum)[..., None])
        w = dtc * torch.exp(total - cum)
        h = h * torch.exp(total)[..., None] \
            + (xc * w[..., None]).transpose(2, 3) @ bc[:, None]
    y = torch.cat(ys, 2)[:, :, :S]
    if fault == "zero_group":
        y[:, :8] = 0.0
    return y.to(x.dtype)


def ssd_faults(x, dt, A, B, C, chunk, got) -> dict:
    """K6's bf16 limits on y against three planted faults, read on the
    card: each fault's y, computed plainly on the card, held against the
    kernel's own ([row error, mean error]). Fails if a fault lies within
    both limits."""
    out = {}
    for fault in ("hi_only", "drop_tile", "zero_group"):
        r_max, r_mean = ssd_y_errs(
            ssd_planted(x, dt, A, B, C, chunk, fault), got)
        out[fault] = [r_max, r_mean]
        if r_max <= SSD_ROW_TOL and r_mean <= SSD_MEAN_TOL:
            fail(f"K6's bf16 limits {SSD_ROW_TOL} (row) and {SSD_MEAN_TOL} "
                 f"(mean) would pass a kernel with the planted fault "
                 f"{fault} (errors {r_max} / {r_mean})")
    return out


def ssd_case(args, dtype, chunk, reps, ref=False) -> dict:
    """K6 vs its plain version at one shape, called as ``ops.ssd`` calls it
    (strided views of the model's tensors in, a transposed view out); in
    bf16 also per row of y, against planted faults; with ``ref`` also
    against the literal oracle ``ssd_ref``."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_route,
        ssd_scan_bhsd,
        ssd_scan_plain,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    xs, dt, A, B, C = args
    x, B, C = xs.to(dtype).transpose(1, 2), B.to(dtype), C.to(dtype)
    dtt = dt.transpose(1, 2)
    out = torch.empty(xs.shape, dtype=dtype, device=xs.device).transpose(1, 2)
    y, st = ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk, out=out)
    yp, sp = ssd_scan_plain(x, dtt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    err = max_err(y, yp)
    y_rel = float(((y.double() - yp.double()).abs()
                   / yp.double().abs().clamp_min(1.0)).max())
    s_err = max_err(st, sp)
    b, H, S, hd = x.shape
    bf16 = dtype == torch.bfloat16
    row_max, mean = ssd_y_errs(y, yp) if bf16 else (0.0, 0.0)
    if (y_rel if bf16 else err) > SSD_TOL[name] or s_err > SSD_STATE_TOL \
            or row_max > SSD_ROW_TOL or mean > SSD_MEAN_TOL:
        fail(f"K6 b={b} S={S} {name} differs from its plain version: y "
             f"{err} ({y_rel} of max(1, |y|); {row_max} of a row's largest "
             f"|y|; mean {mean} of the mean |y|), state {s_err}")
    ds, Q = B.shape[-1], min(chunk, S)
    score_ops = prod_ops = 0.0  # C B^T; the products with a float32 operand
    for r0 in range(0, S, Q):
        qc = min(Q, S - r0)
        tri = qc * (qc + 1) / 2              # the (q, s <= q) pairs
        score_ops += b * 2 * tri * ds         # C B^T, shared by the heads
        prod_ops += b * H * (2 * tri * hd + 2 * qc * hd * ds)  # scores x, state
        if r0:                                # the carried state's part of y
            prod_ops += b * H * 2 * qc * hd * ds
    nbytes = x.element_size() * (2 * x.numel() + B.numel() + C.numel()) \
        + 4 * (dt.numel() + A.numel() + st.numel())
    kernel = lambda: ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk,  # noqa: E731
                                   out=out)
    out_ = dict(
        ms=graph_ms(kernel, reps), eager_ms=cuda_ms(kernel, reps),
        plain_ms=graph_ms(lambda: ssd_scan_plain(x, dtt, A, B, C, chunk=chunk),
                          max(reps // 10, 2)),
        err=err, y_rel_err=y_rel, state_err=s_err, route=ssd_route(S, chunk),
        y_max=float(yp.float().abs().max()), nbytes=nbytes,
        ops=score_ops + prod_ops,
        **dict(zip(("bound_ms", "bound_by"),
                   ssd_bound(nbytes, score_ops, prod_ops, bf16))))
    if bf16:
        out_.update(row_err=row_max, mean_err=mean,
                    fault_row_err=ssd_faults(x, dtt, A, B, C, chunk, y))
    if ref:
        # against the literal oracle: within the plain version's own gap to
        # ssd_ref on the CPU (the same inputs), plus the kernel's limit
        # against the plain version as the margin
        cpu = [t.cpu() for t in (xs, dt, A, B, C)]
        ry, rs = ssd_ref(*cpu)
        py_, ps_ = ssd_scan_plain(cpu[0].transpose(1, 2),
                                  cpu[1].transpose(1, 2), cpu[2], cpu[3],
                                  cpu[4], chunk=chunk)
        gap = max(max_err(py_.transpose(1, 2), ry), max_err(ps_, rs))
        ref_err = max(max_err(y.transpose(1, 2), ry), max_err(st, rs))
        limit = gap + SSD_TOL[name]
        log(f"[ssd] K6 b={b} S={S} {name} vs ssd_ref: {ref_err:.3g} (the "
            f"CPU plain version's gap {gap:.3g} + margin {SSD_TOL[name]})")
        if ref_err > limit:
            fail(f"K6 b={b} S={S} {name} lies {ref_err} from ssd_ref, beyond "
                 f"{limit}")
        out_.update(ref_err=ref_err, ref_gap=gap, ref_limit=limit)
    return out_


def ssd_bound(nbytes: float, score_ops: float, prod_ops: float,
              bf16: bool):
    """K6's bound: the bytes over HBM's rate, or the operations at their
    rate, whichever is larger. In bf16 every product runs on the tensor
    cores, at the bf16 rate: C B^T from exact bf16 operands, the products
    with a float32 operand as three bf16 products each (the operand split
    into hi, mid and lo terms, what float32 accuracy takes there). In
    float32 all of them run at the float32 CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((score_ops + 3 * prod_ops) / PEAK_OPS["bfloat16"] if bf16
             else (score_ops + prod_ops) / PEAK_OPS["float32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_ssd(dev) -> list[dict]:
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    inputs, chunk = ssd_layer_inputs(
        dev, ((1, PROMPT_LEN), (1, SSM_LONG_PROMPT), (2, 4096)))
    # the serving prefill: x (1, 48, 32, 64), B/C (1, 32, 128), one chunk
    path = ssd_case(inputs[(1, PROMPT_LEN)], bf16, chunk, 200)
    cases = {"f32": ssd_case(inputs[(1, PROMPT_LEN)], f32, chunk, 200),
             "s300": ssd_case(inputs[(1, SSM_LONG_PROMPT)], bf16, chunk, 50),
             "s300_f32": ssd_case(inputs[(1, SSM_LONG_PROMPT)], f32, chunk,
                                  50, ref=True),
             "b2_s4096": ssd_case(inputs[(2, 4096)], bf16, chunk, 5),
             "b2_s4096_f32": ssd_case(inputs[(2, 4096)], f32, chunk, 5)}
    extra = {f"{tag}_{key}": c[key] for tag, c in cases.items()
             for key in ("ms", "plain_ms", "err", "y_rel_err", "state_err",
                         "route", "bound_ms", "bound_by", "row_err",
                         "mean_err", "fault_row_err") if key in c}
    extra.update(row_tol=SSD_ROW_TOL, mean_tol=SSD_MEAN_TOL,
                 **{k: path[k] for k in ("row_err", "mean_err",
                                         "fault_row_err")})
    extra.update({f"s300_f32_{k}": cases["s300_f32"][k]
                  for k in ("ref_err", "ref_gap", "ref_limit")})
    extra["eager_ms"] = path["eager_ms"]
    # the serving prefill's route ("single" or "chunked"); the row's own
    # "route" stays the contract's "cuda"
    extra["ssd_route"] = path["route"]
    return [row("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan/kernel.py:87", path["ms"],
              path["plain_ms"], path["err"], path["nbytes"], path["ops"],
              "float32", y_rel_err=path["y_rel_err"],
              state_err=path["state_err"], y_max=path["y_max"],
              shape="x (1, 48, 32, 64) B/C (1, 32, 128) bf16, one chunk of "
                    "32 (one launch); s300: S=300, 3 chunks of 128 (the "
                    "last padded); b2_s4096: b=2, S=4096, 32 chunks (three "
                    "launches each); inputs from mamba2-780m's first layer "
                    "at full width",
              rate="bf16: every product at the bf16 tensor-core rate, the "
                   "products with a float32 operand counted three times "
                   "(three bf16 terms); f32: all at the float32 rate",
              bound_at=(path["bound_ms"], path["bound_by"]),
              **extra)]


# ------------------------------------------------------------------ phase 4
def phase_model(dev, arch, long_prompt=0, long_tol=FULL_WIDTH_TOL,
                depth=0) -> None:
    """``arch`` at full width: card vs CPU logits and caches in float32 over
    a (1, 32) prefill and 8 teacher-forced decode steps (and, when
    ``long_prompt`` is set, a prefill of that many tokens, within
    ``long_tol``), at ``depth`` layers when it is given (else the config's);
    then in bf16 at the config's full depth, as an executor holds and serves
    it, the decode step replayed from its CUDA graph and the prefill
    replayed from its own, each against the eager one (bit-equal), with
    their times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.serving.engine import (
        DecodeGraph,
        PrefillGraph,
        make_compiled_steps,
    )

    cfg = get_config(arch)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, size=DECODE_STEPS).astype(np.int32)
    longp = rng.integers(0, cfg.vocab, size=(1, long_prompt)).astype(np.int32)

    t0 = time.perf_counter()
    cfg32 = cfg.with_updates(dtype="float32")
    if depth:
        cfg32 = cfg32.with_updates(n_layers=depth)
    model = build_model(cfg32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    runs, long_s, routes = {}, {}, {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        d = dev if where == "cuda" else torch.device("cpu")
        with routes_recorded(routes.setdefault(where, [])):
            logits, cache = model.prefill(
                p, {"tokens": torch.as_tensor(prompt, device=d)})
            out = [logits.cpu()]
            for t in forced:  # teacher-forced (the dense cache: past its
                # slots)
                logits, cache = model.decode_step(
                    p, cache, {"token": torch.tensor([t], dtype=torch.int32,
                                                     device=d)})
                out.append(logits.cpu())
        long_run = None
        if long_prompt:
            tl = time.perf_counter()
            logits, lc = model.prefill(
                p, {"tokens": torch.as_tensor(longp, device=d)})
            long_run = (logits.cpu(), {k: v.cpu() for k, v in lc.items()})
            long_s[where] = time.perf_counter() - tl
        runs[where] = (out, {k: v.cpu() for k, v in cache.items()}, long_run)
    keys = [k for k in runs["cpu"][1] if k != "pos"]
    errs = []
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        if not torch.isfinite(a).all():
            fail(f"{arch} full-width logits on the card are not finite")
        errs.append(max_err(a, b))
    cache_err = max(max_err(runs["cuda"][1][k], runs["cpu"][1][k])
                    for k in keys)
    if int(runs["cuda"][1]["pos"]) != PROMPT_LEN + DECODE_STEPS:
        fail("the decode position did not advance once per step")
    scale = max(float(runs["cpu"][0][0].abs().max()), 1.0)
    log(f"[model] {arch} full width, {cfg32.n_layers} layers, {n_params:,} "
        f"parameters, float32: card vs CPU max abs logit error per step "
        f"{json.dumps(errs)} (logits up to {scale:.2f}), cache "
        f"({', '.join(keys)}) error {cache_err:.3g}, tolerance "
        f"{FULL_WIDTH_TOL} ({time.perf_counter() - t0:.1f} s)")
    if max(errs) > FULL_WIDTH_TOL or cache_err > FULL_WIDTH_TOL:
        fail(f"{arch} full-width card logits or cache differ from the CPU's "
             f"by {max(errs)} / {cache_err}")
    if cfg.n_experts:
        same_routes(arch, routes["cuda"], routes["cpu"])
    if long_prompt:
        (la, ca), (lb, cb) = runs["cuda"][2], runs["cpu"][2]
        long_err = max_err(la, lb)
        long_cache = max(max_err(ca[k], cb[k]) for k in keys)
        log(f"[model] {arch} {long_prompt}-token prefill, float32: card vs "
            f"CPU max abs logit error {long_err:.3g} (logits up to "
            f"{float(lb.abs().max()):.2f}), cache error {long_cache:.3g}, "
            f"tolerance {long_tol}; the prefill took {long_s['cuda']:.2f} s "
            f"on the card and {long_s['cpu']:.2f} s on the CPU")
        if not torch.isfinite(la).all() or long_err > long_tol \
                or long_cache > long_tol:
            fail(f"{arch} {long_prompt}-token prefill on the card differs "
                 f"from the CPU's by {long_err} / {long_cache}")
    del params, cpu_params, runs
    torch.cuda.empty_cache()

    # bf16 at full depth, as an executor holds and serves it
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=1, device=dev)
    n_params = sum(v.numel() for v in params.values())
    weight_gib = sum(v.numel() * v.element_size()
                     for v in params.values()) / 2**30
    toks = torch.as_tensor(prompt, device=dev)
    tok = torch.zeros(1, dtype=torch.int32, device=dev)
    _, cache = prefill_fn(params, {"tokens": toks})
    _, c2 = decode_fn(params, {k: v.clone() for k, v in cache.items()},
                      {"token": tok})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph = DecodeGraph(decode_fn, params, cache)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph.load(cache)
    eager = {k: v.clone() for k, v in cache.items()}
    diffs, equal = [], True
    for t in forced:
        graph.token.fill_(int(t))
        g = graph.step().clone()
        e, eager = decode_fn(params, eager, {"token": torch.tensor(
            [t], dtype=torch.int32, device=dev)})
        equal &= torch.equal(g, e)
        diffs.append(max_err(g, e))
    equal &= all(torch.equal(graph.cache[k], eager[k]) for k in eager)
    if not equal:
        fail(f"{arch} graph decode differs from the eager step: {diffs}")
    # the prefill graph, for the served prompt and for a second prompt
    # copied into its tokens: logits and every cache tensor bit-equal
    t0 = time.perf_counter()
    pgraph = PrefillGraph(prefill_fn, params, toks)
    torch.cuda.synchronize()
    pcapture_s = time.perf_counter() - t0
    other = torch.as_tensor(rng.integers(0, cfg.vocab, size=prompt.shape),
                            dtype=torch.int32, device=dev)
    p_equal = True
    for tokens in (toks, other):
        pgraph.tokens.copy_(tokens)
        gl, gc = pgraph.run()
        el, ec = prefill_fn(params, {"tokens": tokens})
        p_equal &= torch.equal(gl, el) and set(gc) == set(ec) and all(
            torch.equal(gc[k], ec[k]) for k in ec)
    if not p_equal:
        fail(f"{arch} graph prefill differs from the eager prefill")
    pgraph.tokens.copy_(toks)
    eager_ms = cuda_ms(lambda: decode_fn(params, eager, {"token": tok}), 20)
    step_ms = cuda_ms(graph.step, 50)
    prefill_ms = cuda_ms(lambda: prefill_fn(params, {"tokens": toks}), 20)
    prefill_graph_ms = cuda_ms(pgraph.run, 20)
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"[model] {arch} bf16 serving weights, {cfg.n_layers} layers, "
        f"{n_params:,} parameters ({weight_gib:.2f} GiB): set-up "
        f"{build_s:.2f} s, decode graph capture {capture_s:.2f} s (kernels "
        f"per replay {json.dumps(graph.launches_per_replay)}), prefill graph "
        f"capture {pcapture_s:.2f} s (kernels per replay "
        f"{json.dumps(pgraph.launches_per_replay)}); graph decode bit-equal "
        f"to eager over {DECODE_STEPS} steps ({equal}); graph prefill "
        f"bit-equal to eager on 2 prompts ({p_equal}); prefill "
        f"{prefill_ms:.3f} ms eager, {prefill_graph_ms:.3f} ms from the "
        f"graph; decode step {step_ms:.3f} ms from the graph, "
        f"{eager_ms:.3f} ms eager; peak allocated {mem:.1f} GiB")
    del params, graph, pgraph, cache, c2, eager
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routes_recorded(store: list):
    """While open, every MoE router call (``modeling.moe._route``) appends
    to ``store`` the experts each token chose and those it kept, (B, nG, g,
    E) bool masks on the CPU, and the smallest gap between a token's K-th
    and (K+1)-th probability (its top-k margin). Outside an MoE model it
    records nothing."""
    import torch

    from repro_torch.modeling import moe

    route = moe._route

    def recording(cfg, p, xg, C):
        out = route(cfg, p, xg, C)
        probs, _, _, keep, eoh, _ = out
        K = cfg.top_k
        top = torch.topk(probs, min(K + 1, probs.shape[-1]), dim=-1).values
        margin = float((top[..., K - 1] - top[..., K]).min()) \
            if top.shape[-1] > K else float("inf")
        store.append({"chosen": eoh.amax(dim=-2).bool().cpu(),
                      "kept": (eoh * keep[..., None]).amax(dim=-2).bool()
                      .cpu(), "margin": margin})
        return out

    moe._route = recording
    try:
        yield store
    finally:
        moe._route = route


def same_routes(arch, card: list, cpu: list) -> None:
    """The card's routing against the CPU's, router call by router call:
    the same experts chosen and the same assignments kept for every token
    of every layer and step. On a mismatch the smallest top-k margin says
    how near a tie the routers were."""
    import torch

    margin = min(r["margin"] for r in card + cpu)
    chosen = sum(int(r["chosen"].sum()) for r in cpu)
    kept = sum(int(r["kept"].sum()) for r in cpu)
    log(f"[model] {arch} routing, card vs CPU: {len(card)} router calls, "
        f"{chosen} assignments, {kept} kept, smallest top-k margin "
        f"{margin:.3g}")
    if len(card) != len(cpu) or not all(
            torch.equal(a["chosen"], b["chosen"])
            and torch.equal(a["kept"], b["kept"]) for a, b in zip(card, cpu)):
        fail(f"{arch}: the card routes differently from the CPU (smallest "
             f"top-k margin {margin:.3g})")


def phase_kv_quant(dev) -> None:
    """llama3.2-1b with the int8 KV cache in bf16 at full depth, as an
    executor holds it: a (1, 32) prefill and 8 teacher-forced decode steps
    (past the cache) beside the unquantized model on the same weights,
    every step's logits within KV_QUANT_TOL of the unquantized model's
    largest |logit|; then the prefill and the decode step replayed from
    their CUDA graphs, bit-equal to the eager ones (logits, int8 K/V and
    scales), with their times."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.serving.engine import (
        DecodeGraph,
        PrefillGraph,
        make_compiled_steps,
    )

    cfg = get_config(ARCH).with_updates(kv_quant=True)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, PROMPT_LEN)),
                             dtype=torch.int32, device=dev)
    forced = rng.integers(0, cfg.vocab, size=DECODE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    model, params, prefill_fn, decode_fn = make_compiled_steps(
        cfg, seed=1, device=dev)
    plain = build_model(cfg.with_updates(kv_quant=False))
    toks = [torch.tensor([t], dtype=torch.int32, device=dev) for t in forced]
    lq, cq = prefill_fn(params, {"tokens": prompt})
    l0, c0 = plain.prefill(params, {"tokens": prompt})
    rel = []
    for step in range(DECODE_STEPS + 1):
        rel.append(float((lq - l0).abs().max() / l0.abs().max()))
        if step < DECODE_STEPS:
            lq, cq = decode_fn(params, cq, {"token": toks[step]})
            l0, c0 = plain.decode_step(params, c0, {"token": toks[step]})
    if cq["k"].dtype != torch.int8 or cq["k_scale"].dtype != torch.float32:
        fail(f"the int8 cache holds {cq['k'].dtype} / {cq['k_scale'].dtype}")
    # the graphs, against the eager steps
    pgraph = PrefillGraph(prefill_fn, params, prompt)
    gl, gc = pgraph.run()
    el, ec = prefill_fn(params, {"tokens": prompt})
    p_equal = torch.equal(gl, el) and set(gc) == set(ec) and all(
        torch.equal(gc[k], ec[k]) for k in ec)
    graph = DecodeGraph(decode_fn, params, ec)
    graph.load(ec)
    eager = {k: v.clone() for k, v in ec.items()}
    d_equal = True
    for tok in toks:
        graph.token.copy_(tok)
        g = graph.step().clone()
        e, eager = decode_fn(params, eager, {"token": tok})
        d_equal &= torch.equal(g, e)
    d_equal &= all(torch.equal(graph.cache[k], eager[k]) for k in eager)
    step_ms = cuda_ms(graph.step, 50)
    prefill_graph_ms = cuda_ms(pgraph.run, 20)
    mem = torch.cuda.max_memory_allocated() / 2**30
    log(f"[model] {ARCH} kv_quant bf16, {cfg.n_layers} layers: logits vs "
        f"the unquantized model's, of its largest |logit|, per step "
        f"{json.dumps(rel)} (limit {KV_QUANT_TOL}); graph prefill bit-equal "
        f"to eager ({p_equal}), graph decode bit-equal over {DECODE_STEPS} "
        f"steps ({d_equal}); prefill {prefill_graph_ms:.3f} ms from the "
        f"graph, decode step {step_ms:.3f} ms from the graph (kernels per "
        f"replay {json.dumps(graph.launches_per_replay)}); peak allocated "
        f"{mem:.1f} GiB")
    if max(rel) > KV_QUANT_TOL:
        fail(f"{ARCH} kv_quant logits are {max(rel)} of the unquantized "
             f"model's scale away")
    if not (p_equal and d_equal):
        fail(f"{ARCH} kv_quant graphs differ from the eager steps "
             f"(prefill {p_equal}, decode {d_equal})")
    del params, graph, pgraph, cq, c0, ec, eager
    torch.cuda.empty_cache()


def phase_vlm(dev) -> None:
    """internvl2-26b: float32 at full width and VLM_DEPTH layers, card vs
    CPU, a prefill of its 1,024 projected vision embeddings (random, from a
    seed) and 32 tokens, then 8 teacher-forced decode steps, logits and
    caches within FULL_WIDTH_TOL; then in bf16 at full depth, as an
    executor would hold it, one eager prefill with the vision prefix:
    time, peak memory, finite logits."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model

    cfg = get_config(VLM_ARCH)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, size=(1, PROMPT_LEN)).astype(np.int32)
    vision = rng.normal(size=(1, cfg.vision_tokens, cfg.vision_feat_dim)) \
        .astype(np.float32)
    forced = rng.integers(0, cfg.vocab, size=DECODE_STEPS).astype(np.int32)
    t0 = time.perf_counter()
    cfg32 = cfg.with_updates(dtype="float32", n_layers=VLM_DEPTH)
    model = build_model(cfg32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen, device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    n_params = sum(v.numel() for v in params.values())
    runs, secs = {}, {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        d = dev if where == "cuda" else torch.device("cpu")
        tp = time.perf_counter()
        logits, cache = model.prefill(p, {
            "tokens": torch.as_tensor(prompt, device=d),
            "vision_embeds": torch.as_tensor(vision, device=d)})
        secs[where] = time.perf_counter() - tp
        out = [logits.cpu()]
        for t in forced:  # past the 1,056-slot cache
            logits, cache = model.decode_step(p, cache, {
                "token": torch.tensor([t], dtype=torch.int32, device=d)})
            out.append(logits.cpu())
        runs[where] = (out, {k: v.cpu() for k, v in cache.items()})
    errs = [max_err(a, b) for a, b in zip(runs["cuda"][0], runs["cpu"][0])]
    keys = [k for k in runs["cpu"][1] if k != "pos"]
    cache_err = max(max_err(runs["cuda"][1][k], runs["cpu"][1][k])
                    for k in keys)
    S = cfg.vision_tokens + PROMPT_LEN
    log(f"[model] {VLM_ARCH} full width, {VLM_DEPTH} layers, {n_params:,} "
        f"parameters, float32, a prefill of {cfg.vision_tokens} vision "
        f"embeddings and {PROMPT_LEN} tokens: card vs CPU max abs logit error "
        f"per step {json.dumps(errs)} (logits up to "
        f"{float(runs['cpu'][0][0].abs().max()):.2f}), cache error "
        f"{cache_err:.3g}, tolerance {FULL_WIDTH_TOL}; the prefill took "
        f"{secs['cuda']:.2f} s on the card, {secs['cpu']:.2f} s on the CPU "
        f"({time.perf_counter() - t0:.1f} s)")
    if not all(torch.isfinite(a).all() for a in runs["cuda"][0]) \
            or int(runs["cuda"][1]["pos"]) != S + DECODE_STEPS:
        fail(f"{VLM_ARCH}: non-finite logits or a wrong position on the card")
    if max(errs) > FULL_WIDTH_TOL or cache_err > FULL_WIDTH_TOL:
        fail(f"{VLM_ARCH} full-width card logits or cache differ from the "
             f"CPU's by {max(errs)} / {cache_err}")
    del params, cpu_params, runs
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 at full depth, drawn as an executor draws its weights
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    params = model.init(gen, device=dev, cast=model.serving_cast)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_gib = sum(v.numel() * v.element_size()
                     for v in params.values()) / 2**30
    batch = {"tokens": torch.as_tensor(prompt, device=dev),
             "vision_embeds": torch.as_tensor(vision, device=dev)}
    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = cuda_ms(lambda: model.prefill(params, batch), 3)
    mem = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"[model] {VLM_ARCH} bf16 serving weights, {cfg.n_layers} layers, "
        f"{model.param_count():,} parameters ({weight_gib:.2f} GiB, drawn in "
        f"{build_s:.1f} s): eager prefill of {cfg.vision_tokens} vision "
        f"embeddings and {PROMPT_LEN} tokens {prefill_ms:.3f} ms, cache "
        f"{tuple(cache['k'].shape)}, peak allocated {mem / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB")
    if not torch.isfinite(logits).all():
        fail(f"{VLM_ARCH} bf16 logits at full depth are not finite")
    if mem >= PEAK_FRACTION * total:
        fail(f"{VLM_ARCH} bf16 prefill peaked at {mem / 2**30:.1f} GiB, over "
             f"{PEAK_FRACTION:.0%} of the card")
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase_audio(dev) -> dict:
    """hubert-xlarge, the audio encoder: (a) float32 at full width and
    AUDIO_DEPTH layers, card vs CPU, on one (1, AUDIO_S) batch of frames
    masked at the config's ``mask_prob``: the ``encode`` logits within
    FULL_WIDTH_TOL, the loss and every gradient within FULL_WIDTH_TOL of
    their scale, K4 launched once a layer by the encode; (b) bf16 at full
    depth as ``make_compiled_steps`` holds it, one encode of each (B, S) of
    AUDIO_ENCODES through its prefill step in a ``recording()`` block (K4
    48 launches, finite float32 logits), then its median time over a few
    more, and the peak memory; (c) ``positions_cost``. Returns the recorded
    encodes' launches."""
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.serving.engine import make_compiled_steps
    from repro_torch.training.train_loop import _value_and_grad

    cfg = get_config(AUDIO_ARCH)
    rng = np.random.default_rng(0)
    arrays = {"frames": rng.normal(size=(1, AUDIO_S, cfg.frame_feat_dim))
              .astype(np.float32),
              "mask": (rng.random((1, AUDIO_S)) < cfg.mask_prob)
              .astype(np.float32),
              "targets": rng.integers(0, cfg.vocab, size=(1, AUDIO_S))
              .astype(np.int32)}
    t0 = time.perf_counter()
    cfg32 = cfg.with_updates(dtype="float32", n_layers=AUDIO_DEPTH)
    model = build_model(cfg32)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    runs = {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        d = dev if where == "cuda" else torch.device("cpu")
        batch = {k: torch.as_tensor(v, device=d) for k, v in arrays.items()}
        with torch.no_grad(), kernels.recording() as launches:
            logits = model.encode(p, batch)
        for t in p.values():
            t.requires_grad_(True)
        (loss, _), grads = _value_and_grad(model, p, batch)
        runs[where] = (logits.cpu(), float(loss),
                       {k: g.cpu() for k, g in grads.items()}, launches)
    (lg_d, loss_d, g_d, launches), (lg_c, loss_c, g_c, _) = \
        runs["cuda"], runs["cpu"]
    rel = {k: float((g_d[k] - g_c[k]).abs().max()
                    / g_c[k].abs().max().clamp_min(1e-30)) for k in g_c}
    worst = max(rel, key=rel.get)
    res = {"layers": AUDIO_DEPTH, "batch": [1, AUDIO_S],
           "masked": int(arrays["mask"].sum()),
           "params": model.param_count(), "logit_err": max_err(lg_d, lg_c),
           "logit_scale": float(lg_c.abs().max()),
           "loss_card": loss_d, "loss_cpu": loss_c,
           "loss_rel_err": abs(loss_d - loss_c) / abs(loss_c),
           "grad_max_rel_err": rel[worst], "grad_worst": worst,
           "encode_launches": launches, "tol": FULL_WIDTH_TOL,
           "s": time.perf_counter() - t0}
    log(f"[model] {AUDIO_ARCH} full width, float32, card vs CPU: "
        f"{json.dumps(res)}")
    if not torch.isfinite(lg_d).all() or res["logit_err"] > FULL_WIDTH_TOL \
            or res["loss_rel_err"] > FULL_WIDTH_TOL \
            or res["grad_max_rel_err"] > FULL_WIDTH_TOL:
        fail(f"{AUDIO_ARCH} float32 on the card differs from the CPU: {res}")
    if launches != {"flash_attention": AUDIO_DEPTH}:
        fail(f"{AUDIO_ARCH}'s float32 encode launched {launches}, expected "
             f"K4 once a layer")
    del params, cpu_params, runs, g_d, g_c
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 at full depth, as make_compiled_steps holds it
    t0 = time.perf_counter()
    model, params, prefill_fn, _ = make_compiled_steps(cfg, seed=1,
                                                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weight_gib = sum(v.numel() * v.element_size()
                     for v in params.values()) / 2**30
    total = torch.cuda.get_device_properties(dev).total_memory
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {"launches": {}, "encodes": []}
    for B, S in AUDIO_ENCODES:
        batch = {"frames": torch.randn((B, S, cfg.frame_feat_dim),
                                       generator=gen, device=dev)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with kernels.recording() as launches:
            logits, cache = prefill_fn(params, batch)
            torch.cuda.synchronize()
        if cache is not None or logits.dtype != torch.float32 \
                or tuple(logits.shape) != (B, S, cfg.vocab) \
                or not torch.isfinite(logits).all():
            fail(f"{AUDIO_ARCH} bf16 encode at {(B, S)}: logits "
                 f"{logits.dtype} {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}, cache {cache}")
        if launches != {"flash_attention": cfg.n_layers}:
            fail(f"{AUDIO_ARCH}'s bf16 encode launched {launches}, expected "
                 f"K4 once a layer")
        reps = 5 if S < 4096 else 3
        times = [cuda_ms(lambda: prefill_fn(params, batch), 1, warmup=0)
                 for _ in range(reps)]
        ms = float(np.median(times))
        peak = torch.cuda.max_memory_allocated()
        enc = {"batch": [B, S], "median_ms": ms, "ms": times,
               "frames_per_s": B * S / (ms / 1e3),
               "peak_gib": peak / 2**30, "peak_fraction": peak / total,
               "logit_max": float(logits.abs().max()), "launches": launches}
        log(f"[model] {AUDIO_ARCH} bf16 serving weights, {cfg.n_layers} "
            f"layers, {model.param_count():,} parameters ({weight_gib:.2f} "
            f"GiB, set up in {build_s:.2f} s), encode {(B, S)}: "
            f"{json.dumps(enc)}")
        if peak >= PEAK_FRACTION * total:
            fail(f"{AUDIO_ARCH} encode {(B, S)} peaked at "
                 f"{peak / 2**30:.1f} GiB, over {PEAK_FRACTION:.0%} of the "
                 f"card")
        for name, n in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + n
        out["encodes"].append(enc)
        del batch, logits
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["positions"] = positions_cost(cfg, model.dtype, dev)
    return out


def positions_cost(cfg, dtype, dev) -> dict:
    """What ``sinusoidal_positions``'s cache saves an encode: the host
    clock's ms of one table made anew (numpy float64, cast, copied to the
    card) and of one cached lookup, and the table's bytes on the card, at
    each S of AUDIO_ENCODES."""
    import torch

    from repro_torch.modeling.layers import sinusoidal_positions

    res = {}
    for _, S in AUDIO_ENCODES:
        ms = {}
        for tag, fn in (("new", sinusoidal_positions.__wrapped__),
                        ("cached", sinusoidal_positions)):
            fn(S, cfg.d_model, dtype, dev)  # the cache's entry, a warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = fn(S, cfg.d_model, dtype, dev)
            torch.cuda.synchronize()
            ms[f"{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        ms["card_mib"] = table.numel() * table.element_size() / 2**20
        res[S] = ms
    log(f"[model] {AUDIO_ARCH} sinusoidal positions, new vs cached: "
        f"{json.dumps(res)}")
    return res


# ------------------------------------------------------------------ phase 5
def phase_live(dev, arch) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.serving import (
        SliceSpec,
        calibrate_catalog,
        llm_workload,
        make_live_runtime,
    )
    from repro_torch.serving.engine import (
        replayed_launches,
        reset_replayed_launches,
    )

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = [SliceSpec(f"slice{c}", c) for c in LIVE_SLICES[arch]]
    cat = calibrate_catalog(cfg, specs, n_tasks=8, n_cold=1, device=dev)
    calib_peak = torch.cuda.max_memory_allocated()
    calib_s = time.perf_counter() - t0
    log(f"[live] calibrated {len(specs)} slices of {arch} in {calib_s:.1f} "
        f"s: cold start {cat.start_cold.mean:.1f} +- "
        f"{cat.start_cold.std:.1f} ms, warm start "
        f"{cat.start_warm.mean:.3f} ms")
    rt = make_live_runtime(cat, MinLatencyPolicy(c_max=LIVE_C_MAX,
                                                 alpha=LIVE_ALPHA), device=dev)
    tasks = llm_workload(48, rate_per_s=20.0, seed=1, mean_tokens=96.0)
    kernels.reset_launch_counts()
    reset_replayed_launches()
    t0 = time.perf_counter()
    res = rt.serve(tasks)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    replayed = replayed_launches()
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    pool = rt.backend.pool
    hist = {}
    for target in res.records.targets:
        hist[target] = hist.get(target, 0) + 1
    # the edge FIFO's waits apart from the cloud dispatches' waits at the
    # pool's resident cap (which the pool counts itself)
    wait = np.asarray(res.records.queue_wait_ms)
    at_edge = np.isin(np.asarray(res.records.targets), list(pool.edges))
    edge_waits = wait[at_edge & (wait > 0)]
    log(f"[live] {arch}: served {res.n} tasks in {serve_s:.1f} s: avg actual "
        f"latency {res.avg_actual_latency_ms:.2f} ms, p95 "
        f"{res.p95_actual_latency_ms:.2f} ms, latency_error_pct "
        f"{res.latency_error_pct:.2f}, cost {res.total_actual_cost:.6f}, "
        f"placements {json.dumps(dict(sorted(hist.items())))}, cold starts "
        f"{int(np.count_nonzero(res.records.actual_cold))} (predicted "
        f"{int(np.count_nonzero(res.records.predicted_cold))}), waited at "
        f"the cap {pool.cap_waits} (mean "
        f"{pool.cap_wait_ms / max(pool.cap_waits, 1):.2f} ms), waited in the "
        f"edge FIFO {edge_waits.size} (mean "
        f"{float(edge_waits.mean()) if edge_waits.size else 0.0:.2f} ms), "
        f"failed "
        f"{res.n_failed}, peak resident executors {pool.peak_resident} "
        f"(cap {pool.max_resident}, {pool.reclaimed} reclaimed), "
        f"peak allocated {peak / 2**30:.1f} of {total / 2**30:.1f} GiB "
        f"({calib_peak / 2**30:.1f} GiB in the calibration), launches "
        f"{json.dumps(counts)}, replayed from prefill and decode graphs "
        f"{json.dumps(replayed)}")
    if res.n != len(tasks) or res.n_failed or res.n_shed:
        fail(f"{arch} live serve: {res.n} of {len(tasks)} served, "
             f"{res.n_failed} failed, {res.n_shed} shed")
    if not np.isfinite(res.avg_actual_latency_ms):
        fail(f"{arch} live serve latency is not finite")
    if pool.max_resident is not None \
            and pool.peak_resident > pool.max_resident:
        fail(f"{arch} live serve held {pool.peak_resident} models, over the "
             f"pool's cap of {pool.max_resident}")
    if peak >= 0.9 * total:
        fail(f"{arch} live serve peak memory {peak / 2**30:.1f} GiB is over "
             "90% of the card")
    for k in LIVE_KERNELS[arch]:
        if counts[k] + replayed.get(k, 0) <= 0:
            fail(f"{k} was not launched by the {arch} live serve")
    # what the graphs replay, per layer of the kind that runs each kernel:
    # a prefill graph K4 (dense), K6 (SSM) or K3 and K4 (hybrid); a decode
    # graph K5 (dense, hybrid) or no kernel of the port (SSM)
    if cfg.family == "hybrid":
        from repro_torch.modeling.griffin import layer_kinds

        per = {"linear_scan": layer_kinds(cfg).count("rec"),
               "flash_attention": layer_kinds(cfg).count("attn"),
               "decode_attention": layer_kinds(cfg).count("attn")}
    elif cfg.family == "ssm":
        per = {"ssd_scan": cfg.n_layers}
    else:
        per = {"flash_attention": cfg.n_layers,
               "decode_attention": cfg.n_layers}
    if set(replayed) != set(per) or any(replayed[k] % n
                                        for k, n in per.items()):
        fail(f"{arch}: prefill and decode graphs replayed {replayed}, not "
             f"whole multiples of {per}")
    return {"launches": {k: counts[k] for k in LIVE_KERNELS[arch]},
            "graph_replayed": replayed}


# ------------------------------------------------------------------ phase 3
def compare(name, ref, res, exact: bool) -> dict:
    import numpy as np

    a, b = ref.records, res.records
    if len(a) != len(b):
        fail(f"{name}: {len(b)} records vs {len(a)}")
    if not np.array_equal(np.asarray(a.target_codes),
                          np.asarray(b.target_codes)):
        fail(f"{name}: target codes differ from the oracle")
    bit = True
    worst = 0.0
    for col in ALL_COLS:
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        same = np.array_equal(x, y)
        bit &= same
        if col in DECISION_COLS + ("actual_cold",) and not same:
            fail(f"{name}: {col} differs from the oracle")
        if not same and col in FLOAT_COLS + ("actual_latency_ms",):
            err = float(np.max(np.abs(x - y) / np.maximum(np.abs(x), 1e-300)))
            worst = max(worst, err)
            if not np.allclose(x, y, rtol=FLOAT_TOL, atol=1e-12):
                fail(f"{name}: {col} beyond {FLOAT_TOL} (rel {err})")
    if exact and not bit:
        fail(f"{name}: not identical to the oracle")
    return {"bit_identical": bit, "max_rel_err": worst}


def serve(ctx, policy_fn, device, backend):
    from repro_torch import kernels

    rt = runtime(ctx, policy_fn(), device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.serve_stream(iter(ctx["chunks"]), chunk_size=CHUNK,
                          array_backend=backend)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    return rt, res, secs, counts


def phase_serve(ctx, dev) -> dict:
    from repro_torch.core.decision import MinCostPolicy, MinLatencyPolicy
    from repro_torch.kernels.gbrt_predict.kernel import gbrt_predict_blocked

    launches = {}
    policies = (("min_latency", lambda: MinLatencyPolicy(c_max=C_MAX,
                                                         alpha=ALPHA)),
                ("min_cost", lambda: MinCostPolicy(deadline_ms=DEADLINE_MS)))
    for name, policy_fn in policies:
        oracle, ref, secs, counts = serve(ctx, policy_fn, "cpu", "numpy")
        if any(counts.values()):
            fail(f"{name}: the CPU oracle launched kernels {counts}")
        log(f"[serve] {name} numpy oracle (cpu): {secs:.1f} s, "
            f"{N_TASKS / secs:.0f} tasks/s, {split(oracle)}")
        rt, res, secs, counts = serve(ctx, policy_fn, dev, "torch")
        r = rt.stream_stats["residency"]
        cmp = compare(f"{name} torch", ref, res, exact=False)
        log(f"[serve] {name} torch (cuda): {secs:.1f} s, "
            f"{N_TASKS / secs:.0f} tasks/s, {split(rt)}, "
            f"launches {json.dumps(counts)}, "
            f"residency {json.dumps(r)}, pool regrows "
            f"{_core(rt).pool_regrows} (pool cap "
            f"{rt.engine.torch_stats['pool_cap']}; the replays after those "
            f"walks return at once, so "
            f"{counts['state_replay'] - _core(rt).pool_regrows} replays "
            f"run), vs oracle {json.dumps(cmp)}")
        if r["chunk_commits"] or r["fallback_syncs"] or r["fallback_chunks"] \
                or r["state_syncs"] != 1 or r["resident_chunks"] != 4:
            fail(f"{name}: residency counters {r}")
        for k in ("gbrt_predict_multi", "linear_scan", "state_replay",
                  "state_walk"):
            if name == "min_latency" or k != "linear_scan":
                if counts[k] <= 0:
                    fail(f"{name}: {k} was not launched on the torch path")
        if counts["gbrt_predict_multi"] != len(ctx["chunks"]):
            fail(f"{name}: K1 ran {counts['gbrt_predict_multi']} times, not "
                 f"once per chunk")
        if name == "min_latency":
            launches.update({k: counts[k] for k in
                             ("gbrt_predict_multi", "linear_scan",
                              "state_replay", "state_walk")})
            min_latency_oracle = ref
        else:
            rt, res, secs, counts = serve(ctx, policy_fn, dev, "numpy")
            cmp = compare(f"{name} numpy on cuda", ref, res, exact=True)
            log(f"[serve] {name} numpy (cuda): {secs:.1f} s, "
                f"{N_TASKS / secs:.0f} tasks/s, {split(rt)}, launches "
                f"{json.dumps(counts)}, vs oracle {json.dumps(cmp)}")
            k2_routes = dict(gbrt_predict_blocked.routes)
            log(f"[serve] {name} numpy (cuda): K2 routes "
                f"{json.dumps(k2_routes)}")
            if counts["gbrt_predict_blocked"] != \
                    len(CONFIGS) * len(ctx["chunks"]) \
                    or k2_routes != {"table": counts["gbrt_predict_blocked"],
                                     "walk": 0}:
                fail(f"the host prediction pass ran K2 {k2_routes}, not on "
                     f"its table route once per config and chunk")
            launches["gbrt_predict_blocked"] = counts["gbrt_predict_blocked"]
    return {"launches": launches, "oracle": min_latency_oracle}


# ------------------------------------------------------------------ phase 4
PATH_KERNELS = ("gbrt_predict_multi", "linear_scan", "state_walk",
                "state_replay")


def shard_launches(name, stats: dict, chunks: int) -> None:
    """A shard on the card runs K1 once per chunk and at least one walk, one
    replay and (MinLatency) one linear scan."""
    got = stats["launches"]
    if got.get("gbrt_predict_multi") != chunks or any(
            got.get(k, 0) < 1 for k in PATH_KERNELS[1:]):
        fail(f"{name}: shard launches {got}, expected K1 x {chunks} and at "
             f"least one of {PATH_KERNELS[1:]}")


def plan_candidates():
    """The 8 candidates of benchmarks/bench_runtime.py::run_trace_planner:
    fleets of 1-4 devices x {edge-only, mixed C_MAX/ALPHA}."""
    from repro_torch.planner import Candidate, PolicySpec

    edge_only = PolicySpec(kind="min_latency", c_max=0.0)
    mixed = PolicySpec(kind="min_latency", c_max=C_MAX, alpha=ALPHA)
    return [Candidate.make(f"fleet-{k}-{tag}", k, policy=pol,
                           cloud_configs=CONFIGS, chunk_size=CHUNK,
                           device_rate_per_hour=PLAN_RATE)
            for k in (1, 2, 3, 4)
            for tag, pol in (("edge", edge_only), ("mixed", mixed))]


def record_trace(twin, n: int, app: str):
    """``n`` Poisson arrivals of ``app`` (``twin.poisson(seed=3)``) recorded
    as a trace, column by column (as bench_runtime._record_trace)."""
    import numpy as np

    from repro_torch.trace import Trace

    cols = ([], [], [])
    for c in twin.poisson(seed=3).chunks(n, CHUNK):
        for col, a in zip(cols, (c.arrival_ms, c.size, c.bytes)):
            col.append(a)
    return Trace.from_arrays(*(np.concatenate(x) for x in cols),
                             app_names=(app,))


def plan_part(name, n, secs, launches, verdict) -> None:
    log(f"[plan] ({name}) {secs:.1f} s, {n / secs:.0f} tasks/s, launches "
        f"{json.dumps(launches)}: {verdict}")


def phase_plan(ctx, dev, oracle) -> None:
    """The planner's path on the card: (a) capture and replay, (b) three-app
    shards in sequential, thread and spawned-process mode, (c) the 8-candidate
    halving search, (d) its grid against the numpy oracle, (e) a faulted
    stream and its replay."""
    from repro_torch import kernels
    from repro_torch.core.decision import MinLatencyPolicy
    from repro_torch.trace import TraceWorkload, capture, load

    # (a) the phase-3 MinLatency stream once more, captured and replayed
    rt = runtime(ctx, MinLatencyPolicy(c_max=C_MAX, alpha=ALPHA), dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.serve_stream(iter(ctx["chunks"]), chunk_size=CHUNK,
                          array_backend="torch", keep_inputs=True)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    cmp = compare("plan (a) card stream", oracle, res, exact=False)
    trace = capture(res, app="STT", observed=True)
    out = ROOT / "build" / "plan"
    out.mkdir(parents=True, exist_ok=True)
    t1 = time.perf_counter()
    for ext in ("jsonl", "npz"):
        path = out / f"stt.{ext}"
        trace.save(path)
        if not load(path).equal(trace):
            fail(f"plan (a): the {ext} round trip is not equal")
    io_s = time.perf_counter() - t1
    plan_part("a stream", N_TASKS, secs, counts,
              f"vs oracle {json.dumps(cmp)}; capture + JSONL/NPZ round "
              f"trips equal in {io_s:.1f} s")
    rt = runtime(ctx, MinLatencyPolicy(c_max=C_MAX, alpha=ALPHA), dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rt.serve_stream(TraceWorkload(trace).chunks(chunk_size=CHUNK),
                          array_backend="torch")
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    compare("plan (a) replay vs card stream", res, rep, exact=True)
    if counts["gbrt_predict_multi"] != len(ctx["chunks"]):
        fail(f"plan (a) replay: K1 ran {counts['gbrt_predict_multi']} times")
    plan_part("a replay", N_TASKS, secs, counts,
              "bit-identical to the card stream")

    stt = plan_shards(dev)
    plan_search(stt, dev)
    plan_oracle(trace, dev)
    plan_faults(dev)


def plan_shards(dev):
    """(b) IR, FD and STT as one merged trace, evaluated as one candidate in
    the three modes; per-shard records identical, K1 once per chunk.
    Returns the STT trace."""
    from repro_torch.planner import SLO, Candidate, Planner, PolicySpec
    from repro_torch.planner.candidates import fitted
    from repro_torch.trace import merge

    t0 = time.perf_counter()
    mixed = merge({app: record_trace(
        fitted(app, seed=0, n_inputs=120, configs=CONFIGS)[0], N_SHARD, app)
        for app in PLAN_APPS})
    log(f"[plan] (b) {mixed.n} tasks of {mixed.app_names} recorded and "
        f"merged in {time.perf_counter() - t0:.1f} s")
    mixed3 = Candidate("mixed3", tuple(FLEET.items()),
                       PolicySpec("min_latency", c_max=C_MAX, alpha=ALPHA),
                       cloud_configs=CONFIGS)
    planner = Planner(mixed, SLO(PLAN_SLO_MS, PLAN_SLO_TARGET),
                      fit_configs=CONFIGS, device=str(dev))
    chunks = -(-N_SHARD // CHUNK)
    runs = {}
    for mode, kw in (("sequential", {"parallel": False}),
                     ("thread", {}), ("process", {"use_processes": True})):
        t0 = time.perf_counter()
        score = planner.evaluate([mixed3], **kw)[0]
        secs = time.perf_counter() - t0
        sharded = planner.last_sharded
        if sharded.mode != mode:
            fail(f"plan (b): ran in {sharded.mode}, not {mode}")
        for app in PLAN_APPS:
            shard_launches(f"plan (b) {mode} {app}",
                           sharded.stream_stats[f"mixed3/{app}"], chunks)
        runs[mode] = (sharded, score)
        plan_part(f"b {mode}", mixed.n, secs,
                  {app: sharded.stream_stats[f"mixed3/{app}"]["launches"]
                   for app in PLAN_APPS},
                  f"attainment {score.attainment}, total cost "
                  f"{score.total_cost}, shard walls "
                  f"{json.dumps({k: round(v, 2) for k, v in sharded.wall_s.items()})}")
    base = runs["sequential"][0]
    for mode in ("thread", "process"):
        for shard, r in base.results.items():
            compare(f"plan (b) {mode} {shard}", r,
                    runs[mode][0].results[shard], exact=True)
    log("[plan] (b) per-shard records identical across the three modes")
    return mixed.for_app("STT")


def _scores_match(name, ref, got) -> float:
    if [s.candidate.name for s in ref] != [s.candidate.name for s in got]:
        fail(f"{name}: ranking {[s.candidate.name for s in got]} differs "
             f"from the oracle's {[s.candidate.name for s in ref]}")
    worst = 0.0
    for a, b in zip(ref, got):
        if (a.n, a.attainment, a.meets_slo, a.per_app_attainment) != \
                (b.n, b.attainment, b.meets_slo, b.per_app_attainment):
            fail(f"{name}: {a.candidate.name} n/attainment differ")
        for f in ("cloud_cost", "fleet_cost", "mean_latency_ms",
                  "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
                  "makespan_ms"):
            x, y = getattr(a, f), getattr(b, f)
            err = abs(x - y) / max(abs(x), 1e-300) if x != y else 0.0
            worst = max(worst, err)
            if err > FLOAT_TOL:
                fail(f"{name}: {a.candidate.name} {f} {y} vs {x}")
    return worst


def plan_search(trace, dev) -> None:
    """(c) the halving search on the card, in threads, over the STT Poisson
    trace of (b) — the trace benchmarks/bench_runtime.py::run_trace_planner
    searches (there at 50,000 tasks). Over (a)'s bursty 40/s trace no
    candidate meets the SLO (the numpy oracle on a CPU: each mixed fleet
    attains 94.69% over all 262,144 tasks, the edge-only fleets rank below
    them in (d)), so there the search could verify no winner."""
    from repro_torch import kernels
    from repro_torch.planner import SLO, Planner

    slo = SLO(PLAN_SLO_MS, PLAN_SLO_TARGET)
    planner = Planner(trace, slo, fit_configs=CONFIGS, device=str(dev))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = planner.plan(plan_candidates(), strategy="halving", rungs=3,
                       min_rung_n=2_048)
    secs = time.perf_counter() - t0
    counts = kernels.launch_counts()
    regrows: dict[str, int] = {}
    for rung in res.stream_stats:
        for shard, st in rung.items():
            cand = shard.split("/")[0]
            regrows[cand] = regrows.get(cand, 0) + \
                st["residency"]["pool_regrows"]
            shard_launches(f"plan (c) {shard}", st, st["chunks"])
    best = res.best
    meeting = [s for s in res.scores if s.meets_slo]
    if res.mode != "thread" or not best.meets_slo or best.n != trace.n \
            or best.total_cost != min(s.total_cost for s in meeting):
        fail(f"plan (c): best {best.candidate.name} (meets "
             f"{best.meets_slo}, n {best.n}) is not the verified cheapest "
             f"SLO-meeting candidate:\n{res.table()}")
    for line in res.table().splitlines():
        log(f"[plan] (c) {line}")
    log(f"[plan] (c) rungs {json.dumps(res.rungs)}; pool regrows per "
        f"candidate {json.dumps(regrows)}")
    plan_part("c halving", res.replayed_tasks, secs, counts,
              f"best {best.candidate.name}, verified on all {best.n} tasks")


def plan_oracle(trace, dev) -> None:
    """(d) the 8 candidates' grid over the first N_ORACLE tasks of (a)'s
    trace, on the card against the numpy oracle on the CPU."""
    from repro_torch import kernels
    from repro_torch.planner import SLO, Planner

    slo = SLO(PLAN_SLO_MS, PLAN_SLO_TARGET)
    prefix = trace.prefix(N_ORACLE)
    grids = {}
    for label, kw in (("numpy (cpu)", {"array_backend": "numpy",
                                       "device": "cpu"}),
                      ("torch (cuda)", {"device": str(dev)})):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        grids[label] = Planner(prefix, slo, fit_configs=CONFIGS, **kw).plan(
            plan_candidates(), strategy="grid")
        secs = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if label.startswith("numpy") and any(counts.values()):
            fail(f"plan (d): the numpy oracle launched kernels {counts}")
        plan_part(f"d grid {label}", grids[label].replayed_tasks, secs,
                  counts, f"best {grids[label].best.candidate.name}")
    worst = _scores_match("plan (d)", grids["numpy (cpu)"].scores,
                          grids["torch (cuda)"].scores)
    log(f"[plan] (d) ranking, n and attainment identical to the numpy "
        f"oracle, floats within {worst} (limit {FLOAT_TOL})")


def plan_faults(dev) -> None:
    """(e) FD under the chaos example's faults, on the card against the
    numpy oracle, then captured with its spec and replayed."""
    from repro_torch import kernels
    from repro_torch.core.decision import DecisionEngine, MinLatencyPolicy
    from repro_torch.core.faults import (
        CircuitBreaker,
        FaultSpec,
        OutageWindow,
        RetryPolicy,
        TransientErrors,
    )
    from repro_torch.core.fit import build_fleet_predictor
    from repro_torch.core.runtime import PlacementRuntime, TwinBackend
    from repro_torch.planner.candidates import fitted
    from repro_torch.trace import TraceWorkload, capture, fault_spec_of

    twin, models = fitted("FD", seed=0, n_inputs=120, configs=CONFIGS)
    chunks = list(twin.poisson(seed=3).chunks(N_FAULT, FAULT_CHUNK))
    span = float(chunks[-1].arrival_ms[-1])
    spec = FaultSpec(seed=7,
                     outages=[OutageWindow("edge1", 0.35 * span, 0.65 * span)],
                     transient=[TransientErrors("1792", 0.15)])

    def run(workload, faults, device, backend):
        pred = build_fleet_predictor(models, dict(FLEET), configs=CONFIGS)
        eng = DecisionEngine(predictor=pred, policy=MinLatencyPolicy(
            c_max=C_MAX, alpha=ALPHA), device=device)
        rt = PlacementRuntime(
            eng, TwinBackend(twin, seed=11, edge_names=tuple(FLEET),
                             edge_speed=FLEET, faults=faults),
            retry=RetryPolicy(max_attempts=4, backoff_ms=50.0,
                              backoff_mult=2.0),
            breaker=CircuitBreaker(threshold=3, probation_ms=30_000.0))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = rt.serve_stream(workload, chunk_size=FAULT_CHUNK,
                              array_backend=backend, keep_inputs=True)
        return rt, res, time.perf_counter() - t0, kernels.launch_counts()

    _, ref, secs, _ = run(iter(chunks), spec, "cpu", "numpy")
    plan_part("e faults numpy (cpu)", N_FAULT, secs, {},
              f"retried {ref.n_retried}, failed {ref.n_failed}")
    rt, res, secs, counts = run(iter(chunks), spec, dev, "torch")
    cmp = compare("plan (e) faulted card stream", ref, res, exact=False)
    fb = rt.stream_stats["residency"]["fallback_chunks"]
    if not (ref.n_retried > 0 and res.n_retried == ref.n_retried
            and np_equal(ref.records.attempts, res.records.attempts)
            and np_equal(ref.records.failed, res.records.failed)):
        fail("plan (e): the card's retries differ from the oracle's")
    if any(counts[k] < 1 for k in PATH_KERNELS):
        fail(f"plan (e): the faulted stream launched {counts}")
    plan_part("e faults torch (cuda)", N_FAULT, secs, counts,
              f"retried {res.n_retried}, failed {res.n_failed}, "
              f"fallback_chunks {fb}, vs oracle {json.dumps(cmp)}")
    trace = capture(res, app="FD", faults=spec)
    if fault_spec_of(trace) != spec:
        fail("plan (e): the captured trace lost its fault spec")
    _, rep, secs, counts = run(
        TraceWorkload(trace).chunks(chunk_size=FAULT_CHUNK),
        fault_spec_of(trace), dev, "torch")
    compare("plan (e) faulted replay", res, rep, exact=True)
    if not np_equal(res.records.attempts, rep.records.attempts):
        fail("plan (e): the replay's retries differ")
    plan_part("e replay", N_FAULT, secs, counts,
              "bit-identical to the faulted card stream")


# ------------------------------------------------------------------ phase 7
def k4b_planted(q, k, v, o, g, causal, window, fault):
    """K4b's plain formulas with one fault planted, in float32 on the card,
    rounded to q's dtype: ``delta`` dropped from dS, the window's edge one
    key too far back, or query head 0 of every group left out of dK."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import NEG_INF, _mask

    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    qf, gf, of = (t.float().reshape(B, Hkv, G, S, D) for t in (q, g, o))
    kf, vf = k.float(), v.float()
    mask = _mask(S, S, causal, window + (fault == "window"), q.device)
    s = torch.where(mask, torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale,
                    NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = torch.einsum("bkgqd,bksd->bkgqs", gf, vf)
    delta = 0.0 if fault == "delta" else (gf * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, gf)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    if fault == "gqa":
        ds, qf = ds[:, :, 1:], qf[:, :, 1:]
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return tuple(t.to(q.dtype) for t in (dq.reshape(B, H, S, D), dk, dv))


def k4b_row_err(got, want) -> float:
    """The largest, over rows of dq, dk and dv, of a row's max |got - want|
    over its largest |want|, that scale floored at K4B_ROW_FLOOR of the
    tensor's largest |want|: a row whose exact gradient is 0 (a causal
    query that sees only itself has dq = 0) holds float32 noise on both
    sides."""
    import torch

    worst = 0.0
    for a, b in zip(got, want):
        a, b = (t.float().reshape(-1, t.shape[-1]) for t in (a, b))
        scale = b.abs().amax(-1).clamp_min(K4B_ROW_FLOOR * float(b.abs().max()))
        worst = max(worst, float(((a - b).abs().amax(-1) / scale).max()))
    return worst


def k4b_f32_err(got, want) -> float:
    """The largest |got - want| / max(1, |want|) over dq, dk and dv."""
    return max(float(((a.float() - b.float()).abs()
                      / b.float().abs().clamp_min(1.0)).max())
               for a, b in zip(got, want))


def k4b_case(shape, dtype, dev, causal, window, reps, faults=()):
    """K4b against its plain version at one shape (B, H, Hkv, S, D), fed the
    lse K4 writes (held to the plain version's), with the planted faults of
    ``faults`` (bf16), its time and TFLOP/s, its kernels' device time, its
    plain version's time and SDPA's forward + backward less its
    forward."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        _mask,
        bwd_splits,
        flash_attention_bhsd,
        flash_attention_bwd_bhsd,
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    B, H, Hkv, S, D = shape
    q, k, v = attn_inputs((B, H, Hkv, S, S, D), dtype, dev, seed=D + window)
    g = torch.as_tensor(np.random.default_rng(D).normal(size=(B, H, S, D)),
                        dtype=dtype).to(dev)
    kw = dict(causal=causal, window=window)
    # what FlashAttentionFn saves: K4's output and its row log-sum-exp
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    o = flash_attention_bhsd(q, k, v, lse=lse, **kw)
    _, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_bhsd(q, k, v, o, g, lse=lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, g, **kw)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    res = {"err": max(max_err(a, b) for a, b in zip(got, want)),
           "lse_err": max_err(lse, want_lse)}
    del want_lse
    if not res["lse_err"] <= LSE_TOL:
        fail(f"K4's lse {shape} {name} window={window} differs from the "
             f"plain version's by {res['lse_err']}")
    if dtype == torch.float32:
        res["rel_err"] = k4b_f32_err(got, want)
        if res["rel_err"] > K4B_F32_TOL:
            fail(f"K4b {shape} float32 window={window} differs from its "
                 f"plain version by {res['rel_err']} of max(1, |grad|)")
    else:
        res["nsplit"] = bwd_splits(B, Hkv, S, H // Hkv)
        res["row_err"] = k4b_row_err(got, want)
        if res["row_err"] > K4B_ROW_TOL:
            fail(f"K4b {shape} bf16 window={window}: a row differs from the "
                 f"plain version by {res['row_err']} of its largest |grad|")
        res["fault_row_err"] = {
            f: k4b_row_err(k4b_planted(q, k, v, o, g, causal, window, f),
                           want) for f in faults}
        missed = [f for f, e in res["fault_row_err"].items()
                  if e <= K4B_ROW_TOL]
        if missed:
            fail(f"K4b {shape}: the row limit misses planted faults {missed}:"
                 f" {res['fault_row_err']}")
    del got, want
    mask = _mask(S, S, causal, window, dev)
    pairs = int(mask.sum())
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_kw = dict(attn_mask=mask) if window else dict(is_causal=causal)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*xs, enable_gqa=True, **sdpa_kw)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), xs, g)

    def kernel():
        flash_attention_bwd_bhsd(q, k, v, o, g, lse=lse, **kw)

    product = 2.0 * B * H * pairs * D  # one product over the live pairs
    res.update(
        ms=cuda_ms(kernel, reps),
        plain_ms=cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, g, **kw),
                         2),
        library_ms=cuda_ms(sdpa_fwd_bwd, reps) - cuda_ms(sdpa_fwd, reps),
        k4_ms=cuda_ms(lambda: flash_attention_bhsd(q, k, v, lse=lse, **kw),
                      reps),
        # q, k, v, o and g read once, dq, dk and dv written once; the
        # recompute of S and four products (dP, dV, dQ, dK) on the pairs
        # the mask leaves live
        nbytes=q.element_size() * (4 * q.numel() + 4 * k.numel()),
        ops=5 * product, dtype=name)
    res["tflops"] = res["ops"] / res["ms"] / 1e9
    res["run_tflops"] = 7 * product / res["ms"] / 1e9  # S and dP twice
    res["bound_ms"], res["bound_by"] = bound(res["nbytes"], res["ops"], name)
    log(f"[k4b] {shape} {name} causal={causal} window={window}: "
        f"{json.dumps(res)}")
    return res


def train_launches(cfg) -> dict:
    """The kernel launches of one training step under remat "full": each
    layer's forward kernel twice (forward and recompute), its backward
    kernel once."""
    if cfg.family == "ssm":
        return {"ssd_scan": 2 * cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    pattern = cfg.block_pattern if cfg.family == "hybrid" else ("attn",)
    kinds = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    out = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}
    if n_rec:
        out.update(linear_scan=2 * n_rec, linear_scan_bwd=n_rec)
    return out


def train_step_check(dev, arch, layers, B, S, adamw=False) -> dict:
    """One float32 training step of ``arch`` at full width and ``layers``
    layers (remat "full") on the card and on the CPU from the same
    parameters and batch: the loss, the global grad norm and every
    parameter's gradient (through K4b, K3b, K6b on the card), and with
    ``adamw`` the card's AdamW update against the CPU's AdamW applied to
    the card's gradients."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.train_loop import _value_and_grad

    cfg = get_config(arch).with_updates(n_layers=layers, dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = {k: t.to(dev).requires_grad_(True) for k, t in cpu.items()}
    for t in cpu.values():
        t.requires_grad_(True)
    batch = make_pipeline(cfg, seq_len=S, global_batch=B, seed=0).batch(0)
    with kernels.recording() as launches:
        (loss_d, met_d), g_d = _value_and_grad(
            model, card, {k: torch.as_tensor(v, device=dev)
                          for k, v in batch.items()})
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss_c, met_c), g_c = _value_and_grad(
        model, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = {k: float((g_d[k].cpu() - g_c[k]).abs().max()
                    / g_c[k].abs().max().clamp_min(1e-30)) for k in g_c}
    worst = max(rel, key=rel.get)
    norm_d, norm_c = float(opt.global_norm(g_d)), float(opt.global_norm(g_c))
    mixer = ("/attn/", "/mixer/", "rec_layers/")
    res = {"arch": arch, "layers": layers, "batch": [B, S],
           "params": model.param_count(),
           "loss_card": float(loss_d), "loss_cpu": float(loss_c),
           "loss_rel_err": abs(float(loss_d) - float(loss_c)) / abs(float(loss_c)),
           "grad_norm_rel_err": abs(norm_d - norm_c) / norm_c,
           "grad_max_rel_err": rel[worst], "grad_worst": worst,
           "mixer_grad_max_rel_err": max(v for k, v in rel.items()
                                         if any(m in k for m in mixer)),
           "launches": launches, "cpu_s": cpu_s}
    if cfg.n_experts:  # the MoE layers' load-balancing loss
        res["aux_card"], res["aux_cpu"] = float(met_d["aux"]), \
            float(met_c["aux"])
        res["aux_rel_err"] = abs(res["aux_card"] - res["aux_cpu"]) \
            / abs(res["aux_cpu"])
    if adamw:
        # AdamW: the card's update against the CPU's on the card's gradients
        ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                   decay_steps=10)
        g_dc = {k: t.cpu() for k, t in g_d.items()}
        with torch.no_grad():
            ref = {k: t.detach().clone() for k, t in cpu.items()}
        opt.adamw_update(card, g_d, opt.init_opt_state(card), ocfg)
        opt.adamw_update(ref, g_dc, opt.init_opt_state(ref), ocfg)
        res["adamw_max_abs_err"] = max(float((card[k].detach().cpu() - ref[k])
                                             .abs().max()) for k in ref)
        opt.adamw_update(cpu, g_c, opt.init_opt_state(cpu), ocfg)
        res["params_card_vs_cpu_max_abs"] = max(
            float((card[k].detach().cpu() - cpu[k].detach()).abs().max())
            for k in cpu)
    log(f"[train] (b) {arch} float32 step, card vs CPU: {json.dumps(res)}")
    if res["loss_rel_err"] > FULL_WIDTH_TOL or \
            res.get("aux_rel_err", 0.0) > FULL_WIDTH_TOL or \
            res["grad_norm_rel_err"] > FULL_WIDTH_TOL or \
            res["grad_max_rel_err"] > STEP_GRAD_TOL or \
            res.get("adamw_max_abs_err", 0.0) > ADAMW_TOL:
        fail(f"the float32 training step of {arch} on the card differs from "
             f"the CPU's: {res}")
    want = train_launches(cfg)
    if launches != want:
        fail(f"the float32 step of {arch} launched {launches}, expected "
             f"{want}")
    return res


# the port's kernels in a profiler trace, by kind: (kind, name fragments);
# the first match wins
KERNEL_KINDS = (
    ("k4b", ("fa_bwd",)), ("k4", ("fa_tc_kernel", "fa_f32_kernel")),
    ("k6b", ("ssd_bwd_",)),
    ("k6", ("ssd_chunk_kernel", "ssd_tc_kernel", "ssd_carry_kernel")),
    ("k3b", ("chunk_bwd_",)), ("k3", ("chunk_summary_kernel",
                                     "chunk_apply_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_",
                "splitk")))
BACKWARD_KINDS = ("k3b", "k4b", "k6b")


def step_split(model, params, batch, opt_cfg, want) -> dict:
    """Device ms of one training step of a slice by kind of kernel
    (``torch.profiler``): matmuls (cuBLAS), the port's forward and backward
    kernels (and each backward kernel's launches by name, ``bwd_kernels``),
    and everything else; and the loss (chunked cross-entropy forward +
    backward on the final hidden states) and AdamW (clip + update) timed
    apart. Each step runs in a ``recording()`` block, whose launches must
    be ``want``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.training.train_loop import _value_and_grad

    def step():
        with kernels.recording() as launches:
            _, grads = _value_and_grad(model, params, batch)
            adamw_update(params, grads, state, opt_cfg)
            torch.cuda.synchronize()
        if launches != want:
            fail(f"a step of the slice launched {launches}, expected "
                 f"{want}")

    state = init_opt_state(params)
    torch.cuda.synchronize()
    step()  # warm
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    split = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    split["other"] = 0.0
    others, bwd = {}, {}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0.0) / 1e3
        key = e.key.lower()
        kind = next((k for k, frags in KERNEL_KINDS
                     if any(f.lower() in key for f in frags)), "other")
        split[kind] += ms
        if kind in BACKWARD_KINDS:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = name.split("(")[0]
            bwd[name] = bwd.get(name, 0.0) + ms
        elif kind == "other":
            others[e.key[:80]] = others.get(e.key[:80], 0.0) + ms
    if not sum(split.values()):
        fail("torch.profiler recorded no device time")
    split = {k: v for k, v in split.items() if v or k in ("matmul", "other")}
    split["total"] = sum(split.values())
    split["bwd_kernels"] = bwd
    split["top_other"] = dict(sorted(others.items(),
                                     key=lambda kv: -kv[1])[:8])
    with torch.no_grad():
        h, _ = model.forward(params, batch)
    h.requires_grad_(True)
    split["loss_ms"] = cuda_ms(lambda: torch.autograd.grad(
        model._xent(params, h, batch), (h,)), 2)
    del h
    grads = {k: torch.zeros_like(p) for k, p in params.items()}
    split["adamw_ms"] = cuda_ms(lambda: adamw_update(params, grads, state,
                                                     opt_cfg), 2)
    del grads, state
    return split


def slice_run(dev, arch, B, S, layers=None) -> dict:
    """A slice: ``arch`` at full width (and depth, unless ``layers`` cuts
    it), bf16 compute, float32 master parameters, remat "full",
    TRAIN_STEPS steps of (B, S) through ``train()`` inside one
    ``recording()`` block, whose launches are the slice's; then one step's
    device time by kind on fresh parameters."""
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import LoopConfig, train

    cfg = get_config(arch)
    if (cfg.dtype, cfg.param_dtype, cfg.remat) != ("bfloat16", "float32",
                                                    "full"):
        fail(f"{arch}'s config is not the slice's: {cfg}")
    if layers:
        cfg = cfg.with_updates(n_layers=layers)
    model = build_model(cfg)
    pipe = make_pipeline(cfg, seq_len=S, global_batch=B, seed=0)
    ocfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2,
                           decay_steps=TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with kernels.recording() as launches:
        res = train(model, pipe, LoopConfig(steps=TRAIN_STEPS, log_every=1),
                    ocfg, seed=0, device=dev, log=log)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(dev).total_memory
    step_ms = float(np.median(res.step_s)) * 1e3
    out = {"arch": arch, "layers": cfg.n_layers, "params": model.param_count(),
           "steps": TRAIN_STEPS, "batch": [B, S], "loss_chunk": cfg.loss_chunk,
           "median_step_ms": step_ms, "step_ms": [s * 1e3 for s in res.step_s],
           "tokens_per_s": B * S / (step_ms / 1e3),  # the encoder's: frames
           "peak_gib": peak / 2 ** 30, "peak_fraction": peak / total,
           "loss_first": res.losses[0], "loss_last": res.losses[-1],
           "losses": res.losses, "launches": launches,
           "per_step": {k: n / TRAIN_STEPS for k, n in launches.items()}}
    log(f"[train] (c) {arch} full width, {cfg.n_layers} layers, "
        f"{TRAIN_STEPS} steps: {json.dumps(out)}")
    if not np.all(np.isfinite(res.losses)):
        fail(f"the {arch} slice's losses are not finite: {res.losses}")
    if not res.losses[-1] < res.losses[0]:
        fail(f"the {arch} slice's loss did not fall: {res.losses}")
    if out["peak_fraction"] > PEAK_FRACTION:
        fail(f"the {arch} slice peaked at {out['peak_gib']:.1f} GiB, over "
             f"{PEAK_FRACTION:.0%} of the card")
    want = train_launches(cfg)
    if out["per_step"] != want:
        fail(f"the {arch} slice launched {out['per_step']} per step, "
             f"expected {want} (each forward kernel twice per layer with "
             f"the remat recompute, each backward kernel once)")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    # the step's device time by kind, on fresh parameters and one batch
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init(gen, device=dev)
    for p in params.values():
        p.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch(0).items()}
    out["split_ms"] = step_split(model, params, batch, ocfg, want)
    log(f"[train] (c) {arch}: one step's device ms by kind: "
        f"{json.dumps(out['split_ms'])}")
    del params, batch
    return out


def restart_check(dev) -> dict:
    """Determinism and restart on the ``examples/train_100m_torch.py``
    configuration (float32, remat none): two runs from one seed give the
    same losses, and ``run_with_restarts`` with a failure at step 6 and
    checkpoints every 2 steps (under ``build/``, removed after) matches
    the uninterrupted run within rtol 1e-5 (the reference's own test)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.modeling.registry import build_model
    from repro_torch.training.data import make_pipeline
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (
        FailureInjector,
        LoopConfig,
        run_with_restarts,
        train,
    )

    cfg = get_config(ARCH).with_updates(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32000, dtype="float32", remat="none",
        q_chunk=128, loss_chunk=128, scan_layers=True)
    model = build_model(cfg)
    pipe = make_pipeline(cfg, seq_len=256, global_batch=8, seed=0)
    ocfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=2, decay_steps=10)
    plain = LoopConfig(steps=10, log_every=100, ckpt_every=1000)
    a = train(model, pipe, plain, ocfg, seed=0, device=dev)
    b = train(model, pipe, plain, ocfg, seed=0, device=dev)
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    r = run_with_restarts(model, pipe, LoopConfig(
        steps=10, log_every=100, ckpt_every=2, ckpt_dir=str(ckpt_dir),
        keep=2), ocfg, seed=0, injector=FailureInjector(fail_at=6),
        device=dev)
    restart_s = time.perf_counter() - t0
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.rglob("arrays.npz"))
    elastic = elastic_check(dev, ckpt_dir, model, cfg)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    res = {"params": model.param_count(), "losses": a.losses,
           "repeat_bit_equal": a.losses == b.losses,
           "restarts": r.restarts, "resumed_losses": r.losses,
           "resumed_bit_equal": r.losses == a.losses[6:],
           "resumed_max_rel_err": float(np.max(np.abs(
               np.asarray(r.losses) - np.asarray(a.losses[6:]))
               / np.abs(np.asarray(a.losses[6:])))),
           "checkpoint_gb": ckpt_bytes / 1e9 / 2, "restart_run_s": restart_s,
           "elastic": elastic}
    log(f"[train] (d) train_100m determinism and restart: {json.dumps(res)}")
    if not res["repeat_bit_equal"]:
        fail(f"two runs from one seed gave different losses: {a.losses} / "
             f"{b.losses}")
    if r.restarts != 1 or r.final_step != 10 or \
            res["resumed_max_rel_err"] > 1e-5:
        fail(f"the restarted run does not match the uninterrupted one: {res}")
    return res


def k3b_planted(dh, dfinal, a, h, fault):
    """K3b's plain formulas with one fault planted: the ``dfinal`` seed
    dropped, or a read unshifted (``g_t = dh_t + a_t g_{t+1}``)."""
    import torch

    from repro_torch.kernels.linear_scan.kernel import linear_scan_bwd_plain

    if fault == "dfinal":
        return linear_scan_bwd_plain(dh, None, a, h)
    return linear_scan_bwd_plain(dh, dfinal, torch.roll(a, 1, dims=1), h)


def k6b_planted(x, dt, A, B, C, dy, dstate, chunk, fault):
    """K6b's plain version recomposed from its per-chunk formulas
    (``ssd_chunk_grads``), with one fault planted (None: none): ``cumsum``
    drops the reverse sum of dcum within each chunk, ``carry`` the state
    gradient carried in from the next chunk (every chunk but the last sees
    dh_next = 0), ``head`` leaves head 0 out of dB. Returns (dx, ddt, dA,
    dB, dC) as ``ssd_scan_bwd_plain`` does."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import (
        _padded_chunks,
        chunk_states,
        reverse_cumsum,
        ssd_chunk_grads,
    )

    b, H, S, hd = x.shape
    Q = min(chunk, S)
    xf, dyf, dtf = (_padded_chunks(t, Q, 2) for t in (x, dy, dt))
    Bf, Cf = _padded_chunks(B, Q, 1), _padded_chunks(C, Q, 1)
    states = chunk_states(x, dt, A, B, chunk=chunk)
    dh = dstate.float()
    dx, ddt, dB, dC = (torch.empty_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros(H, dtype=torch.float64, device=x.device)
    for c in range(states.shape[1] - 1, -1, -1):
        sl = slice(c * Q, (c + 1) * Q)
        g = ssd_chunk_grads(xf[:, :, sl], dtf[:, :, sl], A, Bf[:, sl],
                            Cf[:, sl], dyf[:, :, sl], states[:, c], dh)
        da = g["dcum"] if fault == "cumsum" else reverse_cumsum(g["dcum"])
        dx[:, :, sl] = g["dx"]
        ddt[:, :, sl] = g["ddt"] + A.double()[None, :, None] * da
        dA += (dtf[:, :, sl].double() * da).sum((0, 2))
        dB[:, sl] = g["dB"][:, 1:].sum(1) if fault == "head" \
            else g["dB"].sum(1)
        dC[:, sl] = g["dC"].sum(1)
        dh = torch.zeros_like(dh) if fault == "carry" else g["dh_prev"]
    return (dx[:, :, :S].to(x.dtype), ddt[:, :, :S], dA.float(),
            dB[:, :S].to(B.dtype), dC[:, :S].to(C.dtype))


def k3b_case(dev) -> dict:
    """K3b against its plain version at recurrentgemma-9b's training
    recurrence (K3B_SHAPE, float32), the plain version's faults, two runs
    bit-equal; its time, the plain version's, and its byte bound: dh, a and
    h read, dx and da written, once each."""
    import numpy as np
    import torch

    from repro_torch.kernels.linear_scan.kernel import (
        linear_scan_bsd,
        linear_scan_bwd_bsd,
        linear_scan_bwd_plain,
    )

    rng = np.random.default_rng(3)
    x, dh = (torch.as_tensor(rng.normal(size=K3B_SHAPE), dtype=torch.float32,
                             device=dev) for _ in range(2))
    a = torch.as_tensor(rng.uniform(0.1, 1.0, size=K3B_SHAPE),
                        dtype=torch.float32, device=dev)
    dfinal = torch.as_tensor(rng.normal(size=(K3B_SHAPE[0], K3B_SHAPE[2])),
                             dtype=torch.float32, device=dev)
    h, _ = linear_scan_bsd(x, a)
    got = linear_scan_bwd_bsd(dh, dfinal, a, h)
    again = linear_scan_bwd_bsd(dh, dfinal, a, h)
    want = linear_scan_bwd_plain(dh, dfinal, a, h)
    torch.cuda.synchronize()
    res = {"shape": list(K3B_SHAPE), "err": max(max_err(g, w) for g, w in
                                                zip(got, want)),
           "rel_err": k4b_f32_err(got, want),
           "bit_equal": all(bits_equal(g, r) for g, r in zip(got, again)),
           "fault_rel_err": {f: k4b_f32_err(k3b_planted(dh, dfinal, a, h, f),
                                            want)
                             for f in ("dfinal", "unshifted")}}
    if res["rel_err"] > K3B_TOL or not res["bit_equal"]:
        fail(f"K3b differs from its plain version or from itself: {res}")
    missed = [f for f, e in res["fault_rel_err"].items() if e <= K3B_TOL]
    if missed:
        fail(f"K3b's limit misses planted faults {missed}: {res}")
    del got, again, want
    nbytes = 4 * 5 * h.numel()
    res.update(ms=cuda_ms(lambda: linear_scan_bwd_bsd(dh, dfinal, a, h), 20),
               plain_ms=cuda_ms(lambda: linear_scan_bwd_plain(dh, dfinal, a,
                                                              h), 1),
               nbytes=nbytes, ops=3 * h.numel())
    res["bound_ms"], res["bound_by"] = bound(nbytes, res["ops"], "float32")
    log(f"[k3b] {json.dumps(res)}")
    return res


def k6b_bound(b, H, S, hd, ds, Q, nbytes, bf16):
    """K6b's bound: its inputs' and outputs' bytes over HBM's rate, or its
    products by phase 2's rule for K6, whichever is larger. The products
    this data needs, per (batch, chunk) over the q >= s pairs: C B^T (shared
    by the heads) and per head dy x^T, both from exact bf16 operands; P^T dy,
    R B, R^T C, dh_next B, dh_next^T x, and in chunks after the first
    h_prev^T dy and the chunk's exp(cum) dy (x) C, each with a float32
    operand (three bf16 products in bf16, as K6's bound counts them)."""
    exact = prod = 0.0
    for r0 in range(0, S, Q):
        qc = min(Q, S - r0)
        tri = qc * (qc + 1) / 2
        exact += b * 2 * tri * ds + b * H * 2 * tri * hd
        prod += b * H * (2 * tri * hd + 4 * tri * ds + 4 * qc * hd * ds)
        if r0:
            prod += b * H * 4 * qc * hd * ds
    return exact + prod, ssd_bound(nbytes, exact, prod, bf16)


def k6b_case(inputs, chunk, dtype, reps, faults=()) -> dict:
    """K6b against its plain version on mamba2-780m's layer inputs, called
    as ``SSDScanFn`` calls it (K6's workspace of chunk states, strided views,
    dx a transposed view), with a cotangent dy drawn N(0, 1) and a final
    state's drawn N(0, 1): float32 within K6B_TOL of max(1, |grad|), bf16
    rows within K4B_ROW_TOL of their largest |grad| and the planted
    ``faults`` outside it; two runs bit-equal; its time, its plain
    version's, its bound."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_scan_bhsd,
        ssd_scan_bwd_bhsd,
        ssd_scan_bwd_plain,
        work_floats,
    )

    xs, dt, A, B, C = inputs
    dev = xs.device
    x, B, C = xs.to(dtype).transpose(1, 2), B.to(dtype), C.to(dtype)
    dtt = dt.transpose(1, 2)
    b, H, S, hd = x.shape
    ds = B.shape[-1]
    rng = np.random.default_rng(5)
    dy = torch.as_tensor(rng.normal(size=(b, S, H, hd)), dtype=torch.float32,
                         device=dev).to(dtype).transpose(1, 2)
    dstate = torch.as_tensor(rng.normal(size=(b, H, hd, ds)),
                             dtype=torch.float32, device=dev)
    work = torch.empty(work_floats(b, H, S, hd, ds, chunk),
                       dtype=torch.float32, device=dev)
    ssd_scan_bhsd(x, dtt, A, B, C, chunk=chunk, work=work)

    def kernel():
        dx = torch.empty((b, S, H, hd), dtype=dtype,
                         device=dev).transpose(1, 2)
        return ssd_scan_bwd_bhsd(x, dtt, A, B, C, dy, dstate, chunk=chunk,
                                 work=work, dx=dx)

    got, again = kernel(), kernel()
    want = ssd_scan_bwd_plain(x, dtt, A, B, C, dy, dstate, chunk=chunk)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    rows = lambda r: (r[0], r[1], r[2][None], r[3], r[4])  # noqa: E731
    res = {"err": max(max_err(g, w) for g, w in zip(got, want)),
           "bit_equal": all(bits_equal(g, r) for g, r in zip(got, again)),
           "grad_max": {n: float(w.float().abs().max()) for n, w in
                        zip(("dx", "ddt", "dA", "dB", "dC"), want)}}
    if dtype == torch.float32:
        res["rel_err"] = k4b_f32_err(got, want)
        ok = res["rel_err"] <= K6B_TOL
    else:
        res["row_err"] = k4b_row_err(rows(got), rows(want))
        ok = res["row_err"] <= K4B_ROW_TOL
        res["fault_row_err"] = {
            f: k4b_row_err(rows(k6b_planted(x, dtt, A, B, C, dy, dstate,
                                            chunk, f)), rows(want))
            for f in faults}
        missed = [f for f, e in res["fault_row_err"].items()
                  if e <= K4B_ROW_TOL]
        if missed:
            fail(f"K6b's bf16 row limit misses planted faults {missed}: "
                 f"{res}")
    if not ok or not res["bit_equal"]:
        fail(f"K6b b={b} S={S} {name} differs from its plain version or from "
             f"itself: {res}")
    del got, again, want
    el = x.element_size()
    nbytes = el * (3 * x.numel() + 4 * B.numel()) + 4 * 2 * dt.numel() \
        + 4 * 2 * A.numel() + 4 * dstate.numel()
    ops, (b_ms, b_by) = k6b_bound(b, H, S, hd, ds, min(chunk, S), nbytes,
                                  dtype == torch.bfloat16)
    res.update(ms=cuda_ms(kernel, reps),
               plain_ms=cuda_ms(lambda: ssd_scan_bwd_plain(
                   x, dtt, A, B, C, dy, dstate, chunk=chunk), 2),
               k6_ms=cuda_ms(lambda: ssd_scan_bhsd(x, dtt, A, B, C,
                                                   chunk=chunk, work=work),
                             reps),
               nbytes=nbytes, ops=ops, bound_ms=b_ms, bound_by=b_by)
    log(f"[k6b] b={b} S={S} {name}: {json.dumps(res)}")
    return res


def elastic_check(dev, ckpt_dir, model, cfg) -> dict:
    """``elastic_restore`` of the restart run's last checkpoint onto the
    host mesh: every parameter and moment a DTensor on the card with the
    placements of its logical axes, its local tensor bit-equal to
    ``restore_latest``'s on the card."""
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.sharding import (
        Sharding,
        make_rules,
        spec_for,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ckpt

    mesh = make_host_mesh(dev)
    t0 = time.perf_counter()
    step, params, state = elastic_restore(str(ckpt_dir), model, cfg, mesh)
    restore_s = time.perf_counter() - t0
    want_step, tree = ckpt.restore_latest(str(ckpt_dir), dev)
    rules = make_rules(cfg, mesh)
    specs = model.param_specs()
    bad = []
    for k, p in params.items():
        placed = Sharding(mesh, spec_for(specs[k].axes, rules)).placements
        for t, w in ((p, tree["params"][k]),
                     (state["opt"]["m"][k], tree["state"]["opt"]["m"][k]),
                     (state["opt"]["v"][k], tree["state"]["opt"]["v"][k])):
            if tuple(t.placements) != placed \
                    or not bits_equal(t.to_local(), w):
                bad.append(k)
    res = {"step": step, "tensors": 3 * len(params), "restore_s": restore_s,
           "bit_equal": not bad, "device": str(next(iter(
               params.values())).to_local().device)}
    log(f"[train] (d) elastic_restore onto the host mesh: {json.dumps(res)}")
    if bad or step != want_step:
        fail(f"elastic_restore differs from restore_latest: step {step} vs "
             f"{want_step}, tensors {bad[:5]}")
    return res


def phase_train(dev, card) -> dict:
    """(a) K4b against its plain version and SDPA at llama3.2-1b's and
    recurrentgemma-9b's training shapes; (a') K3b and K6b against theirs at
    the slices' shapes; (b) float32 steps on the card against the CPU,
    llama, mamba and Griffin; (c) the slices: llama3.2-1b and mamba2-780m
    trained at full width and depth, recurrentgemma-9b at full width and 3
    layers, olmoe-1b-7b at 4 layers and hubert-xlarge at full width and
    depth (with K4b at its non-causal head_dim-80 attention in (a) and its
    float32 step in (b)); (d) determinism and restart. Returns the rows of
    K4b, K3b and K6b and the slices' launches."""
    import gc

    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    log(f"[train] {card}")
    bf16, f32 = torch.bfloat16, torch.float32
    llama = k4b_case(TRAIN_ATTN, bf16, dev, True, 0, 10, ("delta", "gqa"))
    others = {"f32": k4b_case(TRAIN_ATTN, f32, dev, True, 0, 2),
              "griffin_s4096": k4b_case(GRIFFIN_ATTN, bf16, dev, True, WINDOW,
                                        5, ("delta", "window", "gqa")),
              "griffin_s4096_f32": k4b_case(GRIFFIN_ATTN, f32, dev, True,
                                            WINDOW, 2),
              "olmoe_s2048": k4b_case(MOE_ATTN, bf16, dev, True, 0, 10,
                                      ("delta", "gqa")),
              # hubert-xlarge's: non-causal at head_dim 80, 781 frames (13
              # query tiles, the last partial)
              "hubert_s781": k4b_case(AUDIO_ATTN, bf16, dev, False, 0, 10,
                                      ("delta", "gqa")),
              "hubert_s781_f32": k4b_case(AUDIO_ATTN, f32, dev, False, 0,
                                          2)}
    free()
    k3b = k3b_case(dev)
    free()
    inputs, chunk = ssd_layer_inputs(dev, ((SSM_TRAIN_B, SSM_TRAIN_S),))
    layer = inputs[(SSM_TRAIN_B, SSM_TRAIN_S)]
    k6b = k6b_case(layer, chunk, bf16, 5, ("cumsum", "carry", "head"))
    k6b_f32 = k6b_case(layer, chunk, f32, 3)
    del inputs, layer
    free()
    steps = [train_step_check(dev, ARCH, STEP_LAYERS, STEP_B, STEP_S,
                              adamw=True)]
    free()
    steps.append(train_step_check(dev, SSM_ARCH, SSM_STEP_LAYERS, STEP_B,
                                  SSM_STEP_S))
    free()
    steps.append(train_step_check(dev, HYBRID_ARCH, HYBRID_STEP_LAYERS,
                                  STEP_B, HYBRID_STEP_S))
    free()
    steps.append(train_step_check(dev, MOE_ARCH, STEP_LAYERS, STEP_B,
                                  STEP_S))
    free()
    steps.append(train_step_check(dev, AUDIO_ARCH, AUDIO_DEPTH, STEP_B,
                                  AUDIO_S))
    free()
    slices = [slice_run(dev, ARCH, TRAIN_B, TRAIN_S)]
    free()
    slices.append(slice_run(dev, SSM_ARCH, SSM_TRAIN_B, SSM_TRAIN_S))
    free()
    slices.append(slice_run(dev, HYBRID_ARCH, HYBRID_TRAIN_B, HYBRID_TRAIN_S,
                            HYBRID_TRAIN_LAYERS))
    free()
    slices.append(slice_run(dev, MOE_ARCH, MOE_TRAIN_B, MOE_TRAIN_S,
                            MOE_TRAIN_LAYERS))
    free()
    slices.append(slice_run(dev, AUDIO_ARCH, AUDIO_TRAIN_B, AUDIO_TRAIN_S))
    free()
    rs = restart_check(dev)
    sl, ssm, hyb, olmoe, hubert = slices
    extra = {key: llama[key] for key in
             ("row_err", "fault_row_err", "k4_ms", "lse_err", "nsplit",
              "tflops", "run_tflops")}
    extra.update(row_tol=K4B_ROW_TOL, row_floor=K4B_ROW_FLOOR,
                 f32_tol=K4B_F32_TOL, lse_tol=LSE_TOL)
    for tag, c in others.items():
        extra.update({f"{tag}_{key}": c[key] for key in
                      ("ms", "plain_ms", "library_ms", "err", "bound_ms",
                       "bound_by", "k4_ms", "lse_err", "tflops", "run_tflops",
                       "nsplit", "row_err", "rel_err", "fault_row_err")
                      if key in c})
    extra["train_median_step_ms"] = sl["median_step_ms"]
    extra["train_step_k4b_ms"] = {k: v for k, v in
                                  sl["split_ms"]["bwd_kernels"].items()
                                  if "fa_bwd" in k}
    extra["train_launches_per_step"] = sl["per_step"]["flash_attention_bwd"]
    extra["griffin_train_launches_per_step"] = \
        hyb["per_step"]["flash_attention_bwd"]
    extra["olmoe_train_launches_per_step"] = \
        olmoe["per_step"]["flash_attention_bwd"]
    extra["olmoe_train_step_k4b_ms"] = {
        k: v for k, v in olmoe["split_ms"]["bwd_kernels"].items()
        if "fa_bwd" in k}
    extra["hubert_train_launches_per_step"] = \
        hubert["per_step"]["flash_attention_bwd"]
    extra["hubert_train_step_k4b_ms"] = {
        k: v for k, v in hubert["split_ms"]["bwd_kernels"].items()
        if "fa_bwd" in k}
    rows = [row("flash_attention_bwd",
                "src/repro_torch/csrc/flash_attention_bwd.cu",
                "none; the reference differentiates its XLA chunked "
                "attention, src/repro/modeling/attention.py:50",
                llama["ms"], llama["plain_ms"], llama["err"], llama["nbytes"],
                llama["ops"], "bfloat16", library_ms=llama["library_ms"],
                shape="q/o/do (2, 32, 2048, 64) k/v (2, 8, 2048, 64) bf16 "
                      "causal (llama3.2-1b's training step; f32: the same in "
                      "float32); griffin_s4096: q (1, 16, 4096, 256) k/v "
                      "(1, 1, 4096, 256) causal, window 2048 "
                      "(recurrentgemma-9b), bf16 and float32; olmoe_s2048: "
                      "q/k/v (2, 16, 2048, 128) causal bf16 (olmoe-1b-7b's "
                      "training step); hubert_s781: q/k/v (8, 16, 781, 80) "
                      "non-causal (hubert-xlarge's training step), bf16 and "
                      "float32",
                **extra)]
    rows.append(row(
        "linear_scan_bwd", "src/repro_torch/csrc/linear_scan.cu",
        "none; the reference differentiates its XLA associative scan, "
        "src/repro/modeling/rglru.py:74",
        k3b["ms"], k3b["plain_ms"], k3b["err"], k3b["nbytes"], k3b["ops"],
        "float32", rel_err=k3b["rel_err"], f32_tol=K3B_TOL,
        bit_equal=k3b["bit_equal"], fault_rel_err=k3b["fault_rel_err"],
        train_launches_per_step=hyb["per_step"]["linear_scan_bwd"],
        train_step_k3b_ms={k: v for k, v in
                           hyb["split_ms"]["bwd_kernels"].items()
                           if "chunk_bwd" in k},
        shape="dh/a/h (1, 4096, 4096) float32 (recurrentgemma-9b's "
              "training recurrence: B=1, S=4096, d_rnn 4096; 32 chunks of "
              "128), dfinal (1, 4096)"))
    rows.append(row(
        "ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "none; the reference differentiates its XLA chunked SSD, "
        "src/repro/modeling/ssd.py:61",
        k6b["ms"], k6b["plain_ms"], k6b["err"], k6b["nbytes"], k6b["ops"],
        "bfloat16", bound_at=(k6b["bound_ms"], k6b["bound_by"]),
        row_err=k6b["row_err"], row_tol=K4B_ROW_TOL,
        fault_row_err=k6b["fault_row_err"], bit_equal=k6b["bit_equal"],
        k6_ms=k6b["k6_ms"], f32_tol=K6B_TOL,
        **{f"f32_{k}": k6b_f32[k] for k in ("ms", "plain_ms", "err",
                                             "rel_err", "bound_ms",
                                             "bound_by", "bit_equal",
                                             "k6_ms")},
        train_launches_per_step=ssm["per_step"]["ssd_scan_bwd"],
        train_step_k6b_ms=ssm["split_ms"]["bwd_kernels"],
        shape="x/dy/dx (2, 48, 2048, 64) B/C/dB/dC (2, 2048, 128) bf16, dt "
              "(2, 48, 2048) float32, 16 chunks of 128 (mamba2-780m's "
              "training step; inputs from its first layer at full width, "
              "dy and the final state's cotangent N(0, 1)); f32: the same "
              "in float32",
        rate="bf16: every product at the bf16 tensor-core rate, those with "
             "a float32 operand counted three times; f32: all at the "
             "float32 rate (bf16 runs on the tensor cores, float32 on the "
             "CUDA cores)"))
    launches = {}
    for s_ in slices:
        for name, n in s_["launches"].items():
            launches[name] = launches.get(name, 0) + n
    return {"rows": rows, "launches": launches, "steps": steps,
            "slices": slices, "restart": rs}


# ----------------------------------------------------------- phase 7b, launch
# llama3.2-1b's cells through the launch layer: (shape, the global batch run
# here); the cells' own batches are 256, 32 and 128
LAUNCH_CELLS = (("train_4k", 2), ("prefill_32k", 1), ("decode_32k", 16))
# each cell's kernel launches a step (K4 forward and again in the remat's
# recompute, K4b backward; K4 a layer in the prefill; K5 a layer a decode)
LAUNCH_KERNELS = {"train": {"flash_attention": 32, "flash_attention_bwd": 16},
                  "prefill": {"flash_attention": 16},
                  "decode": {"decode_attention": 16}}
DRYRUN_TIMEOUT_S = 300
LAUNCH_REPS = 5  # timed runs of each cell with the context, and without


def _outputs(kind, out) -> dict:
    """A cell step's outputs as a flat dict of tensors: the train cell's
    loss and updated parameters, a serving cell's logits and cache."""
    if kind == "train":
        params, _, metrics = out
        return {"loss": metrics["loss"].detach(),
                **{f"params/{k}": p.detach() for k, p in params.items()}}
    logits, cache = out
    return {"logits": logits, **{f"cache/{k}": t for k, t in cache.items()}}


def launch_cell(dev, mesh, name, batch, total) -> dict:
    """One of llama3.2-1b's cells at full width: built by ``build_cell`` on
    the host mesh, its peak reckoned, materialized at ``batch`` and run
    once with no context (to warm it; its outputs are the reference), then
    LAUNCH_REPS times under ``sharding_ctx(mesh, cell.rules)`` and as many
    with no context, in turn, each on arguments materialized anew (the
    step donates its cache or optimizer state) and timed on CUDA events;
    every run's outputs bit-equal to the reference's."""
    import gc
    import statistics

    import torch

    from repro_torch import kernels
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import current_ctx, sharding_ctx
    from repro_torch.launch.cost_analysis import analyze_cell
    from repro_torch.launch.steps import build_cell, materialize

    cell = build_cell(get_config(ARCH), SHAPES[name], mesh)
    full = SHAPES[name].global_batch

    def reckon(b):
        est = analyze_cell(cell, global_batch=b)
        # the reference run's outputs stay while another runs: the updated
        # parameters (train), or a second set of arguments (serving)
        mem = est["memory"]
        held = mem["params_bytes"] if cell.kind == "train" \
            else mem["argument_bytes"]
        return est, mem["peak_bytes_estimate"] + held

    est, peak = reckon(batch)
    if cell.kind == "train" and peak > PEAK_FRACTION * total and batch > 1:
        log(f"[launch] {name}: reckoned peak {peak / 2**30:.1f} GiB at batch "
            f"{batch} passes {PEAK_FRACTION:.0%} of the card; batch 1")
        batch = 1
        est, peak = reckon(batch)
    log(f"[launch] {name}: {cell.kind} cell of {ARCH} at full width, global "
        f"batch {batch} (reduced from {full}); reckoned peak "
        f"{peak / 2**30:.1f} GiB of {total / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)

    def run(ctx: bool):
        args = materialize(cell, dev, global_batch=batch, seed=0)
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        with contextlib.ExitStack() as stack:
            rec = stack.enter_context(kernels.recording())
            if ctx:
                stack.enter_context(sharding_ctx(mesh, cell.rules))
                if current_ctx() is None:
                    fail("launch: no sharding context")
            start.record()
            out = _outputs(cell.kind, cell.step(*args))
            end.record()
            torch.cuda.synchronize(dev)
        del args
        return out, start.elapsed_time(end), rec

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    plain, warm_ms, rec = run(False)
    recs, unequal, finite = [rec], set(), True
    runs = {True: [], False: []}
    for r in range(LAUNCH_REPS):
        for ctx in (True, False) if r % 2 == 0 else (False, True):
            free()
            got, ms, rec = run(ctx)
            runs[ctx].append(ms)
            recs.append(rec)
            unequal.update(k for k in plain if not bits_equal(got[k],
                                                              plain[k]))
            finite &= all(bool(torch.isfinite(t).all()) for t in got.values()
                          if t.is_floating_point())
            del got
    med, plain_med = (statistics.median(runs[c]) for c in (True, False))
    launches = {}
    for rec in recs:
        for k, n in rec.items():
            launches[k] = launches.get(k, 0) + n
    res = {"cell": name, "kind": cell.kind, "batch": batch,
           "reduced_from": full, "ms": med, "ms_runs": runs[True],
           "ms_spread": max(runs[True]) - min(runs[True]),
           "no_context_ms": plain_med, "no_context_ms_runs": runs[False],
           "warm_ms": warm_ms, "flops": est["hlo"]["flops"],
           "kernel_flops": est["hlo"]["kernel_flops"],
           "tflops": est["hlo"]["flops"] / med / 1e9,
           "launches": launches, "runs": len(recs),
           "bit_equal": not unequal, "finite": finite,
           "reckoned_peak_gib": peak / 2**30,
           "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "rules_batch": cell.rules["batch"]}
    if cell.kind == "train":
        res["loss"] = float(plain["loss"])
    del plain
    free()
    want = LAUNCH_KERNELS[cell.kind]
    if unequal or not finite or any(rec != want for rec in recs):
        fail(f"launch {name}: outputs not bit-equal {sorted(unequal)[:5]}, "
             f"finite {finite}, or launches {recs} != {want} a run: {res}")
    return res


def phase_launch(dev, card) -> dict:
    """llama3.2-1b's train_4k, prefill_32k and decode_32k cells through the
    launch layer on the host mesh (``launch_cell``), each line with its
    time beside the card; and the dry run
    (``python -m repro_torch.launch.dryrun --arch llama3.2-1b --mesh
    both``) in a subprocess meanwhile, which must exit 0. Returns the cells
    and their summed launches."""
    import os

    import torch

    from repro_torch.launch.mesh import make_host_mesh

    from repro_torch.launch.mesh import destroy_group

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    t_dry = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--mesh", "both", "--out-dir", str(ROOT / "build" / "dryrun")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        mesh = make_host_mesh(dev)
        total = torch.cuda.get_device_properties(dev).total_memory
        cells = []
        for name, batch in LAUNCH_CELLS:
            c = launch_cell(dev, mesh, name, batch, total)
            log(f"[launch] {name} ({card}): {json.dumps(c)}")
            cells.append(c)
        out, _ = dry.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        destroy_group()  # the one-process group of the host mesh
    dry_s = time.perf_counter() - t_dry
    for line in out.splitlines():
        log(f"[launch] dryrun: {line}")
    if dry.returncode != 0:
        fail(f"the dry run exited {dry.returncode}")
    launches = {}
    for c in cells:
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
    return {"cells": cells, "launches": launches, "dryrun_s": dry_s}


# ------------------------------------------------------------ phase 7c
# the examples' counterparts on the port (examples/<name>_torch.py), run
# in-process in this order at the reference's sizes, except that
# async_serve's live part serves the full-width llama3.2-1b (ARCH) in place
# of the reference's 32-wide toy config; the kernels the phase must launch
EXAMPLES = ("quickstart", "placement_sim", "fleet_sim", "resident_serve",
            "multi_app_serve", "chaos_serve", "plan_capacity",
            "serve_placement", "async_serve")
EXAMPLE_KERNELS = ("gbrt_predict_multi", "gbrt_predict_blocked",
                   "linear_scan", "flash_attention", "decode_attention",
                   "state_walk", "state_replay")


def load_example(name: str):
    """``examples/<name>_torch.py`` of this checkout as a module."""
    import importlib.util

    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def served_all(what: str, res, n: int) -> None:
    """Fails unless a live serve served all ``n`` requests, none failed or
    shed."""
    if res.n != n or res.n_failed or res.n_shed:
        fail(f"{what}: {res.n} of {n} served, {res.n_failed} failed, "
             f"{res.n_shed} shed")


def phase_examples(dev, card) -> dict:
    """Each example's ``run(device=dev)`` in-process, its launch counts and
    the graphs' replays zeroed just before and read just after; async_serve
    at full width. Fails if an example raises, if resident_serve on the
    card is not the numpy oracle's decisions with floats within FLOAT_TOL,
    if serve_placement or the full-width serve_async leaves a request
    unserved, failed or shed, or if a kernel of EXAMPLE_KERNELS is not launched in the phase. Returns
    the summed launches and replays and each example's numbers."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import (
        replayed_launches,
        reset_replayed_launches,
    )

    launches, replayed, per = {}, {}, {}
    for name in EXAMPLES:
        mod = load_example(name)
        kw = {"cfg": get_config(ARCH)} if name == "async_serve" else {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        reset_replayed_launches()
        t0 = time.perf_counter()
        out = mod.run(device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        graphs = replayed_launches()
        head = dict(out["headline"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[examples] {name} ({card}): {secs:.1f} s, peak allocated "
            f"{peak:.1f} GiB, {json.dumps(head, default=str)}, launches "
            f"{json.dumps(counts)}, replayed from graphs "
            f"{json.dumps(graphs)}")
        if name == "resident_serve":
            head["oracle"] = compare("examples resident_serve", out["ref"],
                                     out["comp"], exact=False)
            log(f"[examples] resident_serve vs the numpy oracle: "
                f"{json.dumps(head['oracle'])}")
        if name == "serve_placement":
            served_all("serve_placement", out["result"], out["n_requests"])
        if name == "async_serve":
            for part in ("sequential", "async"):
                served_all(f"async_serve at full width, {part}",
                           out["live"][part], out["live"]["n_requests"])
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        for k, n in graphs.items():
            replayed[k] = replayed.get(k, 0) + n
        per[name] = {"seconds": round(secs, 2), "launches": counts,
                     "graph_replayed": graphs, "peak_gib": round(peak, 2),
                     **head}
    missing = [k for k in EXAMPLE_KERNELS
               if launches.get(k, 0) + replayed.get(k, 0) <= 0]
    if missing:
        fail(f"the examples phase launched no {missing}: launches "
             f"{launches}, replayed {replayed}")
    log(f"[examples] launches {json.dumps(launches)}, replayed from graphs "
        f"{json.dumps(replayed)}")
    return {"launches": launches, "graph_replayed": replayed,
            "examples": per}


def np_equal(a, b) -> bool:
    import numpy as np

    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def split(rt) -> str:
    s = rt.stream_stats
    return f"place {s['place_s']:.2f} s + execute {s['execute_s']:.2f} s"


def _core(rt):
    from repro_torch.core import torch_core

    return torch_core.core_for(rt.engine)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--report PATH] [--seed N]

Phases (any mismatch fails the run with a non-zero exit):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the kernels built from ``src/repro_torch/kernels/csrc`` with nvcc
   (``-Xptxas -v`` registers and spills per instantiation of every route,
   the ``lift``, ``left_lift`` and ``stack`` pre-passes and the
   ``tc_left`` kernel printed on their own; every ``tc`` and ``tc_left``
   instantiation must enter with 168 registers, which its ``setmaxnreg``
   split needs, and ptxas' warnings on them are reported), and the Python mirrors of each route's tiles,
   instantiations and the ``tc`` kernel's shared memory per tile and L (a
   lifted tower's too), the ``tc_left`` kernel's layout (A resident,
   stages, shared memory) per inner degree, L, tile and depth and its
   grid per call and SM count (``LEFT_GRID_CALLS``), the ``tower``
   kernel's per (t, r), and ``simt``'s tile per ring and t and its grid
   per call and SM count (``SIMT_GRID_CALLS``) held against the library;
2. every route of ``gr_matmul`` (``simt``, ``tc``, ``skinny``, ``tower``,
   ``tc_left``) and the tc routes' pre-passes (limb planes, a lifted ring's
   lift, tc_left's lift of A and stack of B) against their plain PyTorch
   versions on the card, bit for bit, on nine
   rings (K up to 65: the (3, 7) tower, D = 21, at e = 32 and 31) at the
   shapes each route takes (``tc`` and ``tower`` at every instantiation of
   the ring's tower), batched and unbatched; ``tc`` on every ring it lifts
   (``LIFT_SPECS``: GR(2^32, D) for D = 5..16 and the towers (3, 4), (4, 3),
   (2, 5), (2, 7), (3, 2)) and ``tc_left`` (its own persistent kernel at
   every tile width, the lift of A and the stack of B) on the same rings
   (``TC_LEFT_SHAPES``, and ``LEFT_EDGE_R``: both edges of its 32-byte
   stage and of its A-resident layout); the widened ``skinny`` at t = 64
   and r = 32
   (``SKINNY_WIDE_SHAPES``, ragged s); the ``tc`` and ``tc_left``
   accumulators' overflow rule (all-0xFF operands, chains past 2^31 and
   2^32, the lifted (3, 7), (3, 4) and D = 6 chains among them, every
   instantiation; printed as ``tc_accumulate: wraps``, and the run fails
   if they saturate); ``simt`` at every instantiation (``SIMT_TOWERS`` at
   ``SIMT_TS``, e = 32 and 31: every tower of its tile kernel and every
   (D, rc, nn, wm, wn) of its thin kernel, R split up to 8 ways) and its
   thin kernel's accumulators on all-0xFF operands whose split chains pass
   2^31 and 2^32 (``SIMT_WRAP_CASES``, printed as ``simt_accumulate:
   wraps``); ``tc_left`` past 65535 column tiles (``LEFT_GRID_SHAPES``:
   its persistent blocks walk them);
   ``ElasticStream``'s step over the (3, 7) tower (three ``tower`` calls
   and the lifted ``tc`` worker product) at every instantiation and on
   ``simt``; and at every shape the main path hands the
   kernels; there each shape's route is timed in turns with ``simt``
   (replayed from CUDA graphs, so without the wrappers' host time), and
   every route at the edges of the dispatch rule is held and timed the same
   way.  The int8 yardstick (``torch._int_mm``, never called by the port) is
   timed from a CUDA graph too;
3. the main path through the user entry points: ``batch_ep_rmfe`` (n = 2,
   N = 8, u = v = 2, w = 1) over Z_2^32 at t = r = s = 2048 with two
   non-prefix stragglers, then ``ep``, ``plain``, ``ep_rmfe1`` and
   ``ep_rmfe2`` at 1024^3 through ``plan``, and a small ``ep`` request at
   96^3; then the GCSA and secure families over GR(2^32, 4) through
   ``plan(spec, schemes=[name])``: ``gcsa`` (n = 2) and ``ep_rmfe_secure``
   (n = 2, privacy_t = 1) at 2048^3, ``ep_secure`` (privacy_t = 1) and
   ``gcsa_general`` (n = 4) at 1024^3; then the planner's wider rings
   (``WIDE_PATHS``, each the best plan of ``plan(spec, calibration=False)``,
   its ring, partition and R asserted, with non-prefix dead workers):
   ``batch_ep_rmfe_n4`` (n = 4, N = 16, 2048^3, GR(2^32, (3, 4))),
   ``batch_ep_rmfe_n64`` (n = 2, N = 64, 2048^3, GR(2^32, 6)) and
   ``ep_secure_n16`` (keyed, N = 16, 1024^3, GR(2^32, 5)), and the
   64-worker rounds at 2048^3: ``batch_ep_rmfe_n8_n64`` (n = 8, 16 dead,
   GR(2^32, (3, 7)), R = 32; its decode and 64-row encodes on ``tc_left``)
   and ``ep_secure_n64`` (keyed, no straggler budget, 16 dead, GR(2^32, 7),
   R = 33; its decode on ``tc_left``), each with its worker product on the
   lifted ``tc`` and no ``simt`` launch.  Every
   output must equal the direct product computed by the plain version.  Launch counts per route are
   zeroed before each path, read after it and held against the expected
   ones.  Stage device times are kept per run (5 warm runs each).  For the
   secure paths the keyed encode is checked on the card: a worker's own
   share equals its row of the master encode, a second key gives other
   shares and the same product, and the top bit of the drawn mask words is
   set in 50% +- 1% of them;
4. every route at every distinct (ring, shape) that phases 3 and 5-9
   handed it, recorded as the paths ran (the pool workers' products from
   the plan), against the plain version on fresh operands of that shape,
   bit for bit (all batch slices of a worker launch included; a call past
   ``PLAIN_WORDS_CAP`` word products against the plain version on its
   first batch entry and against ``simt`` on all); the shapes
   of the GR(2^32, 4) paths, of the wider-ring paths, of ep's 96^3 request
   and of phases 5-9 are also timed as phase 2 times the main path's: the
   route in turns with ``simt`` from CUDA graphs (of 10 launches, fewer
   past 2e10 word products: ``GRAPH_WORDS``), beside its byte, int8
   and INT32 bounds, the plain version and, for ``tc``, its pre-passes
   (the lift alone over a lifted ring; for ``tc_left`` the lift of A, the
   stack and its main kernel alone, with the library's grid and its
   layout, the pre-passes' plain versions at ``LEFT_LINE_CALL`` only) and
   the int8 yardstick; ``tc_left`` (the decodes and 64-row encodes of the
   64-worker rounds) is held against the B-lifted ``tc`` as well and timed
   in turns with it and ``simt``; ``simt`` (ep's 96^3 workers and phase
   7's decode-size worker products) with its grid, mirrored, and the int8
   yardstick where ``torch._int_mm`` takes the shape.  It runs last, once
   phases 5-9 have recorded;
5. the elastic any-R master (``coded_matmul(..., backend=ElasticBackend)``)
   on ``batch_ep_rmfe`` at 2048^3: (a) the all-live fast path, equal to
   ``local`` with ``local``'s launches; (b) the traced event loop under a
   trace with two slow workers (1, 3) and two dead ones (2, 5): the decode
   must read the R = 4 fastest, (0, 4, 6, 7), not ``local``'s first-R set,
   and every dispatched worker runs its own encode and ``tc`` product;
   (c) the race: the same trace with its latencies simulated at 10x, 5 warm
   runs, each held under half the barrier of the last responder; (d)
   ``ep_rmfe_secure`` (T = 1, GR(2^32, 4)) at 1024^3 through the traced path
   with a key, equal to ``local`` with the same key.  Stage times per worker
   (encode, compute), ``wait_R``, decode and wall come from the
   ``repro_torch.obs`` spans of 5 traced runs;
6. ``ElasticStream``: 8 products of 1024^3 over Z_2^32 in groups of 8
   workers, stepped at 16, 9 and 24 live workers (re-chunked to (2, 4),
   (1, 8), (3, 3); the middle step's ring is GR(2^32, (3, 7)), D = 21: its
   worker product on ``tc`` through the lift, its encodes and decode on
   ``tower``, no ``simt`` launch), each step equal to the direct products;
   7 live raises; then 5 warm steps at 9 live workers, each timed with CUDA
   events and held against the direct products;
7. ``CodedQuantMatmul`` at gemma2-2b's FFN width: x (2048, 2304) @
   w (2304, 9216) float32 from ``--seed`` over N = 16 workers (EP_RMFE-I
   over GR(2^32, 4)): the exact int32 product under 12 dead workers (a
   non-prefix live set) equals ``torch._int_mm`` of the int8 operands (an
   oracle only), and the dequantized output is bit-identical to the run
   without deaths; then at decode batch sizes (``QUANT_DECODE_TOKENS``: 2,
   8 and 32 tokens) through both projections of that FFN, each call the
   same bits as without deaths and its exact product equal to the int8
   product (``torch._int_mm`` past 16 rows, else the int64 product on the
   CPU), its worker product one ``simt`` launch;
8. the worker pool: a ``LocalPool`` of 8 CUDA worker processes (each
   worker's hello must name the card) serves ``batch_ep_rmfe`` 2048^3
   through ``coded_matmul(..., backend=PoolBackend(pool))``: (a) all live,
   equal to ``local``; (b) ``repro_torch.dist.smoke``'s flow, every worker
   parked 1 s and 2 SIGKILLed once all shares are sent, still equal to
   ``local``; the shares of the killed workers are re-dispatched;
   (c) ``ep_rmfe_secure`` 1024^3 with a key on the 6 survivors, equal to
   ``local`` with the same key.  Per path: 5 warm requests (wall, time to
   R, bytes on the wire against the raw bytes, the master's encode, send
   and decode spans, the workers' compute spans);
9. the server: a ``ServeScheduler`` (``CoalescePolicy(target_batch_n=4,
   max_wait_ms=50)``) over a fresh pool of 8 CUDA workers answers 16
   concurrent 1024^3 requests over Z_2^32; each slice must equal its
   direct product, the mean fill must exceed 1, and ``/metrics``, scraped
   once while they run, must carry ``serve_`` and ``pool_`` series;
10. the autotuner: every point of ``kernels.autotune.DEFAULT_POINTS`` (the
   ``tc`` and ``skinny`` shapes of the main, secure and GCSA paths and of
   ``CodedQuantMatmul``) tuned over all its instantiations, each held
   against the plain version bit for bit, one row a point (the default and
   the tuned configuration with their times, the bound, the int8 yardstick
   for ``tc``, registers and spills), the cache written to
   ``build/autotune_cache.json``, and ``--check`` passing on the committed
   cache;
11. calibration: a ``CalibrationSet`` for ``local`` and ``elastic`` fitted
   from the spans of traced requests of three families at three sizes, its
   coefficients, predicted against measured times, and the main-path
   spec's ranking with and without it; the reference's JAX/CPU file must
   not match the card;
12. the SPMD backend: ``ShardMapBackend`` over 8 ranks sharing this card
   (this process and 7 spawned, a gloo group) on ``batch_ep_rmfe`` 2048^3
   with ranks 2 and 5 dead, in worker-encode and master-encode mode, equal
   to ``local`` and the direct product; ``ep_rmfe_secure`` 1024^3 keyed,
   equal to ``local`` under the key; the sharded ``CodedQuantMatmul`` over
   16 ranks (12 dead) at gemma2-2b's FFN widths with 256 tokens, equal to
   ``torch._int_mm``.  Every rank's launches per route are held against
   ``SPMD_RANK_LAUNCHES``; its encode, compute, gather and decode spans
   are reported;
13. a hedged straggler on 4 CUDA pool workers: a zero-slack plan, every
   worker parked, the master re-ships the overdue shares
   (``Master._maybe_hedge``); the decode equals ``local``'s and the workers
   compute every share and duplicate on the card;
14. the LM substrate's serving path (plain PyTorch ops; no ring kernel may
   launch): gemma2-2b at full width and depth (26 layers, d 2304, vocab
   256000, bf16, 2.614 B parameters) from ``materialize`` on the card,
   seeded from ``--seed``; (a) ``greedy_generate(smoke=False)`` at batch 2,
   prompt 8, generate 8, then at batch 8, prompt 64, generate 32 (every
   token in range, every logit finite; per-step time from CUDA events,
   median and p90, tokens/s, against the bound of every weight and the
   cache read once from HBM; the weights' bytes, the init time and the
   peak memory); (b) the last cached step against ``prefill_fn`` over the
   same 96 tokens, in bf16 and in float32 with a float32 cache (TF32 off),
   each within its tolerance, the argmax equal wherever the top-2 gap
   exceeds twice the tolerance; (c) a 2-layer gemma2-2b at full width in
   float32 with the vocab cut to 32768 through ``prefill_fn`` at 4160
   tokens (past the local window of 4096), on the card and on the host
   CPU, within 1e-3 relative (TF32 off); (d) launch counts zeroed before
   and read after (a)-(c): no ``gr_matmul`` route launched;
15. the LM substrate's training path (plain PyTorch ops and autograd; no
   ring kernel may launch), through ``repro_torch.launch.train.train``:
   (a) gemma2-2b at full width and depth (bf16, remat ``full``, AdamW with
   float32 state) at train_4k's 4096 tokens, its global batch cut from 256
   to ``TRAIN_BATCH``, on ``markov`` data from ``--seed`` for
   ``TRAIN_STEPS`` steps: every loss, lr and gradient norm finite; step
   time (median and p90 after the first), tokens/s, the model FLOPs a step
   (6 N tokens plus the attention's, without the recompute) and their share
   of the dense bf16 peak, the peak memory, the optimizer update's time
   alone (CUDA events), and one profiled step (``build_cell``'s train step:
   kernels, device-busy time, idle share, top kernels); (b) the 2-layer cut
   of 14 (c) in float32 (TF32 off), on the card and on the host CPU: the
   loss of one batch and every parameter after one AdamW step within
   ``LM_F32_TOL`` relative L2, every gradient leaf and first moment within
   ``TRAIN_GRAD_TOL``, every second moment within twice that; (c) the
   same cut in bf16 on the card: 8 steps checkpointed every 4, the restored
   step-8 parameters and optimizer state equal to the saved bits, a resume
   to step 12 against a straight 12-step run (losses within
   ``RESUME_RTOL``), and a ``compress_grads`` run with finite losses; (d)
   launch counts zeroed before and read after (a)-(c): no ``gr_matmul``
   route launched;
16. the MoE family's serving path (plain PyTorch ops; no ring kernel may
   launch), after phase 15's tensors are freed: qwen3-moe-30b-a3b at full
   width and depth (48 layers, d 2048, 128 experts, top-8, vocab 151936,
   bf16, 30.2 B parameters) from ``materialize`` on the card (its stacked
   experts drawn a layer at a time), seeded from ``--seed``; (a)
   ``greedy_generate(smoke=False)`` at ``SHORT_RUNS`` (every token
   in range, every logit finite; step time median and p90, tokens/s, the
   init time, peak memory, against two bounds: every weight read once, as
   the dense dispatch reads them, and only the weights the step's routes
   need; routes dropped a step; one profiled stretch of steps); (b) the
   2-layer cut of 14 (c) with its 128 experts in float32 (TF32 off), on
   the card and on the host CPU from the same weights: a prefill of
   ``MOE_PREFILL`` tokens through the cache and ``MOE_DECODE`` cached steps
   at batch 2 and 8 (C = 1 a step), logits and aux within ``LM_F32_TOL``,
   expert ids and drop masks equal in every MoE call but where a CPU
   top-K boundary is a near-tie (``MOE_NEAR_TIE``, counted), and at least
   one route dropped; (c) launch counts zeroed before and read after
   (a)-(b): no ``gr_matmul`` route launched;
17. the MoE family's training path (plain PyTorch ops and autograd through
   the dense dispatch; no ring kernel may launch): (a) qwen3-moe-30b-a3b at
   full width (128 experts, top-8, vocab 151936), its depth cut to
   ``MOE_TRAIN_LAYERS`` of 48 (2.804 B parameters), bf16, remat ``full``,
   AdamW with float32 state, through ``launch.train.train(layers=...)`` at
   ``MOE_TRAIN_SHAPE`` for ``MOE_TRAIN_STEPS`` steps, with phase 15's
   training rows (model FLOPs from the active parameters) and every unit's
   routes recorded in the forward and in its recompute, which must be
   equal; routes dropped a step; (b) phase 16 (b)'s 2-layer float32 cut
   (128 experts), TF32 off, on the card and on the host CPU from the same
   weights: the loss and aux within ``LM_F32_TOL``, every gradient leaf
   within ``TRAIN_GRAD_TOL``, the routes equal but for counted near-ties;
   (c) launch counts zeroed before and read after (a)-(b): no ``gr_matmul``
   route launched;
18. the SSM family's serving and training paths (plain PyTorch ops; no
   ring kernel may launch): (a) mamba2-370m (0.368 B parameters) and
   zamba2-7b (6.66 B) at full width and depth, bf16, from ``materialize``
   on the card, ``greedy_generate(smoke=False)`` at ``SHORT_RUNS`` (step time
   median and p90, tokens/s, against a byte bound: every weight read once,
   zamba2's shared block once more at each later application, the float32
   SSM state and the conv history read and written, the shared block's KV
   cache read; one profiled step, peak memory); (b) mamba2-370m training
   at full width and depth through ``launch.train.train`` at
   ``SSM_TRAIN_SHAPE`` for ``SSM_TRAIN_STEPS`` steps, with phase 15's
   training rows (model FLOPs: 6 N a token plus the SSD scan's matmuls);
   (c) each arch's float32 cut (``SSM_CUT_LAYERS``), TF32 off, on the card
   and on the host CPU from the same weights: the prefill's logits and
   every cached call's (S > 1 from a zero state, single steps, S > 1
   continuing) within ``LM_F32_TOL``, the loss within it and every gradient
   leaf within ``TRAIN_GRAD_TOL``; (d) launch counts zeroed before and read
   after (a)-(c): no ``gr_matmul`` route launched;
19. the encoder-decoder and VLM families' serving and training paths
   (plain PyTorch ops; no ring kernel may launch): seamless-m4t-medium
   (0.616 B parameters, a 12-layer encoder and a 12-layer decoder with
   cross-attention) and internvl2-2b (1.702 B, 256 patches ahead of the
   text) at full width and depth, bf16, from ``materialize`` on the card;
   (a) the real serving path at ``XV_BATCHES``: seamless's
   ``encoder_forward`` over ``XV_FRAMES`` frames from ``with_frontend``,
   ``build_xattn_cache`` into the ``xkv`` entry of a cache from
   ``cache_decl`` and a prompt prefilled into the cache in one
   ``decoder_forward`` call; internvl2's patches and prompt prefilled in
   one call; then ``XV_STEPS`` greedy ``decode_fn`` steps (encoder, cross
   cache, prefill and step times from CUDA events, tokens/s, against a
   byte bound: the decoder's weights, the KV and cross K/V caches read
   once; a profiled stretch of steps; peak memory), and
   ``greedy_generate(smoke=False)``, the CLI's path, at ``SHORT_RUNS[0]``;
   (b) each trained through ``launch.train.train`` at ``XV_TRAIN_SHAPE``
   (seamless: 1024 source frames; internvl2: 256 patches ahead of the
   text) for ``XV_TRAIN_STEPS`` steps, with phase 15's training rows; (c)
   each arch's float32 2-layer cut (the encoder's too), TF32 off, on the
   card and on the host CPU from the same weights: the encoder output and
   the cross K/V, the prefill's logits and every cached step's within
   ``XV_F32_TOL``, the loss within it and every gradient leaf within
   ``XV_GRAD_TOL``; (d) launch counts zeroed before and read after
   (a)-(c): no ``gr_matmul`` route launched;
20. the LM substrate on a device mesh (plain PyTorch ops, DTensor and gloo
   collectives; no ring kernel may launch): this process rank 0 and 7
   spawned ranks on the card in one gloo default group, meshed
   ``MESH_SHAPE`` (2, 4) ("data", "model"); qwen3-moe-30b-a3b at full
   width (bf16) cut to ``MESH_LAYERS`` layers: (a) ``train(mesh=...)``
   for ``MESH_TRAIN_STEPS`` steps at ``MESH_TRAIN_SHAPE`` under
   ``rules_for`` (every MoE layer on the ``_apply_moe_ep_a2a`` island),
   then ``MESH_DECODE``'s cached ``decode_fn`` steps under the decode rules
   (the ``_apply_moe_shardmap`` island): each island must run, warm step
   times with and without the mesh, collectives a step, the steps' host
   wall inside collective calls (each entered after a device sync) and in
   those syncs, routes dropped by shard, peak memory a rank; (b) the cut in float32, TF32 off, at the
   published top-8 with a capacity factor of E / K (every bin holds every
   token: nothing drops), mesh against one device from the same weights:
   a forward with every label gives the loss and aux (within
   ``LM_F32_TOL``) and each token's routes and router probabilities on
   both; a token the mesh routes apart from one device is explained when
   one device's K-th and (K+1)-th probabilities lie within twice the
   largest probability move measured on that layer's tokens routed alike
   (the run's own noise), and is not explained, failing the phase,
   otherwise; the gradients (every leaf, gathered, within
   ``TRAIN_GRAD_TOL``) are taken of the loss over the tokens that no
   flip reaches (labels of the others masked; a flip reaches its own
   token and the later tokens of its sequence at the layers after it),
   and ``MESH_F32_DECODE`` cached steps' logits (a float32 cache) are
   held within ``LM_F32_TOL`` on the rows no flip has reached;
   (c) ``pipelined_apply`` over a
   4-rank ``"pod"`` mesh equal to the sequential stack, ``compressed_psum``
   equal to the host's dequantization; (d) the dry-run of
   ``MESH_DRYRUN`` in a subprocess (256 fake ranks): ``ok``, fitting the
   H100's 80 GB; (e) launch counts of every rank: no ``gr_matmul`` route
   launched.

Phases run in the order 1-3, 5-9, 13, 12, 10, 11, 14, 15, 16, 17, 18, 19, 20, 4.  Launch counts per
route are zeroed before each path of phases 3, 5-9, 12 and 13, read
after it (after the elastic backend's straggler tasks have finished) and
held against ``EXPECTED_LAUNCHES``; in phases 8-9 the master's counts are
this process's, and the workers' come from their heartbeats (a ping after
the path, so the late products count too), held against
``POOL_MASTER_LAUNCHES`` and ``POOL_WORKER_LAUNCHES`` (per batch in 9).

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  The full report (ptxas usage, every
timing) goes to ``--report`` (default ``build/chip_smoke.json``).  Without
a CUDA device, or without the repository around this file, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bandwidth,
# dense int8 tensor-core operations, dense bf16 tensor-core FLOPs, and
# uint32 multiply-adds on the CUDA
# cores (INT32 is half of the 128 FP32 lanes per SM: 132 SMs * 64 * 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# dense bf16 tensor-core FLOP/s (phase 15's model FLOPs share)
BF16_FLOPS_PER_S = 989e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9

SEED = 0
# phase 12: ranks of the SPMD backend on this one card, and each rank's
# launches per call (phi(A), encode_a_at, phi(B), encode_b_at, decode, psi
# on skinny, or the master encode's pack and encode; its product on tc)
SPMD_N = 8
# the sharded CodedQuantMatmul at gemma2-2b's FFN widths, its tokens cut
# from 2048 to 256: 16 ranks gather 16 responses each through gloo on the
# host (9.4 MB a response at 256 tokens, 2.4 GB for all ranks)
QUANT_SPMD_SHAPE = (256, 2304, 9216)
# phase 13: a zero-slack (R = N) plan on CUDA pool workers, every worker
# parked, the master hedging overdue shares (tests/test_metrics.py's flow)
HEDGE_WORKERS = 4
HEDGE_SIZE = 1024
HEDGE_PARK_MS = 150.0
HEDGE_FACTOR = 1.05
MAIN_SIZE = 2048
SINGLE_SIZE = 1024
SMALL_SIZE = 96
# dead workers 2 and 5: the first R = 4 live workers are (0, 1, 3, 4), not a prefix
MASK = [True, True, False, True, True, False, True, True]
ROUTES = ("simt", "tc", "skinny", "tower", "tc_left")
# every count a wrapper keeps: the routes' matmul kernels and the tc routes'
# pre-passes (limbs: A's, and a single-level B's; lift: a lifted ring's B on
# tc; stack: B on tc_left; left_lift: A on tc_left)
COUNTED = ROUTES + ("limbs", "lift", "stack", "left_lift")


# CodedQuantMatmul (phase 7) at decode batch sizes, through both projections
# of gemma2-2b's FFN (d_model -> d_ff, d_ff -> d_model): the worker product
# (tokens / 2) x (d / 2) @ (d / 2) x (f / 2) is below TC_MIN_TS rows, so
# simt takes it (one launch a call); the kernels line's simt row reads the
# 8-token up-projection
QUANT_DECODE_TOKENS = (2, 8, 32)
QUANT_DECODE_LINE = "quantized_t8_up"


def _launches(**counts) -> dict:
    """Launches per counted kernel, 0 for those not named."""
    return {**dict.fromkeys(COUNTED, 0), **counts}


SPMD_RANK_LAUNCHES = _launches(simt=0, tc=1, skinny=6, tower=0, limbs=2, lift=0)


# launches per route for one coded_matmul of each path (limbs: the tc
# route's pre-pass, two per tc launch); the ring matmuls of a round are the
# phi/psi packs, two encodes, one batched worker launch and one decode
EXPECTED_LAUNCHES = {
    # phi(A), phi(B), encode a/b, decode, psi -> skinny; workers -> tc
    "batch_ep_rmfe": _launches(simt=0, tc=1, skinny=6, limbs=2),
    "ep": _launches(simt=0, tc=1, skinny=3, limbs=2),
    "plain": _launches(simt=0, tc=1, skinny=3, limbs=2),  # embedding is a copy
    "ep_rmfe1": _launches(simt=0, tc=1, skinny=6, limbs=2),
    "ep_rmfe2": _launches(simt=0, tc=1, skinny=5, limbs=2),  # A embedded, not packed
    # 96^3: worker blocks of 48 rows are below the tc threshold
    "ep_small": _launches(simt=1, tc=0, skinny=3, limbs=0),
    # over GR(2^32, 4): encode a/b (one batched launch each for the kappa
    # groups of gcsa_general) and the one-matrix decode on skinny; masks are
    # drawn by torch.randint, not a ring matmul; embedding is a copy
    "gcsa": _launches(simt=0, tc=1, skinny=3, limbs=2),
    "ep_rmfe_secure": _launches(simt=0, tc=1, skinny=6, limbs=2),
    "ep_secure": _launches(simt=0, tc=1, skinny=3, limbs=2),
    "gcsa_general": _launches(simt=0, tc=1, skinny=3, limbs=2),
    # the elastic master on batch_ep_rmfe: the all-live fast path is local's
    # round; the traced path dispatches all 8 workers (the dead ones join at
    # 0 too) and each runs phi(A), encode_a_at, phi(B), encode_b_at (t = 1)
    # on skinny and its own tc product; then one decode and one psi
    "elastic_all_live": _launches(simt=0, tc=1, skinny=6, limbs=2),
    "elastic_traced": _launches(simt=0, tc=8, skinny=34, limbs=16),
    "elastic_race": _launches(simt=0, tc=8, skinny=34, limbs=16),
    # ep_rmfe_secure traced: the same per-worker rounds (masks are drawn by
    # torch.randint, not a ring matmul)
    "elastic_secure": _launches(simt=0, tc=8, skinny=34, limbs=16),
    # ElasticStream steps: gcsa (n = 4) in two chunks; batch_ep_rmfe (n = 8)
    # over GR(2^32, (3, 7)), D = 21 (the reference leaves this ring to XLA):
    # its worker product on tc, lifted onto GR(2^32, 3) (A's limb pre-pass
    # and B's lift), encode a/b and the decode on tower, phi/psi on skinny;
    # no simt launch; gcsa (n = 3) in three chunks
    "stream_16": _launches(simt=0, tc=2, skinny=6, limbs=4),
    "stream_9": _launches(tc=1, skinny=6, tower=3, limbs=1, lift=1),
    "stream_24": _launches(simt=0, tc=3, skinny=9, limbs=6),
    # CodedQuantMatmul: one ep_rmfe1 round (N = 16, GR(2^32, 4)); at decode
    # batch sizes its worker product on simt
    "quantized": _launches(simt=0, tc=1, skinny=6, limbs=2),
    **{f"quantized_t{n}_{p}": _launches(simt=1, skinny=6)
       for n in QUANT_DECODE_TOKENS for p in ("up", "down")},
    # the planner's wider rings (WIDE_PATHS): every worker product on tc
    # through the lift (A's limb pre-pass and B's lift), every encode,
    # decode and pack on skinny, no simt launch.  n = 4 over GR(2^32, (3, 4)):
    # phi and psi in two levels (over Z_2^32, then GR(2^32, 3)) for A and B
    "batch_ep_rmfe_n4": _launches(simt=0, tc=1, skinny=9, limbs=1, lift=1),
    # n = 2 for 64 workers over GR(2^32, 6): 64-row encodes, a 32 x 32 decode
    "batch_ep_rmfe_n64": _launches(simt=0, tc=1, skinny=6, limbs=1, lift=1),
    # keyed, 16 workers over GR(2^32, 5): encode a/b (k = 3 with the mask
    # row) and the 4 x 9 decode
    "ep_secure_n16": _launches(simt=0, tc=1, skinny=3, limbs=1, lift=1),
    # the planner's 64-worker rounds at 2048^3.  n = 8 over GR(2^32, (3, 7)):
    # phi and psi in two levels on skinny, the worker product on tc through
    # the lift of B, the 64-row encodes and the 32 x 32 decode on tc_left
    # (the lift of A and the stack of B each); no simt launch
    "batch_ep_rmfe_n8_n64": _launches(simt=0, tc=1, skinny=6, tc_left=3, limbs=1, lift=1,
                                      stack=3, left_lift=3),
    # keyed, 64 workers over GR(2^32, 7): encode a/b (k = 5 with the mask
    # row) on skinny, the worker product on tc, the 16 x 33 decode on tc_left
    "ep_secure_n64": _launches(simt=0, tc=1, skinny=2, tc_left=1, limbs=1, lift=1, stack=1,
                               left_lift=1),
}
# phases 8-9, the worker pool: this process (the master) encodes each of the
# 8 shares on its own (phi(A), encode_a_at, phi(B), encode_b_at on skinny,
# as the elastic master) and runs the decode and psi; a re-dispatched share
# is re-sent, not re-encoded.  The worker processes' launches: one tc
# product (and its two pre-pass launches) per share, counted in the workers
POOL_MASTER_LAUNCHES = _launches(simt=0, tc=0, skinny=34, limbs=0)
POOL_WORKER_LAUNCHES = _launches(simt=0, tc=8, skinny=0, limbs=16)
POOL_WORKERS = 8
POOL_KILL = 2  # workers SIGKILLed in the middle of the request
# every worker parks this long on a task, so the kill lands mid-request: at
# 2048^3 the master needs ~0.3 s to send the 8 shares (403 MB), and the kill
# waits for the last send
POOL_PARK_MS = 1000.0
WARM_REQUESTS = 5
SERVE_REQUESTS = 16
SERVE_POLICY = {"target_batch_n": 4, "max_wait_ms": 50.0}
# the paths of the GCSA and secure families: (name, batch n, size,
# privacy_t), each planned with plan(spec, schemes=[name]); their kernel
# shapes are timed in phase 4
SLICE3_PATHS = [("gcsa", 2, MAIN_SIZE, 0), ("ep_rmfe_secure", 2, MAIN_SIZE, 1),
                ("ep_secure", 1, SINGLE_SIZE, 1), ("gcsa_general", 4, SINGLE_SIZE, 0)]
KEY = 20251017  # the secure paths' mask key; KEY + 1 is the second key
# the planner's wider rings, each its best plan under the analytic cost
# model (plan(spec, calibration=False)), with non-prefix dead workers:
# (path, family, n, N, straggler budget, privacy_t, size, the plan's
# (ring degrees, (u, v, w), R), dead workers)
WIDE_PATHS = [
    ("batch_ep_rmfe_n4", "batch_ep_rmfe", 4, 16, 4, 0, MAIN_SIZE, ((3, 4), (2, 4, 1), 8),
     (1, 4, 9, 14)),
    ("batch_ep_rmfe_n64", "batch_ep_rmfe", 2, 64, 16, 0, MAIN_SIZE, ((6,), (4, 8, 1), 32),
     tuple(range(1, 64, 4))),
    ("ep_secure_n16", "ep_secure", 1, 16, 4, 1, SINGLE_SIZE, ((5,), (2, 2, 1), 9),
     (2, 5, 11, 13)),
    # the paper's Table 1 setting at its largest batch (N = 64, n = 8), and
    # the keyed plan for 64 workers with no straggler budget (R = 33)
    ("batch_ep_rmfe_n8_n64", "batch_ep_rmfe", 8, 64, 16, 0, MAIN_SIZE, ((3, 7), (4, 8, 1), 32),
     tuple(range(3, 64, 4))),
    ("ep_secure_n64", "ep_secure", 1, 64, 0, 1, MAIN_SIZE, ((7,), (4, 4, 1), 33),
     tuple(range(2, 64, 4))),
]
# phase 4 holds a call whose plain version needs more word products than
# this (b t r s D^2) on its first batch entry, and the route against simt
# on every entry: the (3, 4) worker product is 2.47e12 of them
PLAIN_WORDS_CAP = 5e11
# a timed call is replayed from a CUDA graph of 10 launches, or of
# GRAPH_WORDS // (its word products) down to 1 past 2e10 of them: simt takes
# ~0.2 s on a 64-row encode over the (3, 7) tower (1.2e11) and ~0.7 s on
# the (3, 7) worker product of 64 workers (7.6e12)
GRAPH_WORDS = 2e11
# the elastic trace: workers 1 and 3 slow, 2 and 5 dead (MASK); the R = 4
# fastest responders are (0, 4, 6, 7), not the first R live (0, 1, 3, 4)
TRACE_COMPUTE_MS = [1, 50, 1, 40, 1, 1, 1, 1]
RACE_SCALE = 10.0  # simulated latency: 10 ms of wall per model-ms
# ElasticStream: (live workers, expected (groups, per-group batch))
STREAM_PRODUCTS = 8
STREAM_STEPS = [(16, (2, 4)), (9, (1, 8)), (24, (3, 3))]
STREAM_WARM = 5  # warm steps at 9 live workers, timed
# CodedQuantMatmul at gemma2-2b's FFN (src/repro/configs/gemma2_2b.py):
# (tokens, d_model, d_ff), N workers, and the R live ones (12 dead)
QUANT_SHAPE = (2048, 2304, 9216)
QUANT_N = 16
QUANT_LIVE = (1, 5, 10, 14)
# paths of phases 5-7, whose kernel shapes phase 4 times
SLICE5_PATHS = ("pool_all_live", "pool_kill", "pool_secure", "serve")
SLICE4_PATHS = ("elastic_all_live", "elastic_traced", "elastic_race", "elastic_secure",
                "stream_16", "stream_9", "stream_24", "quantized",
                *(f"quantized_t{n}_{p}" for n in QUANT_DECODE_TOKENS for p in ("up", "down")))
RING_SPECS = [(2, 32, ()), (2, 32, (3,)), (2, 32, (4,)), (2, 16, (5,)), (2, 8, (2, 3)),
              (2, 32, (16,)), (2, 32, (3, 5)), (2, 32, (3, 7)), (2, 31, (3, 7))]
# the rings the tc route lifts since the planner's wider rings moved off
# simt: every single-level D = 5..16 as (1, D) and five two-level towers;
# each held at TC_SHAPES at every instantiation, and (3, 4), D = 6 at e = 31
LIFT_SPECS = ([(2, 32, (d,)) for d in range(5, 17)]
              + [(2, 32, t) for t in ((3, 4), (4, 3), (2, 5), (2, 7), (3, 2))]
              + [(2, 31, (6,)), (2, 31, (3, 4))])
# the shapes of tests/test_kernels.py, then extra shapes for the new routes:
# t, s >= 64 and an r that runs several times round the tc route's ring of
# 64-deep stages; and t, r <= 16 with ragged s for the skinny route
SHAPES = [(8, 8, 8), (16, 32, 8), (128, 128, 128), (7, 13, 5), (1, 64, 1), (130, 17, 129)]
TC_SHAPES = [(64, 64, 64), (96, 300, 160), (70, 520, 97)]
SKINNY_SHAPES = [(8, 2, 4099), (16, 16, 333), (4, 4, 1000), (2, 3, 12345)]
# the widened skinny route: 64-row encodes, 32 x 32 decodes, both edges at
# once, ragged s; over the skinny rings of RING_SPECS and WIDE_SKINNY_SPECS
SKINNY_WIDE_SHAPES = [(64, 8, 4099), (32, 32, 333), (64, 32, 1001), (17, 3, 12345)]
WIDE_SKINNY_SPECS = [(2, 32, (6,)), (2, 32, (7,)), (2, 32, (12,)), (2, 32, (3, 4))]
# the tower route: ragged columns (odd s: no 16-byte rows), t r at the
# (3, 7) tower's shared-memory limit of 108, a single element
TOWER_SHAPES = [(8, 8, 4099), (12, 9, 1001), (1, 1, 77), (8, 2, 4100)]
BATCHED = {"simt": (3, 9, 20, 11), "tc": (3, 33, 280, 65), "skinny": (3, 4, 5, 77),
           "tower": (3, 4, 5, 77), "tc_left": (3, 4, 5, 77)}
# the tc_left route on every lifted ring: a decode past r = 32, a 32 x 32
# decode, the 64-row encodes (ragged s) and a deep r at three rows
TC_LEFT_SHAPES = [(16, 33, 333), (32, 32, 200), (64, 4, 1001), (64, 8, 4099), (3, 70, 64)]
# tc_left past 65535 column tiles (the default tile width at r = 1: 80), as
# the (3, 7) 64-row encode at 4096^3 has: (ring degrees, t, r, s)
LEFT_GRID_SHAPES = [((3, 7), 2, 1, 65535 * 80 + 81), ((7,), 1, 1, 65535 * 80 + 81)]


def _left_edges(ring) -> list:
    """r at both edges of tc_left's 32-byte stage (D r at or just under
    32, and the next r) and of its layout (the last r whose row tile of
    M(A) stays in shared memory at the default tile width, and the next)."""
    from repro_torch.kernels.gr_matmul import (
        tc_left_configs,
        tc_left_layout,
        tc_left_padded,
        tower_shape,
    )
    D = ring.D
    config = tc_left_configs(*tower_shape(ring))[0]
    resident = max(r for r in range(1, 400)
                   if tc_left_layout(ring, config, tc_left_padded(1, D * r, 1)[1])[1])
    return sorted({max(1, 32 // D), 32 // D + 1, resident, resident + 1})


# ElasticStream's step at 9 live workers: batch_ep_rmfe (n = 8) over
# GR(2^32, (3, 7)), 1024^3 in a (1, 8) group: (name, batch, t, r, s)
STEP9_SHAPES = [("encode_a", None, 8, 2, 524288), ("encode_b", None, 8, 4, 262144),
                ("workers", 8, 512, 1024, 256), ("decode", None, 8, 8, 131072)]


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def u32(x):
    import torch

    return x.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0 or (a.dtype == b.dtype and torch.equal(a, b)):
        return 0  # without the int64 copies (gigabytes at the lifted worker shapes)
    return int((u32(a) - u32(b)).abs().max().item())


def cuda_ms(fn, iters: int = 1, warmup: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_runs_ms(fn, runs: int, warmup: int = 1) -> list:
    """Device time of each of ``runs`` runs of ``fn``, from CUDA events."""
    for _ in range(warmup):
        fn()
    return [cuda_ms(fn) for _ in range(runs)]


def graph_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph of ``iters``
    calls: the wrappers' host time (Python, ctypes; tens of µs) stays out of
    the measurement, which matters for kernels that take about as long."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as graphs require
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = cuda_ms(graph.replay, iters=3) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def host_us(fn, iters: int = 20) -> float:
    """Host time per call of ``fn`` (launch overhead), without waiting for
    the device."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / iters


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_env_build(report: dict) -> None:
    import ctypes

    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels.autotune import ptxas_usage
    from repro_torch.kernels.build import build_info, library_configs, load_library
    from repro_torch.kernels.gr_matmul import (
        TC_DEPTH,
        TC_LEFT_DEPTH,
        TC_LIFT_TOWERS,
        kernel_tile,
        simt_grid,
        skinny_cols,
        skinny_configs,
        skinny_block,
        skinny_smem_bytes,
        tc_configs,
        tc_instantiated,
        tc_left_configs,
        tc_left_grid,
        tc_left_layout,
        tc_smem_bytes,
        tower_configs,
        tower_shape,
        tower_smem_bytes,
    )
    from repro_torch.kernels.ref import tc_left_padded

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    report["card"] = smi
    report["device_name"] = torch.cuda.get_device_name(0)
    lib = load_library()
    info = build_info()
    log(f"kernel library {info['path']} built={info['built']} in {info['seconds']:.2f} s")
    report["build"] = info
    # registers / spills per instantiation (tower and, for tc and skinny,
    # tile configuration), from nvcc -Xptxas -v of each source
    usage = ptxas_usage()
    log("ptxas " + json.dumps(usage, separators=(",", ":")))
    report["ptxas"] = usage
    for route in ("simt", "simt_thin", "tc", "tc_left", "skinny", "tower", "limbs_rows",
                  "limbs_cols", "lift", "stack", "left_lift"):
        if not any(k.startswith(route + "(") for k in usage):
            fail(f"no ptxas report for the {route} kernels")
    # the tc kernel's warpgroups trade registers with setmaxnreg (producer
    # 40, consumers 232), which balances only at 168 a thread on entry;
    # ptxas' warnings (a serialised wgmma, an ignored setmaxnreg) are kept
    tc_regs = {k: v.get("regs") for k, v in usage.items() if k.startswith(("tc(", "tc_left("))}
    if set(tc_regs.values()) != {168}:
        fail(f"tc and tc_left instantiations must enter with 168 registers: {tc_regs}")
    report["ptxas_tc_warnings"] = sorted({
        line.split("warning", 1)[-1].strip()[:200]
        for source in ("gr_matmul_tc", "gr_matmul_tc_left")
        for line in (ROOT / "build" / "kernels" / f"{source}.ptxas.txt").read_text().splitlines()
        if "warning" in line.lower()})
    log(f"ptxas tc and tc_left warnings: {report['ptxas_tc_warnings']}")
    # tc_left's kernels, tc's lift, simt's thin kernel
    for route in ("stack", "left_lift", "lift", "tc_left", "simt_thin"):
        log(f"ptxas {route}: " + json.dumps({k: v for k, v in usage.items()
                                            if k.startswith(route + "(")}))
    spills = {k: v for k, v in usage.items() if v.get("spill_st") or v.get("spill_ld")}
    report["ptxas_spills"] = spills
    if spills:
        fail(f"ptxas reports spills: {spills}")
    # the library's own tile and instantiation choices must match the mirrors:
    # simt's tile per t (its thin kernel's up to 64 rows over GR(2^e, D <= 4),
    # else its tile kernel's) and its grid per call and SM count
    for spec in RING_SPECS + [(2, 32, (2,)), (2, 32, (4,))]:
        ring = make_ring(*spec)
        for t in SIMT_TS + (64, 1024):
            bm, bn, bk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            if lib.gr_matmul_tile(*tower_shape(ring), t, bm, bn, bk) != 0:
                fail(f"no simt instantiation for {ring}")
            if (bm.value, bn.value, bk.value) != kernel_tile(ring, t):
                fail(f"simt tile mirror {kernel_tile(ring, t)} != library "
                     f"{(bm.value, bn.value, bk.value)} for {ring} at t={t}")
        for b, t, r, s in SIMT_GRID_CALLS:
            for sms in (132, 114, 7):
                want, got = simt_grid(ring, b, t, r, s, sms), _library_simt_grid(lib, ring, b, t, r,
                                                                                  s, sms)
                if got != want:
                    fail(f"simt grid mirror {want} != library {got} for {ring} at "
                         f"{(b, t, r, s)} on {sms} SMs")
    towers = [(d, 1) for d in range(1, 17)] + [(2, 3), (2, 5), (2, 7), (3, 2), (3, 4), (3, 5),
                                                (4, 3), (5, 2), (5, 3), (7, 2), (3, 7)]
    if lib.gr_matmul_tc_depth() != TC_DEPTH:
        fail(f"tc stage depth mirror {TC_DEPTH} != library {lib.gr_matmul_tc_depth()}")
    if lib.gr_matmul_tc_left_depth() != TC_LEFT_DEPTH:
        fail(f"tc_left stage depth mirror {TC_LEFT_DEPTH} != library "
             f"{lib.gr_matmul_tc_left_depth()}")
    # the tc_left kernel's tile widths, and its layout (A resident, stages,
    # shared memory) per limbs, tile width and depth
    if library_configs("tc_left", 3, 7) != tc_left_configs(3, 7):
        fail(f"tc_left mirror {tc_left_configs(3, 7)} != library "
             f"{library_configs('tc_left', 3, 7)}")
    for e in (8, 16, 24, 32):
        ring = make_ring(2, e, (3, 7))
        for config in tc_left_configs(3, 7):
            for rp in (32, 96, 224, 256, 672, 1024, 24576):
                out = (ctypes.c_int * 4)()
                smem = lib.gr_matmul_tc_left_layout(-(-e // 8), *config, rp, out)
                got = (bool(out[0]), bool(out[1]), out[2], out[3], smem)
                if got != tc_left_layout(ring, config, rp):
                    fail(f"tc_left layout mirror {tc_left_layout(ring, config, rp)} != library "
                         f"{got} at e={e} {config} depth {rp}")
    # and its grid (blocks, row tiles, column tiles) per ring, tile width,
    # call and SM count: the four calls of the 64-worker rounds, a batch,
    # a streaming depth and past 65535 column tiles
    for deg in ((3, 7), (3, 4), (7,), (6,)):
        ring = make_ring(2, 32, deg)
        for config in tc_left_configs(*tower_shape(ring)):
            for b, t, r, s in LEFT_GRID_CALLS:
                if tc_left_layout(ring, config, tc_left_padded(1, ring.D * r, 1)[1])[2] < 2:
                    continue  # no launch: the library has no grid for it
                for sms in (132, 114, 7):
                    want = tc_left_grid(ring, b, t, r, s, config, sms)
                    got = _library_left_grid(lib, ring, b, t, r, s, config, sms)
                    if got != want:
                        fail(f"tc_left grid mirror {want} != library {got} for {deg} {config} "
                             f"at {(b, t, r, s)} on {sms} SMs")
    for d0, d1 in towers:
        if library_configs("tc", d0, d1) != tc_configs(d0, d1):
            fail(f"tc mirror {tc_configs(d0, d1)} != library {library_configs('tc', d0, d1)} "
                 f"for tower {(d0, d1)}")
        degrees = tuple(d for d in (d0, d1) if d > 1)
        for config in tc_configs(d0, d1):  # a lifted tower: its inner ring's kernel
            for e in (8, 16, 24, 32):
                ring = make_ring(2, e, degrees)
                lib_smem = lib.gr_matmul_tc_smem(d0, d1, *config, -(-e // 8))
                if lib_smem != tc_smem_bytes(ring, config):
                    fail(f"tc shared-memory mirror {tc_smem_bytes(ring, config)} != library "
                         f"{lib_smem} for tower {(d0, d1)} {config} e={e}")
        cols = lib.gr_matmul_skinny_cols(d0, d1)
        if (cols if cols > 0 else None) != skinny_cols(d0, d1):
            fail(f"skinny mirror {skinny_cols(d0, d1)} != library {cols} for tower {(d0, d1)}")
        for config in skinny_configs(d0, d1):  # the block's threads and shared memory
            ring = make_ring(2, 32, degrees)
            for t, r in ((1, 1), (8, 2), (16, 16), (64, 8), (32, 32), (64, 32)):
                threads, groups = ctypes.c_int(), ctypes.c_int()
                lib_smem = lib.gr_matmul_skinny_smem(d0, d1, *config, t, r, threads, groups)
                got = (lib_smem, threads.value, groups.value)
                want = (skinny_smem_bytes(ring, t, r, config), *skinny_block(ring, t, r, config))
                if got != want:
                    fail(f"skinny shared-memory mirror {want} != library {got} for tower "
                         f"{(d0, d1)} {config} at t={t}, r={r}")
        if library_configs("skinny", d0, d1) != skinny_configs(d0, d1):
            fail(f"skinny mirror {skinny_configs(d0, d1)} != library "
                 f"{library_configs('skinny', d0, d1)} for tower {(d0, d1)}")
        if library_configs("tower", d0, d1) != tower_configs(d0, d1):
            fail(f"tower mirror {tower_configs(d0, d1)} != library "
                 f"{library_configs('tower', d0, d1)} for tower {(d0, d1)}")
        ring = make_ring(2, 32, degrees)
        for t, r in ((1, 1), (8, 2), (8, 8), (16, 16)):
            lib_smem = lib.gr_matmul_tower_smem(d0, d1, t, r)
            want = tower_smem_bytes(ring, t, r) if tower_configs(d0, d1) else -1
            if lib_smem != want:
                fail(f"tower shared-memory mirror {want} != library {lib_smem} for tower "
                     f"{(d0, d1)} at t={t}, r={r}")
    report["instantiations"] = {
        "tc": {str(t): tc_configs(*t) for t in towers if tc_instantiated(*t)},
        "tc_lifted": [str(t) for t in TC_LIFT_TOWERS],
        "skinny": {str(t): skinny_configs(*t) for t in towers if skinny_cols(*t)},
        "tower": {str(t): tower_configs(*t) for t in towers if tower_configs(*t)},
    }
    log(f"instantiations {json.dumps(report['instantiations'])}")
    # the library yardstick: PyTorch has no integer GEMM on CUDA
    a = torch.ones((4, 4), dtype=torch.int32, device="cuda")
    try:
        torch.mm(a, a)
        report["torch_mm_int32_cuda"] = "computed"
    except RuntimeError as exc:
        report["torch_mm_int32_cuda"] = f"raises: {str(exc).splitlines()[0][:160]}"
    log(f"torch.mm on int32 CUDA tensors: {report['torch_mm_int32_cuda']}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _main_path_shapes():
    """(ring degrees, batch, t, r, s) of every kernel call on the main path
    (batch_ep_rmfe at 2048^3, n = 2, N = 8, u = v = 2, w = 1)."""
    n, N, R, m, size = 2, 8, 4, 3, MAIN_SIZE
    half = size // 2
    return {
        "phi": ((), None, n, n, size * size),             # M_phi @ (n, t*r)
        "encode_a": ((3,), None, N, 2, half * size),      # Vf @ (uw, tb*rb)
        "encode_b": ((3,), None, N, 2, size * half),      # Vg @ (wv, rb*sb)
        "workers": ((3,), N, half, size, half),           # N x (tb, rb) @ (rb, sb)
        "decode": ((3,), None, R, R, half * half),        # M @ (R, tb*sb)
        "psi": ((), None, n, m, size * size),             # V_psi @ (m, t*s)
    }


def _bounds(ring, b, t, r, s, fold=True):
    """(bytes_ms, int8_ms, int32_ms): the byte bound (interleaved int32
    operands read once, result written once) and the operation bounds of the
    same matmul on the int8 tensor cores (L(L+1)/2 byte products per word
    product) and as uint32 multiply-adds on the CUDA cores (D^2 a (t, r, s),
    with ``fold`` K D more an output, as a scheme with conv accumulators
    needs)."""
    from repro_torch.kernels.ref import n_limbs

    L = n_limbs(ring)
    nbytes = 4 * ring.D * b * (t * r + r * s + t * s)
    int8_ops = 2 * b * t * s * r * ring.D ** 2 * L * (L + 1) // 2
    mads = b * t * s * (ring.D * ring.D * r + (ring.K * ring.D if fold else 0))
    return (1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * int8_ops / INT8_OPS_PER_S,
            1e3 * mads / INT32_MAD_PER_S)


def _int8_yardstick_ms(ring, b, t, r, s):
    """One torch._int_mm (t x r) @ (r x s) int8 product on the card, times the
    number of limb products the tc route needs (b * D^2 * L(L+1)/2).  A
    yardstick of speed only: the port never calls torch._int_mm."""
    import torch

    from repro_torch.kernels.ref import n_limbs

    L = n_limbs(ring)
    a8 = torch.randint(-128, 127, (t, r), dtype=torch.int8, device="cuda")
    b8 = torch.randint(-128, 127, (s, r), dtype=torch.int8, device="cuda").t()
    try:  # replayed from a CUDA graph, like the routes it is set beside
        one = graph_ms(lambda: torch._int_mm(a8, b8))
    except RuntimeError as exc:
        return None, f"torch._int_mm raises: {str(exc).splitlines()[0][:120]}"
    n = b * ring.D ** 2 * L * (L + 1) // 2
    return one * n, f"{n} x torch._int_mm ({t}x{r} @ {r}x{s}) at {one:.4f} ms each"


def _hold(route, ring, A, B, worst: dict, what: str, plain=None, every_config=False,
          first=False, planes_first=False, planes=True) -> None:
    """Hold ``route`` on (A, B) against the plain version, bit for bit (with
    ``every_config``, each tc, tc_left or tower instantiation of the ring's
    tower), and (with ``planes``) for ``tc`` its pre-passes (A's limb
    planes; B's, or over a lifted ring B's lift), for ``tc_left`` the lift
    of A and the stack of B, against their plain version; the worst error
    of each goes into ``worst``.  With ``first``, ``plain`` is the product
    of the first batch entry only; with ``first`` or ``planes_first``, so
    are the pre-passes' plain versions (``PLAIN_WORDS_CAP``)."""
    from repro_torch.kernels import gr_matmul_ref, run_route
    from repro_torch.kernels.gr_matmul import (
        tc_configs,
        tc_left_configs,
        tc_left_limbs,
        tc_left_padded,
        tc_limbs,
        tc_padded,
        tc_shape,
        tower_configs,
        tower_shape,
    )
    from repro_torch.kernels.ref import tc_left_planes_ref, tc_lifted, tc_planes_ref

    shape = f"{tuple(A.shape[:-1])} x {tuple(B.shape[:-1])}"
    if plain is None:
        plain = gr_matmul_ref(A, B, ring)
    instantiations = {"tc": tc_configs, "tc_left": tc_left_configs,
                      "tower": tower_configs}.get(route)
    configs = instantiations(*tower_shape(ring)) if instantiations and every_config else (None,)
    for config in configs:
        out = run_route(route, A, B, ring, config)
        err = max_abs_err(out[:1] if first else out, plain)
        worst[route] = max(worst[route], err)
        if err:
            fail(f"{route} {config or ''} != plain on {ring} at {shape}{what}: max abs err {err}")
        del out
    if not planes:
        return
    if route == "tc_left":
        D = ring.D
        t, r, s = A.shape[-3], A.shape[-2], B.shape[-2]
        A8, B8 = tc_left_limbs(A, B, ring)
        A3, B3 = (A, B) if A.dim() == 4 else (A[None], B[None])
        if first or planes_first:
            A8, B8, A3, B3 = A8[:1], B8[:1], A3[:1], B3[:1]
        want_a, want_b = tc_left_planes_ref(A3, B3, ring, *tc_left_padded(D * t, D * r, s))
        for name, err in (("left_lift", max_abs_err(A8, want_a)),
                          ("stack", max_abs_err(B8, want_b))):
            worst[name] = max(worst[name], err)
            if err:
                fail(f"{name} pre-pass (tc_left) != plain on {ring} at {shape}{what}: "
                     f"max abs err {err}")
    if route == "tc":
        _, T, R1, S1 = tc_shape(ring, A.shape[-3], A.shape[-2], B.shape[-2])
        A8, B8 = tc_limbs(A, B, ring)
        A3, B3 = (A, B) if A.dim() == 4 else (A[None], B[None])
        if first or planes_first:
            A8, B8, A3, B3 = A8[:1], B8[:1], A3[:1], B3[:1]
        want_a, want_b = tc_planes_ref(A3, B3, ring, *tc_padded(T, R1, S1))
        b_pass = "lift" if tc_lifted(ring) else "limbs"
        for name, err in (("limbs", max_abs_err(A8, want_a)), (b_pass, max_abs_err(B8, want_b))):
            worst[name] = max(worst[name], err)
            if err:
                fail(f"{name} pre-pass != plain on {ring} at {shape}{what}: max abs err {err}")


def _timing_row(ring, A, B, route: str, plain_ms: float, plain_batch=None, rivals=(),
                plain_prepasses=True) -> dict:
    """Time ``route`` on (A, B) in turns with ``simt`` and the ``rivals``
    (simt, rivals, route, route, rivals reversed, simt; replayed from CUDA
    graphs), eagerly and on the host, beside its bounds; for ``tc`` also
    its pre-passes (over a lifted ring the lift alone too) and the int8
    yardstick, for ``tc_left`` its main kernel alone with the library's
    grid, its pre-passes (the lift of A, the stack of B) and the yardstick;
    for ``tower`` its own plain version.  ``plain_batch``: the batch entries
    ``plain_ms`` covers (None: all); the pre-passes' plain versions are
    timed on as many, for ``tc_left`` only with ``plain_prepasses``."""
    import torch

    from repro_torch.kernels import gr_matmul_tower_ref, run_route
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.gr_matmul import (
        simt_grid,
        tc_left_default,
        tc_left_grid,
        tc_left_layout,
        tc_left_lift,
        tc_left_limbs,
        tc_left_main,
        tc_left_padded,
        tc_lift,
        tc_limbs,
        tc_padded,
        tc_shape,
        tc_stack,
    )
    from repro_torch.kernels.ref import (
        left_lift_ref,
        lift_b_ref,
        limb_planes_ref,
        n_limbs,
        stacked_planes_ref,
        tc_lifted,
        tc_planes_ref,
    )

    lead = A.dim() == 4
    b = A.shape[0] if lead else 1
    t, r, s = A.shape[-3], A.shape[-2], B.shape[-2]
    iters = int(min(10, max(1, GRAPH_WORDS // (b * t * r * s * ring.D ** 2))))
    order = ("simt", *rivals, route, route, *rivals[::-1], "simt")
    turns = [(rt, graph_ms(lambda rt=rt: run_route(rt, A, B, ring), iters)) for rt in order]
    simt_ms = [m for rt, m in turns if rt == "simt"]
    route_ms = [m for rt, m in turns if rt == route]
    bytes_ms, int8_ms, int32_ms = _bounds(ring, b, t, r, s, fold=route != "tower")
    row = {
        "route": route, "ms": sum(route_ms) / len(route_ms),
        "simt_ms": sum(simt_ms) / len(simt_ms), "turns": turns,
        "plain_ms": plain_ms, "plain_batch": plain_batch or b,
        # launched from Python in a loop: bounded below by the host time
        "eager_ms": cuda_ms(lambda: run_route(route, A, B, ring), iters=10, warmup=2),
        "host_us": host_us(lambda: run_route(route, A, B, ring)),
        "bound_ms": max(bytes_ms, int8_ms),
        "bound_by": "operations" if int8_ms >= bytes_ms else "bytes",
        "bytes_bound_ms": bytes_ms, "int8_bound_ms": int8_ms, "int32_bound_ms": int32_ms,
    }
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["simt_over_route"] = row["simt_ms"] / row["ms"]
    row["graph_launches"] = iters
    if rivals:
        row["rivals_ms"] = {rv: sum(m for rt, m in turns if rt == rv) / 2 for rv in rivals}
    if route == "tc_left":
        Tp, Rp, Sp = tc_left_padded(ring.D * t, ring.D * r, s)
        L = n_limbs(ring)
        # the main kernel alone on the pre-passes' planes, its grid and layout
        A8, B8 = tc_left_limbs(A, B, ring)
        config = tc_left_default(ring, r)
        row["main_ms"] = graph_ms(lambda: tc_left_main(A8, B8, ring, t, s, config), iters)
        row["main_bound_share"] = row["bound_ms"] / row["main_ms"]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grid = _library_left_grid(load_library(), ring, b, t, r, s, config, sms)
        if grid != tc_left_grid(ring, b, t, r, s, config, sms):
            fail(f"tc_left grid mirror {tc_left_grid(ring, b, t, r, s, config, sms)} != "
                 f"library {grid} at {(b, t, r, s)}")
        row["grid"] = dict(zip(("blocks", "row_tiles", "col_tiles"), grid), sms=sms)
        row["layout"] = dict(zip(("pair", "a_resident", "stages", "buffers", "smem"),
                                 tc_left_layout(ring, config, Rp)), depth=Rp)
        del A8, B8
        row["lift_a_ms"] = graph_ms(lambda: tc_left_lift(A, ring))
        # the lift of A alone: A read once, M(A)'s planes written once, and
        # D^3 multiply-adds an element of A at the INT32 rate
        A3 = (A if lead else A[None])[:plain_batch]
        if plain_prepasses:
            row["lift_a_plain_ms"] = cuda_ms(
                lambda: limb_planes_ref(left_lift_ref(A3, ring)[..., None], ring, Tp, Rp))
        lift_bytes_ms = 1e3 * (4 * ring.D * b * t * r + b * L * Tp * Rp) / HBM_BYTES_PER_S
        lift_ops_ms = 1e3 * b * t * r * ring.D ** 3 / INT32_MAD_PER_S
        row["lift_a_bound_ms"] = max(lift_bytes_ms, lift_ops_ms)
        row["lift_a_bound_by"] = "bytes" if lift_bytes_ms >= lift_ops_ms else "operations"
        row["stack_ms"] = graph_ms(lambda: tc_stack(B, ring))
        # the stack alone: B read once, its limb planes written once (the
        # zero padding of Sp and Rp is not work the function needs)
        stack_bytes = 4 * ring.D * b * r * s + b * L * s * ring.D * r
        row["stack_bound_ms"] = 1e3 * stack_bytes / HBM_BYTES_PER_S
        B3 = (B if lead else B[None])[:plain_batch]
        if plain_prepasses:
            row["stack_plain_ms"] = cuda_ms(lambda: stacked_planes_ref(B3, ring, Sp, Rp))
        row["int8_yardstick_ms"], row["int8_yardstick"] = _int8_yardstick_ms(ring, b, t, r, s)
    if route == "tc":
        d0, _, R1, S1 = tc_shape(ring, t, r, s)
        Tp, Rp, Sp = tc_padded(t, R1, S1)
        L = n_limbs(ring)
        # both pre-passes: operands read once, limb planes written once
        row["limbs_ms"] = graph_ms(lambda: tc_limbs(A, B, ring))
        limb_bytes = 4 * ring.D * b * (t * r + r * s) + b * d0 * L * (Tp + Sp) * Rp
        row["limbs_bound_ms"] = 1e3 * limb_bytes / HBM_BYTES_PER_S
        A3, B3 = (A, B) if lead else (A[None], B[None])
        A3, B3 = A3[:plain_batch], B3[:plain_batch]
        row["limbs_plain_ms"] = cuda_ms(lambda: tc_planes_ref(A3, B3, ring, Tp, Rp, Sp))
        if tc_lifted(ring):  # the lift alone: B in, the planes of M(B) out
            row["lift_ms"] = graph_ms(lambda: tc_lift(B, ring))
            row["lift_bound_ms"] = 1e3 * (4 * ring.D * b * r * s + b * d0 * L * Sp * Rp) / HBM_BYTES_PER_S
            inner = ring.base_ring()
            row["lift_plain_ms"] = cuda_ms(lambda: limb_planes_ref(lift_b_ref(B3, ring), inner, Sp, Rp,
                                                                   transpose=True))
        row["int8_yardstick_ms"], row["int8_yardstick"] = _int8_yardstick_ms(ring, b, t, r, s)
    if route == "tower":  # the kernel's own plain version (A lifted, no fold)
        row["tower_plain_ms"] = cuda_ms(lambda: gr_matmul_tower_ref(A, B, ring))
    if route == "simt":  # which kernel, its grid, and the int8 yardstick where it applies
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grid = simt_grid(ring, b, t, r, s, sms)
        row["grid"] = dict(zip(("thin", "blocks", "t_chunks", "s_tiles", "splits", "rc", "nn",
                                "wm", "wn", "smem"), grid), sms=sms)
        if grid != _library_simt_grid(load_library(), ring, b, t, r, s, sms):
            fail(f"simt grid mirror {grid} != library at {(b, t, r, s)} over {ring}")
        row["int8_yardstick_ms"], row["int8_yardstick"] = _int8_yardstick_ms(ring, b, t, r, s)
    return row


# all-0xFF operands: accumulator (c, s) of the middle conv plane at s = 3
# chains 12 (D = 3) or 16 (D = 4) byte products of 255^2 per element of r,
# so these r take a chain past 2^31 (and at 4160 and 8192 past 2^32); over
# the (3, 7) tower the lifted chain (all-0xFF A against the lift of an
# all-0xFF B, D1 r = 7 r deep) passes 2^31 at r = 512 and 2^32 at 1024;
# over GR(2^32, 6) (1300500 an element of r) at 1800 and 3400, over the
# (3, 4) tower (2340900) at 1000 and 1900
WRAP_CASES = [((3,), 2816), ((3,), 8192), ((4,), 2112), ((4,), 4160), ((3, 7), 512),
              ((3, 7), 1024), ((6,), 1800), ((6,), 3400), ((3, 4), 1000), ((3, 4), 1900)]
# the tc_left call the kernels line reads (ring degrees, (t, r)): the (3, 7)
# tower's 32 x 32 decode for 64 workers; phase 4 times the plain versions of
# tc_left's pre-passes there only
LEFT_LINE_CALL = ((3, 7), (32, 32))
# calls (b, t, r, s) at which phase 1 holds tc_left's grid mirror against
# the library: the (3, 7) encodes and decode, the R = 33 decode, a batch, a
# depth whose A streams, 7 million columns
LEFT_GRID_CALLS = ((1, 64, 4, 1 << 20), (1, 64, 8, 1 << 19), (1, 32, 32, 1 << 17),
                   (1, 16, 33, 1 << 18), (5, 3, 2, 1000), (1, 64, 700, 80), (2, 1, 1, 7 << 20))


# simt at every instantiation (phase 2): every tower of GR_TOWERS
# (csrc/gr_matmul.cu) at these t, e = 32 and 31, a ragged r past two
# 32-row stages (R split where the grid is small) and a ragged s; over
# GR(2^e, D <= 4) the t reach every (D, rc, nn, wm) of the thin kernel (t =
# 8, 24: two m16 tiles at D = 3, 4 and at D = 1) and, past 64, its tile
# kernel
SIMT_TOWERS = [(d, 1) for d in range(1, 17)] + [(2, 3), (2, 5), (2, 7), (3, 2), (3, 4), (3, 5),
                                                (4, 3), (5, 2), (5, 3), (7, 2), (3, 7)]
SIMT_TS = (1, 4, 8, 16, 24, 48, 63, 65)
SIMT_R, SIMT_S = 70, 77
# the thin kernel's R splits past 2^31 and 2^32 in a split's chain of
# all-0xFF byte products (4 limb pairs of 255^2 at shift 3, D a row of r):
# (ring degrees, t, r, s); r split 8 ways over one s tile
SIMT_WRAP_CASES = [((4,), 16, 20480, 64), ((4,), 16, 40960, 64), ((), 16, 160000, 32),
                   ((3,), 48, 40000, 32)]
# calls (b, t, r, s) at which phase 1 holds simt's grid mirror against the
# library: CodedQuantMatmul's decode-size worker products, ep's 48-row
# blocks, coded_inference's, a pack, a deep ragged call, one element, and
# a tile-kernel call
SIMT_GRID_CALLS = ((16, 1, 1152, 4608), (16, 4, 4608, 1152), (16, 16, 4608, 1152),
                   (8, 48, 96, 32), (8, 16, 128, 256), (1, 2, 2, 1 << 22), (3, 63, 300, 77),
                   (1, 1, 1, 1), (8, 1024, 2048, 1024))


def _library_simt_grid(lib, ring, b: int, t: int, r: int, s: int, sms: int) -> tuple:
    """simt's grid as the library reports it (``gr_matmul_simt_grid``)."""
    import ctypes

    from repro_torch.kernels.gr_matmul import tower_shape

    out = (ctypes.c_longlong * 10)()
    if lib.gr_matmul_simt_grid(*tower_shape(ring), b, t, r, s, sms, out) != 0:
        fail(f"no simt grid for {ring}")
    return tuple(out)


def _simt_wrap_check(worst: dict) -> str:
    """Whether the simt thin kernel's s32 mma.sync accumulators wrap mod
    2^32 within an R split (the kernel relies on it: no flush), held bit for
    bit against the plain version on all-0xFF operands (``SIMT_WRAP_CASES``);
    fails unless they wrap."""
    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref
    from repro_torch.kernels.gr_matmul import gr_matmul_simt, simt_grid

    errs = {}
    for deg, t, r, s in SIMT_WRAP_CASES:
        ring = make_ring(2, 32, deg)
        A = torch.full((t, r, ring.D), -1, dtype=torch.int32, device="cuda")
        B = torch.full((r, s, ring.D), -1, dtype=torch.int32, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = simt_grid(ring, 1, t, r, s, sms)[4]
        err = max_abs_err(gr_matmul_simt(A, B, ring), gr_matmul_ref(A, B, ring))
        errs[f"simt {deg} {(t, r, s)} splits={splits}"] = err
        worst["simt"] = max(worst["simt"], err)
        del A, B
    verdict = "wraps" if not any(errs.values()) else "saturates"
    log(f"simt_accumulate: {verdict} {json.dumps(errs)}")
    if verdict != "wraps":
        fail(f"the simt thin kernel's accumulators do not wrap mod 2^32: {errs}")
    return verdict


def _library_left_grid(lib, ring, b: int, t: int, r: int, s: int, config, sms: int) -> tuple:
    """(blocks, row tiles, column tiles) of a tc_left launch as the library
    computes it (``gr_matmul_tc_left_grid``), on ``sms`` SMs."""
    import ctypes

    from repro_torch.kernels.ref import n_limbs, tc_left_padded

    out = (ctypes.c_int64 * 2)()
    rp = tc_left_padded(1, ring.D * r, 1)[1]
    blocks = lib.gr_matmul_tc_left_grid(n_limbs(ring), *config, b, t, s, ring.D, rp, sms, out)
    return blocks, out[0], out[1]


# the same chains on tc_left, which lifts all-0xFF A to its multiplication
# matrices over Z_2^32 instead (16 rows; D r deep): over the (3, 7) tower
# they pass 2^31 at r = 700 and 2^32 at 1300, over GR(2^32, 6) at 1800 and
# 3400
LEFT_WRAP_CASES = [((3, 7), 700), ((3, 7), 1300), ((6,), 1800), ((6,), 3400)]


def _tc_wrap_check(worst: dict) -> str:
    """Whether the tc kernel's int32 wgmma accumulators wrap mod 2^32 (the
    kernel relies on it: no flush at any r), held bit for bit against the
    plain version at every instantiation; fails unless they wrap."""
    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref
    from repro_torch.kernels.gr_matmul import (
        gr_matmul_tc,
        gr_matmul_tc_left,
        tc_configs,
        tc_left_configs,
        tower_shape,
    )

    errs = {}
    for route, cases, t in (("tc", WRAP_CASES, 64), ("tc_left", LEFT_WRAP_CASES, 16)):
        fn = {"tc": gr_matmul_tc, "tc_left": gr_matmul_tc_left}[route]
        configs = {"tc": tc_configs, "tc_left": tc_left_configs}[route]
        for deg, r in cases:
            ring = make_ring(2, 32, deg)
            A = torch.full((t, r, ring.D), -1, dtype=torch.int32, device="cuda")
            B = torch.full((r, 64, ring.D), -1, dtype=torch.int32, device="cuda")
            plain = gr_matmul_ref(A, B, ring)
            for config in configs(*tower_shape(ring)):
                err = max_abs_err(fn(A, B, ring, config), plain)
                errs[f"{route} {deg} r={r} {config}"] = err
                worst[route] = max(worst[route], err)
    verdict = "wraps" if not any(errs.values()) else "saturates"
    log(f"tc_accumulate: {verdict} {json.dumps(errs)}")
    if verdict != "wraps":
        fail(f"the tc accumulators do not wrap mod 2^32: {errs}")
    return verdict


def phase_kernels(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref, pick_route
    from repro_torch.kernels.gr_matmul import SIMT_THIN_CONFIGS, simt_grid
    from repro_torch.kernels.ops import TC_LEFT_MAX_T, route_takes

    rng = np.random.default_rng(SEED)
    worst = dict.fromkeys(COUNTED, 0)
    checked = {r: [] for r in ROUTES}

    def check(route, ring, lead, t, r, s, what=""):
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        _hold(route, ring, A, B, worst, what, every_config=True)

    for spec in RING_SPECS:
        ring = make_ring(*spec)
        for route in ROUTES:
            extra = {"tc": TC_SHAPES, "skinny": SKINNY_SHAPES, "tower": TOWER_SHAPES,
                     "tc_left": TC_LEFT_SHAPES}.get(route, [])
            # (tc_left: its t <= TC_LEFT_MAX_T, which route_takes leaves to pick_route)
            shapes = [x for x in SHAPES + extra if route_takes(route, ring, x[0], x[1])
                      and (route != "tc_left" or x[0] <= TC_LEFT_MAX_T)]
            if not shapes:
                continue
            for t, r, s in shapes:
                check(route, ring, (), t, r, s)
            nb, t, r, s = BATCHED[route]
            check(route, ring, (nb,), t, r, s, " (batched)")
            checked[route].append(f"{ring.degrees}:K={ring.K}:{len(shapes) + 1} shapes")
    # simt at every instantiation: every tower of its tile kernel and every
    # (D, rc, nn) of its thin kernel, e = 32 and 31, ragged r and s; the thin
    # kernel once more at eight stages (R split up to 8 ways), batched
    thin_reached, towers_reached = set(), set()
    for d0, d1 in SIMT_TOWERS:
        for e in (32, 31):
            ring = make_ring(2, e, tuple(d for d in (d0, d1) if d > 1))
            for t in SIMT_TS:
                check("simt", ring, (), t, SIMT_R, SIMT_S, " (every instantiation)")
                grid = simt_grid(ring, 1, t, SIMT_R, SIMT_S, 132)
                if grid[0]:
                    thin_reached.add((ring.D, *grid[5:9]))
                    check("simt", ring, (2,), t, 300, 9, " (thin, R split)")
                else:
                    towers_reached.add((d0, d1))
    if thin_reached != set(SIMT_THIN_CONFIGS) or towers_reached != set(SIMT_TOWERS):
        fail(f"simt instantiations not all reached: thin {sorted(thin_reached)}, tile "
             f"{sorted(towers_reached)}")
    checked["simt"].append(f"every instantiation: {len(SIMT_TOWERS)} towers, thin "
                           f"{sorted(thin_reached)}, t in {SIMT_TS}, e = 32 and 31")
    # every ring the tc route lifts, at every instantiation of its inner
    # ring, and the widened skinny route at its new t and r
    for spec in LIFT_SPECS:
        ring = make_ring(*spec)
        for t, r, s in TC_SHAPES:
            check("tc", ring, (), t, r, s, " (lifted)")
        nb, t, r, s = BATCHED["tc"]
        check("tc", ring, (nb,), t, r, s, " (lifted, batched)")
        checked["tc"].append(f"lifted {ring.degrees} e={ring.e}:{len(TC_SHAPES) + 1} shapes")
        # and tc_left (every stack instantiation, every tile width): its
        # shapes, a batch, and both edges of its stage and of its layout
        for t, r, s in TC_LEFT_SHAPES + [(9, r, 259) for r in _left_edges(ring)]:
            check("tc_left", ring, (), t, r, s, " (lifted)")
        nb, t, r, s = BATCHED["tc_left"]
        check("tc_left", ring, (nb,), t, r, s, " (lifted, batched)")
        checked["tc_left"].append(f"lifted {ring.degrees} e={ring.e}:"
                                  f"{len(TC_LEFT_SHAPES) + 5} shapes")
    for deg, t, r, s in LEFT_GRID_SHAPES:
        ring = make_ring(2, 32, deg)
        check("tc_left", ring, (), t, r, s, " (past 65535 column tiles)")
        checked["tc_left"].append(f"{ring.degrees} {(t, r, s)} past 65535 column tiles")
        torch.cuda.empty_cache()
    for spec in RING_SPECS + WIDE_SKINNY_SPECS:
        ring = make_ring(*spec)
        shapes = [x for x in SKINNY_WIDE_SHAPES if route_takes("skinny", ring, x[0], x[1])]
        for t, r, s in shapes:
            check("skinny", ring, (), t, r, s, " (widened)")
        if shapes and route_takes("skinny", ring, 64, 32):
            check("skinny", ring, (2,), 64, 32, 77, " (widened, batched)")
            checked["skinny"].append(f"widened {ring.degrees}:{len(shapes) + 1} shapes")
    for route in ROUTES:
        log(f"{route} == plain: {checked[route]}")
    report["tc_accumulate"] = _tc_wrap_check(worst)
    report["simt_accumulate"] = _simt_wrap_check(worst)
    # ElasticStream's step over the (3, 7) tower: each of its ring matmuls
    # on the route pick_route gives it, at every instantiation, and simt
    tower = make_ring(2, 32, (3, 7))
    for name, nb, t, r, s in STEP9_SHAPES:
        lead = (nb,) if nb else ()
        A = tower.random(rng, lead + (t, r), device="cuda")
        B = tower.random(rng, lead + (r, s), device="cuda")
        plain = gr_matmul_ref(A, B, tower)
        route = pick_route(tower, t, r, s)
        for rt in dict.fromkeys((route, "simt")):
            _hold(rt, tower, A, B, worst, f" (step 9 {name})", plain=plain, every_config=True)
        checked[route].append(f"step 9 {name} {lead + (t, r, s)}")
        del A, B, plain
        torch.cuda.empty_cache()
    log(f"step 9 == plain: {[c for rt in ROUTES for c in checked[rt] if c.startswith('step')]}")

    timings = {}
    for name, (deg, nb, t, r, s) in _main_path_shapes().items():
        ring = make_ring(2, 32, deg)
        lead = (nb,) if nb else ()
        b = nb or 1
        route = pick_route(ring, t, r, s)
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        holder = {}
        plain_ms = cuda_ms(lambda: holder.__setitem__("C", gr_matmul_ref(A, B, ring)))
        plain = holder.pop("C")
        for rt in dict.fromkeys(("simt", route)):
            _hold(rt, ring, A, B, worst, f" (main-path shape {name})", plain=plain)
        del plain
        row = {"ring": str(ring.degrees), "batch": b, "t": t, "r": r, "s": s,
               **_timing_row(ring, A, B, route, plain_ms)}
        timings[name] = row
        log(f"main-path shape {name}: {json.dumps(row)}")
        del A, B
        torch.cuda.empty_cache()
    report["kernel_checks"] = checked
    report["kernel_max_abs_err"] = worst
    report["kernel_timings"] = timings
    report["thresholds"] = _threshold_timings(rng, worst)
    return timings


# shapes at the edges of the dispatch rule (ops.pick_route): (ring degrees,
# batch, t, r, s); every route whose kernel takes the shape is timed
EDGE_SHAPES = {
    "skinny_t16": ((3,), None, 16, 16, 1 << 16),
    "skinny_t17": ((3,), None, 17, 2, 1 << 20),  # simt's until skinny took t <= 64
    "simt_t48": ((3,), 8, 48, 96, 32),           # the worker product of ep at 96^3
    "tc_t64": ((3,), 8, 64, 1024, 64),
    "tc_t128": ((3,), 8, 128, 512, 128),
    # 64 workers over GR(2^32, 6): encode a, where skinny and the lifted tc
    # both take t = 64, and the 32 x 32 decode
    "skinny_t64": ((6,), None, 64, 4, 1 << 20),
    "skinny_r32": ((6,), None, 32, 32, 1 << 17),
}


def _threshold_timings(rng, worst: dict) -> dict:
    """Each accepting route at each edge shape, held against the plain
    version and then timed in turns (a, b, ..., b, a), so that the
    thresholds of ops.pick_route rest on this run's numbers."""
    from repro_torch.core import make_ring
    from repro_torch.kernels import gr_matmul_ref, pick_route, run_route
    from repro_torch.kernels.ops import route_takes

    out = {}
    for name, (deg, nb, t, r, s) in EDGE_SHAPES.items():
        ring = make_ring(2, 32, deg)
        lead = (nb,) if nb else ()
        A = ring.random(rng, lead + (t, r), device="cuda")
        B = ring.random(rng, lead + (r, s), device="cuda")
        routes = [rt for rt in ROUTES if route_takes(rt, ring, t, r)]
        plain = gr_matmul_ref(A, B, ring)
        for rt in routes:
            _hold(rt, ring, A, B, worst, f" (edge shape {name})", plain=plain)
        del plain
        order = routes + routes[::-1]
        ms = {rt: 0.0 for rt in routes}
        eager = {rt: 0.0 for rt in routes}
        for rt in order:
            fn = lambda rt=rt: run_route(rt, A, B, ring)
            ms[rt] += graph_ms(fn) / 2
            eager[rt] += cuda_ms(fn, iters=10, warmup=2) / 2
        # device time decides where a kernel dominates; eager time (launched
        # from Python, host overhead included) is what a small call costs
        row = {"ring": str(deg), "shape": [nb or 1, t, r, s], "picked": pick_route(ring, t, r, s),
               "ms": ms,
               "eager_ms": eager, "fastest": min(ms, key=ms.get),
               "fastest_eager": min(eager, key=eager.get)}
        out[name] = row
        log(f"threshold {name}: {json.dumps(row)}")
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _direct(As, Bs, ring):
    """Oracle: direct products over the data ring by the plain version."""
    import torch

    from repro_torch.kernels import gr_matmul_ref

    if As.dim() == 4:
        return torch.stack([gr_matmul_ref(As[i], Bs[i], ring) for i in range(As.shape[0])])
    return gr_matmul_ref(As, Bs, ring)


@contextlib.contextmanager
def _recording_routes(calls: list):
    """Append (route, ring, A's shape, B's shape) of every ring matmul that
    ``ops.gr_matmul`` sends to a kernel to ``calls``, so that the kernels can
    be held against the plain version at exactly the shapes a path gave them."""
    from repro_torch.kernels import ops

    inner = ops.run_route

    def run_route(route, A, B, ring):
        calls.append((route, ring, tuple(A.shape), tuple(B.shape)))
        return inner(route, A, B, ring)

    ops.run_route = run_route
    try:
        yield
    finally:
        ops.run_route = inner


def _counted(name, fn, calls, expect=None):
    """Run ``fn`` (one path) with the launch counts zeroed just before and
    read just after, and with every ring matmul it hands a kernel recorded
    into ``calls``; the counts must equal ``EXPECTED_LAUNCHES[name]``, or
    ``expect(fn's result)`` when given (a ring matmul on the card that no
    kernel takes raises, so the plain version never runs there).  Returns
    (fn's result, launches by route, synchronized wall ms)."""
    import torch

    from repro_torch.kernels import counters

    torch.cuda.synchronize()
    path_calls = []
    counters.reset()
    t0 = time.perf_counter()
    with _recording_routes(path_calls):
        out = fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    by_route = dict(counters.launches_by_route)
    want = EXPECTED_LAUNCHES[name] if expect is None else expect(out)
    if by_route != want:
        fail(f"{name}: launches per route {by_route}, expected {want}")
    recorded = {rt: sum(c[0] == rt for c in path_calls) for rt in ROUTES}
    if any(recorded[rt] != by_route[rt] for rt in ROUTES):
        fail(f"{name}: recorded ring matmuls {recorded} != launches {by_route}")
    calls.extend((name,) + c for c in path_calls)
    return out, by_route, wall_ms


def _run_path(name, family, scheme_or_plan, A, B, mask, report, calls, key=None):
    """Drive one path through ``coded_matmul`` with the counts zeroed just
    before and read just after; returns (launches by route, the scheme, the
    direct product)."""
    import torch

    from repro_torch.cdmm import coded_matmul, decode_from, encode_all, live_indices
    from repro_torch.cdmm.planner import Plan

    torch.cuda.reset_peak_memory_stats()
    C, by_route, wall_ms = _counted(name, lambda: coded_matmul(
        A, B, scheme_or_plan, backend="local", mask=mask, key=key, device="cuda"), calls)
    peak_bytes = torch.cuda.max_memory_allocated()  # the round's, beside what earlier paths hold
    scheme = (scheme_or_plan.instantiate(device="cuda")
              if isinstance(scheme_or_plan, Plan) else scheme_or_plan)
    expect = _direct(A, B, scheme.base)
    err = max_abs_err(C, expect)
    if err:
        fail(f"{name}: coded result != direct product (err {err})")
    # stage device times of 5 warm runs each (mean, and every run), through
    # the helpers the local backend uses
    idx = live_indices(scheme, mask)
    st = {}
    stages = {}
    for stage, fn in [
        ("encode", lambda: st.__setitem__("enc", encode_all(scheme, A, B, key=key))),
        ("compute", lambda: st.__setitem__("H", scheme.worker_compute(*st["enc"]))),
        ("decode", lambda: st.__setitem__("C", decode_from(scheme, st["H"], idx))),
    ]:
        runs = cuda_runs_ms(fn, 5)
        stages[f"{stage}_ms"] = sum(runs) / len(runs)
        stages[f"{stage}_runs_ms"] = runs
    if max_abs_err(st["C"], expect):
        fail(f"{name}: staged run != direct product")
    row = {"path": name, "scheme": family, "partition": list(scheme.partition),
           "ring": str(scheme.ring), "R": scheme.R, "live": idx.tolist(), "shape": list(A.shape),
           "launches_by_route": by_route, "first_call_wall_ms": wall_ms, "peak_bytes": peak_bytes,
           **stages}
    if getattr(scheme, "kappa", None):
        row["kappa"] = scheme.kappa
    log(f"path {json.dumps(row)}")
    report.setdefault("paths", []).append(row)
    return by_route, scheme, expect


def _secure_checks(name, scheme, A, B, expect, report, mask=None) -> None:
    """The keyed encode on the card: worker i's own share is row i of the
    master encode (both sides), a second key gives other shares and the
    same product, and the mask words are uniform in their top bit.
    ``mask``: the path's live workers (None: ``MASK``)."""
    import torch

    from repro_torch.cdmm import coded_matmul, live_indices

    if mask is None:
        mask = torch.tensor(MASK, device="cuda")
    i = int(live_indices(scheme, mask)[2])  # a live worker, not worker 0
    FA, GB = scheme.encode_a(A, key=KEY), scheme.encode_b(B, key=KEY)
    if max_abs_err(scheme.encode_a_at(A, i, key=KEY), FA[i]) or \
            max_abs_err(scheme.encode_b_at(B, i, key=KEY), GB[i]):
        fail(f"{name}: encode_*_at(.., {i}, key) != row {i} of encode_*(.., key)")
    if torch.equal(scheme.encode_a(A, key=KEY + 1), FA) or \
            torch.equal(scheme.encode_b(B, key=KEY + 1), GB):
        fail(f"{name}: two keys gave the same shares")
    del FA, GB
    if max_abs_err(coded_matmul(A, B, scheme, mask=mask, key=KEY + 1, device="cuda"), expect):
        fail(f"{name}: the second key's product != direct product")
    code = scheme.code
    t, r = A.shape[-3], A.shape[-2]  # (n?, t, r, D0)
    Z = code.masks_a(KEY, t // code.u, r // code.w)
    words = Z.numel()
    top = (Z < 0).sum().item() / words  # int32 bit patterns: sign bit = word's top bit
    row = {"path": name, "worker": i, "mask_words": words, "mask_top_bit_share": top}
    if words < 10**6 or abs(top - 0.5) > 0.01:
        fail(f"{name}: mask top bit set in {top:.4f} of {words} words, not 0.5 +- 0.01")
    log(f"secure checks {json.dumps(row)}")
    report.setdefault("secure_checks", []).append(row)


def phase_main_path(report: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, ProblemSpec, plan
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED)
    Z32 = make_ring(2, 32, ())
    mask = torch.tensor(MASK, device="cuda")
    totals = dict.fromkeys(COUNTED, 0)
    calls: list = []

    def add(by_route):
        for k, v in by_route.items():
            totals[k] += v

    As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    scheme = BatchRMFEAdapter(Z32, n=2, N=8, u=2, v=2, w=1, device="cuda")
    add(_run_path("batch_ep_rmfe", "batch_ep_rmfe", scheme, As, Bs, mask, report, calls)[0])
    del As, Bs
    torch.cuda.empty_cache()

    for name, family, ring, size in [("ep", "ep", make_ring(2, 32, (3,)), SINGLE_SIZE),
                                     ("plain", "plain", Z32, SINGLE_SIZE),
                                     ("ep_rmfe1", "ep_rmfe1", Z32, SINGLE_SIZE),
                                     ("ep_rmfe2", "ep_rmfe2", Z32, SINGLE_SIZE),
                                     ("ep_small", "ep", make_ring(2, 32, (3,)), SMALL_SIZE)]:
        spec = ProblemSpec(size, size, size, n=1, ring=ring, N=8, straggler_budget=2)
        p = plan(spec, schemes=[family])
        A = ring.random(rng, (size, size), device="cuda")
        B = ring.random(rng, (size, size), device="cuda")
        add(_run_path(name, family, p, A, B, mask, report, calls)[0])
        del A, B
        torch.cuda.empty_cache()

    for name, n, size, privacy_t in SLICE3_PATHS:
        spec = ProblemSpec(size, size, size, n=n, ring=Z32, N=8, straggler_budget=2,
                           privacy_t=privacy_t)
        p = plan(spec, schemes=[name])
        lead = (n,) if n > 1 else ()
        A = Z32.random(rng, lead + (size, size), device="cuda")
        B = Z32.random(rng, lead + (size, size), device="cuda")
        key = KEY if privacy_t else None
        by_route, scheme, expect = _run_path(name, name, p, A, B, mask, report, calls, key=key)
        add(by_route)
        if scheme.ring.degrees != (4,):
            fail(f"{name}: planned over {scheme.ring}, expected GR(2^32, 4)")
        if privacy_t:
            _secure_checks(name, scheme, A, B, expect, report)
        del A, B, expect
        torch.cuda.empty_cache()

    # the planner's wider rings: its best plan (analytic cost model) for 16
    # workers at n = 4, 64 workers at n = 2 and a keyed single product on 16
    # workers, each over the ring and partition the plan must name
    for name, family, n, N, budget, privacy_t, size, want, dead in WIDE_PATHS:
        spec = ProblemSpec(size, size, size, n=n, ring=Z32, N=N, straggler_budget=budget,
                           privacy_t=privacy_t)
        p = plan(spec, calibration=False)
        c = p.candidates[0]
        got = (c.scheme, (c.u, c.v, c.w), c.costs.R)
        if got != (family, want[1], want[2]):
            fail(f"{name}: planned {got}, expected {(family, want[1], want[2])}")
        wide_mask = torch.ones(N, dtype=torch.bool, device="cuda")
        wide_mask[list(dead)] = False
        lead = (n,) if n > 1 else ()
        A = Z32.random(rng, lead + (size, size), device="cuda")
        B = Z32.random(rng, lead + (size, size), device="cuda")
        key = KEY if privacy_t else None
        by_route, scheme, expect = _run_path(name, family, p, A, B, wide_mask, report, calls,
                                             key=key)
        add(by_route)
        if scheme.ring.degrees != want[0]:
            fail(f"{name}: planned over {scheme.ring}, expected degrees {want[0]}")
        if privacy_t:
            _secure_checks(name, scheme, A, B, expect, report, mask=wide_mask)
        del A, B, expect
        torch.cuda.empty_cache()
    report["main_path_launches"] = totals
    return totals, calls


def phase_path_calls(report: dict, calls: list) -> None:
    """Hold each route at every distinct (ring, shape) that phases 3 and 5-9
    gave it, on fresh random operands of that shape, bit for bit: this
    covers every batch slice of a worker launch, the dead workers' ones too,
    which the end-to-end check cannot see because decode never reads them.
    A call past ``PLAIN_WORDS_CAP`` is held against the plain version on
    its first batch entry and against ``simt`` on all of them.  The shapes
    of the GCSA, secure and wider-ring paths, of ep's 96^3 request and of
    phases 5-9 are timed as well (``_timing_row``), with the plain
    version's time from the same call that holds them."""
    import numpy as np
    import torch

    from repro_torch.kernels import gr_matmul_ref, run_route

    rng = np.random.default_rng(SEED + 1)
    worst = report["kernel_max_abs_err"]
    # and ep's 96^3 request, whose 48-row worker blocks are simt's one main-path call
    timed_paths = ({name for name, *_ in SLICE3_PATHS} | set(SLICE4_PATHS) | set(SLICE5_PATHS)
                   | {name for name, *_ in WIDE_PATHS} | {"ep_small"})
    seen = {}
    for path, route, ring, a_shape, b_shape in calls:
        key = (route, ring.p, ring.e, ring.degrees, a_shape, b_shape)
        seen.setdefault(key, (ring, []))[1].append(path)
    timings = []
    for (route, _, _, _, a_shape, b_shape), (ring, paths) in seen.items():
        A = ring.random(rng, a_shape[:-1], device="cuda")
        B = ring.random(rng, b_shape[:-1], device="cuda")
        b = a_shape[0] if len(a_shape) == 4 else 1
        words = b * a_shape[-3] * a_shape[-2] * b_shape[-2] * ring.D ** 2
        first = len(a_shape) == 4 and words > PLAIN_WORDS_CAP
        holder = {}
        plain_ms = cuda_ms(lambda: holder.__setitem__(
            "C", gr_matmul_ref(A[:1], B[:1], ring) if first else gr_matmul_ref(A, B, ring)))
        plain = holder.pop("C")
        timed = bool(timed_paths.intersection(paths))
        if first:  # simt on every entry, itself held on the first
            _hold("simt", ring, A, B, worst, " (a phase-3 call)", plain=plain, first=True)
            del plain
            plain = run_route("simt", A, B, ring)
            if route != "simt":
                _hold(route, ring, A, B, worst, " (a phase-3 call, against simt)", plain=plain,
                      planes_first=True)
        else:
            for rt in dict.fromkeys(("simt", route) if timed else (route,)):
                _hold(rt, ring, A, B, worst, " (a phase-3 call)", plain=plain)
        # tc_left's rival: the B-lifted tc it replaced, held before it is timed
        rivals = ("tc",) if timed and route == "tc_left" else ()
        # the plain versions of tc_left's pre-passes: at the kernels line's call only
        line_call = (ring.degrees, tuple(a_shape[:-1])) == LEFT_LINE_CALL
        for rt in rivals:
            _hold(rt, ring, A, B, worst, " (a phase-3 call, the route tc_left replaced)",
                  plain=plain, planes=False)
        del plain
        if timed:
            row = {"paths": sorted(set(paths)), "ring": str(ring.degrees),
                   "a": list(a_shape[:-1]), "b": list(b_shape[:-1]),
                   **_timing_row(ring, A, B, route, plain_ms, plain_batch=1 if first else None,
                                 rivals=rivals, plain_prepasses=route != "tc_left" or line_call)}
            timings.append(row)
            log(f"timed path shape: {json.dumps(row)}")
        del A, B
        torch.cuda.empty_cache()
    report["path_calls_checked"] = [f"{k[0]} {k[3]} {k[4][:-1]} x {k[5][:-1]}" for k in seen]
    report["path_kernel_timings"] = timings
    log(f"phase-3, 5-9 calls == plain: {len(calls)} launches at {len(seen)} distinct "
        f"(route, ring, shape): {report['path_calls_checked']}")


# ---------------------------------------------------------------------------
# phases 5-7: the elastic master, ElasticStream, CodedQuantMatmul
# ---------------------------------------------------------------------------


def _slow_trace():
    """Workers 1 and 3 slow, 2 and 5 dead (they leave before joining)."""
    import numpy as np

    from repro_torch.core import WorkerTrace

    return WorkerTrace(np.zeros(8), np.full(8, np.inf),
                       np.array(TRACE_COMPUTE_MS, dtype=float)).restrict(MASK)


def _span_stages(call, runs: int = 5) -> dict:
    """Run ``call`` (one traced elastic round, stragglers drained) ``runs``
    times with ``repro_torch.obs`` tracing on, and read its stages from the
    spans: the master's encode of each share, each worker's compute (launch
    to its event, so device time), ``wait_R``, the decode's host time, and
    the synchronized wall.  Spans time the host side, as in the reference."""
    import torch

    from repro_torch import obs

    per_run = []
    obs.set_enabled(True)
    try:
        for _ in range(runs):
            obs.tracer().clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            spans = list(obs.tracer()._spans)
            ms = lambda name, comp: {int(x.tags.get("wid", x.tags.get("share", -1))):  # noqa: E731
                                     1e3 * x.duration_s for x in spans
                                     if x.name == name and x.component == comp}
            one = lambda name: sum(1e3 * x.duration_s for x in spans if x.name == name  # noqa: E731
                                   and x.component == "elastic")
            per_run.append({"encode_ms": ms("encode", "elastic"), "compute_ms": ms("compute", "worker"),
                            "wait_R_ms": one("wait_R"), "decode_ms": one("decode"), "wall_ms": wall})
    finally:
        obs.set_enabled(None)
        obs.tracer().clear()
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return {
        "encode_per_worker_ms": mean([mean(list(r["encode_ms"].values())) for r in per_run]),
        "compute_per_worker_ms": mean([mean(list(r["compute_ms"].values())) for r in per_run]),
        "compute_max_ms": mean([max(r["compute_ms"].values()) for r in per_run]),
        "wait_R_ms": mean([r["wait_R_ms"] for r in per_run]),
        "decode_ms": mean([r["decode_ms"] for r in per_run]),
        "wall_ms": mean([r["wall_ms"] for r in per_run]),
        "runs": per_run,
    }


def phase_elastic(report: dict, calls: list) -> dict:
    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, ElasticBackend, ProblemSpec, coded_matmul, plan
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED + 2)
    Z32 = make_ring(2, 32, ())
    mask = torch.tensor(MASK, device="cuda")
    trace = _slow_trace()
    totals = dict.fromkeys(COUNTED, 0)
    rows = {}

    def add(by_route):
        for k, v in by_route.items():
            totals[k] += v

    As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    scheme = BatchRMFEAdapter(Z32, n=2, N=8, u=2, v=2, w=1, device="cuda")
    expect = _direct(As, Bs, Z32)
    local = coded_matmul(As, Bs, scheme, backend="local", mask=mask)  # the oracle, not counted
    if max_abs_err(local, expect):
        fail("elastic: the local oracle != direct product")

    # (a) all-live fast path: local's round, local's launches
    eb = ElasticBackend()
    C, by_route, wall = _counted("elastic_all_live",
                                 lambda: coded_matmul(As, Bs, scheme, backend=eb), calls)
    add(by_route)
    if not eb.last_stats.fast_path or max_abs_err(C, expect):
        fail(f"elastic_all_live: fast_path={eb.last_stats.fast_path}, output != direct product")
    rows["elastic_all_live"] = {"launches_by_route": by_route, "first_call_wall_ms": wall}

    # (b) traced: the decode reads the R fastest arrivals
    eb = ElasticBackend(trace=trace)

    def traced():
        out = coded_matmul(As, Bs, scheme, backend=eb)
        eb.drain()  # the slow and dead workers' launches belong to this round
        return out

    C, by_route, wall = _counted("elastic_traced", traced, calls)
    add(by_route)
    st = eb.last_stats
    if st.live_idx != (0, 4, 6, 7):
        fail(f"elastic_traced: decoded from {st.live_idx}, expected (0, 4, 6, 7)")
    if max_abs_err(C, local) or max_abs_err(C, expect):
        fail("elastic_traced: output != local's / the direct product")
    rows["elastic_traced"] = {"launches_by_route": by_route, "first_call_wall_ms": wall,
                              "stats": vars(st), **_span_stages(traced)}
    eb.close()

    # (c) the race past stragglers: latencies simulated at RACE_SCALE
    eb = ElasticBackend(trace=trace, simulate_ms_scale=RACE_SCALE)

    def race():
        out = coded_matmul(As, Bs, scheme, backend=eb)
        torch.cuda.synchronize()
        return out

    race()  # warm
    eb.drain()
    C, by_route, _ = _counted("elastic_race", lambda: (race(), eb.drain())[0], calls)
    add(by_route)
    if max_abs_err(C, expect):
        fail("elastic_race: output != direct product")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        C = race()
        walls.append(1e3 * (time.perf_counter() - t0))
        eb.drain()
        if max_abs_err(C, expect):
            fail("elastic_race: output != direct product")
    st = eb.last_stats
    # the barrier a synchronous master pays: the last responder's arrival
    # (time_to_all_ms is inf here: dead workers never respond)
    barrier_ms = trace.time_to_kth_response(st.n_responders) * RACE_SCALE
    race_row = {"time_to_R_ms_scaled": st.time_to_R_ms * RACE_SCALE,
                "time_to_all_ms_scaled": st.time_to_all_ms * RACE_SCALE,
                "barrier_ms": barrier_ms, "wall_ms_runs": walls,
                "stats_wall_ms": st.wall_ms, "launches_by_route": by_route}
    log(f"elastic race: {json.dumps(race_row)}")
    if max(walls) >= barrier_ms / 2:
        fail(f"elastic_race: wall {max(walls):.1f} ms >= half the {barrier_ms:.0f} ms barrier")
    rows["elastic_race"] = race_row
    eb.close()
    del As, Bs, expect, local, C
    torch.cuda.empty_cache()

    # (d) a secure scheme through the traced path, keyed
    spec = ProblemSpec(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, n=2, ring=Z32, N=8,
                       straggler_budget=2, privacy_t=1)
    sch = plan(spec, schemes=["ep_rmfe_secure"]).instantiate(device="cuda")
    A = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
    B = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
    expect = _direct(A, B, Z32)
    local = coded_matmul(A, B, sch, backend="local", mask=mask, key=KEY)
    eb = ElasticBackend(trace=trace)

    def secure():
        out = coded_matmul(A, B, sch, backend=eb, key=KEY)
        eb.drain()
        return out

    C, by_route, wall = _counted("elastic_secure", secure, calls)
    add(by_route)
    if sch.ring.degrees != (4,) or max_abs_err(C, local) or max_abs_err(C, expect):
        fail(f"elastic_secure over {sch.ring}: output != local's (same key) / direct product")
    rows["elastic_secure"] = {"scheme": sch.name, "partition": list(sch.partition), "R": sch.R,
                              "launches_by_route": by_route, "first_call_wall_ms": wall,
                              "stats": vars(eb.last_stats), **_span_stages(secure)}
    eb.close()
    for name, row in rows.items():
        log(f"elastic path {name}: " + json.dumps({k: v for k, v in row.items() if k != "runs"},
                                                   default=str))
    report["elastic"] = rows
    return totals


def phase_stream(report: dict, calls: list) -> dict:
    import numpy as np
    import torch

    from repro_torch.cdmm import ElasticStream, NotEnoughResponders
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED + 3)
    Z32 = make_ring(2, 32, ())
    totals = dict.fromkeys(COUNTED, 0)
    As = Z32.random(rng, (STREAM_PRODUCTS, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
    Bs = Z32.random(rng, (STREAM_PRODUCTS, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
    expect = _direct(As, Bs, Z32)
    st = ElasticStream(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, Z32, group_size=8, device="cuda")
    rows = []
    for live, replan in STREAM_STEPS:
        name = f"stream_{live}"
        Cs, by_route, wall = _counted(name, lambda: st.step(As, Bs, live=live), calls)
        for k, v in by_route.items():
            totals[k] += v
        sch = st._schemes[st.last_replan[1]]
        row = {"path": name, "live": live, "replan": list(st.last_replan), "scheme": sch.name,
               "partition": list(sch.partition), "ring": str(sch.ring), "R": sch.R,
               "launches_by_route": by_route, "first_call_wall_ms": wall}
        log(f"stream step {json.dumps(row)}")
        if st.last_replan != replan:
            fail(f"{name}: last_replan {st.last_replan}, expected {replan}")
        if max_abs_err(Cs, expect):
            fail(f"{name}: outputs != direct products")
        rows.append(row)
    try:
        st.step(As, Bs, live=7)
        fail("stream: 7 live workers did not raise NotEnoughResponders")
    except NotEnoughResponders:
        pass
    # step 9 warm: CUDA events around each of STREAM_WARM steps (after one
    # step to replan back from 24 live workers), beside its first call
    st.step(As, Bs, live=9)
    warm = []
    for _ in range(STREAM_WARM):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        Cs = st.step(As, Bs, live=9)
        end.record()
        torch.cuda.synchronize()
        warm.append(start.elapsed_time(end))
        if max_abs_err(Cs, expect):
            fail("stream_9 warm: outputs != direct products")
    row9 = next(r for r in rows if r["live"] == 9)
    row9["warm_ms_runs"], row9["warm_ms"] = warm, sum(warm) / len(warm)
    log(f"stream step 9 warm: {json.dumps({k: row9[k] for k in ('warm_ms', 'warm_ms_runs', 'first_call_wall_ms')})}")
    st.backend.close()
    report["stream"] = rows
    del As, Bs, expect
    torch.cuda.empty_cache()
    return totals


def phase_quantized(report: dict, calls: list) -> dict:
    import torch

    from repro_torch.cdmm import CodedQuantMatmul, decode_from, encode_all, quantize_int8
    from repro_torch.cdmm.quantized import lift_i8_to_ring

    tokens, d_model, d_ff = QUANT_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((tokens, d_model), generator=gen, device="cuda")
    w = torch.randn((d_model, d_ff), generator=gen, device="cuda")
    cq = CodedQuantMatmul(QUANT_N, None, device="cuda")
    sch = cq.scheme
    mask = torch.zeros(QUANT_N, dtype=torch.bool, device="cuda")
    mask[list(QUANT_LIVE)] = True  # N - R dead
    if int(mask.sum()) != cq.R:
        fail(f"quantized: R = {cq.R}, expected {len(QUANT_LIVE)}")
    log(f"CodedQuantMatmul: N = {QUANT_N}, R = {cq.R}, ring {sch.ring}, partition "
        f"{sch.partition}, live {QUANT_LIVE}")
    y, by_route, wall = _counted("quantized", lambda: cq(x, w, mask), calls)
    if not torch.equal(y.view(torch.int32), cq(x, w).view(torch.int32)):
        fail("quantized: output under dead workers != output without deaths")
    qx, sx = quantize_int8(x, axis=-1)
    qw, sw = quantize_int8(w, axis=0)
    # the card's quantization is the CPU's (the reference's float32 order)
    for (q, sc), (q_cpu, sc_cpu) in (((qx, sx), quantize_int8(x.cpu(), axis=-1)),
                                     ((qw, sw), quantize_int8(w.cpu(), axis=0))):
        if not (torch.equal(q.cpu(), q_cpu) and torch.equal(sc.cpu().view(torch.int32),
                                                            sc_cpu.view(torch.int32))):
            fail("quantized: quantize_int8 on the card != on the CPU")
    acc = cq.exact_int_matmul(qx, qw, mask)
    qw_cols = qw.t().contiguous().t()  # column-major, the layout cuBLASLt's int8 GEMM takes
    oracle = torch._int_mm(qx, qw_cols)  # an oracle only: never on the port's path
    if not torch.equal(acc, oracle):
        fail("quantized: exact_int_matmul != torch._int_mm of the int8 operands")
    # and the dequantized output is the reference's float32 product order
    # (acc * sx * sw), computed on the CPU from the oracle's integers
    y_cpu = oracle.cpu().to(torch.float32) * sx.cpu() * sw.cpu()
    if not torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32)):
        fail("quantized: dequantized output != acc * sx * sw on the CPU")
    # stage device times of 5 warm runs, through the local backend's helpers
    A, B = lift_i8_to_ring(qx), lift_i8_to_ring(qw)
    idx = torch.tensor(QUANT_LIVE, device="cuda")
    st, stages = {}, {}
    for stage, fn in [
        ("encode", lambda: st.__setitem__("enc", encode_all(sch, A, B))),
        ("compute", lambda: st.__setitem__("H", sch.worker_compute(*st["enc"]))),
        ("decode", lambda: st.__setitem__("C", decode_from(sch, st["H"], idx))),
    ]:
        runs = cuda_runs_ms(fn, 5)
        stages[f"{stage}_ms"] = sum(runs) / len(runs)
        stages[f"{stage}_runs_ms"] = runs
    if not torch.equal(st["C"][..., 0], oracle):
        fail("quantized: staged run != torch._int_mm")
    row = {"path": "quantized", "shape": list(QUANT_SHAPE), "N": QUANT_N, "R": cq.R,
           "ring": str(sch.ring), "partition": list(sch.partition), "live": list(QUANT_LIVE),
           "launches_by_route": by_route, "first_call_wall_ms": wall, **stages,
           "int_mm_oracle_ms": cuda_ms(lambda: torch._int_mm(qx, qw_cols), iters=5, warmup=1)}
    log(f"path {json.dumps(row)}")
    report["quantized"] = row
    del x, w, y, y_cpu, qx, qw, qw_cols, acc, oracle, A, B, st
    torch.cuda.empty_cache()
    decode = report["quantized_decode"] = _quantized_decode(cq, mask, gen, calls)
    return {rt: n + sum(row["launches_by_route"][rt] for row in decode)
            for rt, n in by_route.items()}


def _quantized_decode(cq, mask, gen, calls) -> list:
    """``CodedQuantMatmul`` at decode batch sizes (``QUANT_DECODE_TOKENS``)
    through both projections of gemma2-2b's FFN, 12 of 16 workers dead: each
    call bit-identical to the run without deaths, its exact product equal to
    the int8 product (``torch._int_mm`` where it takes the shape, m > 16;
    else the int64 product on the CPU), the dequantized output that product
    times the scales; simt takes the worker product (``EXPECTED_LAUNCHES``)."""
    import torch

    from repro_torch.cdmm import quantize_int8

    _, d_model, d_ff = QUANT_SHAPE
    rows = []
    for tokens in QUANT_DECODE_TOKENS:
        for proj, (d_in, d_out) in (("up", (d_model, d_ff)), ("down", (d_ff, d_model))):
            name = f"quantized_t{tokens}_{proj}"
            x = torch.randn((tokens, d_in), generator=gen, device="cuda")
            w = torch.randn((d_in, d_out), generator=gen, device="cuda")
            y, by_route, wall = _counted(name, lambda: cq(x, w, mask), calls)
            if not torch.equal(y.view(torch.int32), cq(x, w).view(torch.int32)):
                fail(f"{name}: output under dead workers != output without deaths")
            qx, sx = quantize_int8(x, axis=-1)
            qw, sw = quantize_int8(w, axis=0)
            acc = cq.exact_int_matmul(qx, qw, mask)
            if tokens > 16:  # an oracle only: never on the port's path
                oracle, how = torch._int_mm(qx, qw.t().contiguous().t()).cpu(), "torch._int_mm"
            else:
                oracle = (qx.cpu().to(torch.int64) @ qw.cpu().to(torch.int64)).to(torch.int32)
                how = "int64 on the CPU"
            if not torch.equal(acc.cpu(), oracle):
                fail(f"{name}: exact_int_matmul != the int8 product ({how})")
            y_cpu = oracle.to(torch.float32) * sx.cpu() * sw.cpu()
            if not torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32)):
                fail(f"{name}: dequantized output != acc * sx * sw on the CPU")
            row = {"path": name, "tokens": tokens, "d_in": d_in, "d_out": d_out,
                   "launches_by_route": by_route, "first_call_wall_ms": wall, "oracle": how,
                   "call_ms": cuda_ms(lambda: cq(x, w, mask), iters=5, warmup=1)}
            log(f"path {json.dumps(row)}")
            rows.append(row)
            del x, w, y, y_cpu, qx, qw, acc, oracle
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 8-9: the worker pool and the continuous-batching server
# ---------------------------------------------------------------------------


def _worker_call(scheme, A, B, key=None):
    """(route, ring, a_shape, b_shape) of the product every worker runs for
    ``scheme``: the shapes of share 0, drawn from the plan outside any count
    (the workers' own launches happen in other processes)."""
    from repro_torch.kernels import pick_route

    fa, gb = scheme.encode_a_at(A, 0, key=key), scheme.encode_b_at(B, 0, key=key)
    route = pick_route(scheme.ring, fa.shape[0], fa.shape[1], gb.shape[1])
    return route, scheme.ring, tuple(fa.shape), tuple(gb.shape)


def _pool_counted(name, pool, fn, calls, worker_call, expect):
    """``_counted`` for a path on the pool: this process's (the master's)
    launches as there, and the workers' read before and after
    (``Master.worker_launches`` pings every worker, so the products that
    land after the decode are counted too).  ``expect(out)`` gives (the
    master's, the workers' summed) expected launches.  The workers' ring
    matmuls are recorded from the plan, once per launch they report.
    Returns (fn's result, master's launches, workers' launches, wall ms)."""
    before = pool.master.worker_launches()
    out, master, wall_ms = _counted(name, fn, calls, expect=lambda out: expect(out)[0])
    workers = dict.fromkeys(COUNTED, 0)
    for wid, counts in pool.master.worker_launches().items():
        for route, n in counts.items():
            workers[route] += n - before.get(wid, {}).get(route, 0)
    if workers != expect(out)[1]:
        fail(f"{name}: the workers' launches per route {workers}, expected {expect(out)[1]}")
    calls.extend([(name,) + worker_call] * workers[worker_call[0]])
    return out, master, workers, wall_ms


def _pool_warm(pool, scheme, A, B, expect, key=None) -> dict:
    """``WARM_REQUESTS`` requests straight through ``Master.execute``, each
    traced: synchronized wall, time to R, bytes, and the master's spans
    (host time: encode and send per share, wait_R, decode; the workers'
    compute spans, H2D + product + D2H, come back on their result frames)."""
    import torch

    from repro_torch import obs

    runs = []
    for _ in range(WARM_REQUESTS):
        ctx = obs.TraceContext.new("pool")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C, st = pool.master.execute(scheme, A, B, key=key, trace=ctx)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        if max_abs_err(C, expect):
            fail(f"pool warm request ({scheme.name}): output != the oracle")
        spans = obs.tracer().timeline(ctx.trace_id).spans
        ms = lambda name: [1e3 * x.duration_s for x in spans if x.name == name and x.component == "pool"]  # noqa: E731
        compute = [1e3 * x.duration_s for x in spans if x.component == "worker"]
        runs.append({
            "wall_ms": wall, "time_to_R_ms": st.time_to_R_ms, "stats_wall_ms": st.wall_ms,
            "encode_ms": sum(ms("encode")), "send_ms": sum(ms("send")),
            "wait_R_ms": sum(ms("wait_R")), "decode_ms": sum(ms("decode")),
            "worker_compute_ms": compute, "live_idx": list(st.live_idx),
            "raw_bytes_out": st.raw_bytes_out, "bytes_out": st.bytes_out,
            "raw_bytes_in": st.raw_bytes_in, "bytes_in": st.bytes_in, "codecs": list(st.codecs),
        })
    obs.tracer().clear()
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    return {
        "wall_ms_runs": [r["wall_ms"] for r in runs],
        "time_to_R_ms_runs": [r["time_to_R_ms"] for r in runs],
        "time_to_R_ms_p50": med([r["time_to_R_ms"] for r in runs]),
        "time_to_R_ms_max": max(r["time_to_R_ms"] for r in runs),
        "encode_ms_p50": med([r["encode_ms"] for r in runs]),
        "send_ms_p50": med([r["send_ms"] for r in runs]),
        "wait_R_ms_p50": med([r["wait_R_ms"] for r in runs]),
        "decode_ms_p50": med([r["decode_ms"] for r in runs]),
        "worker_compute_ms_p50": med([x for r in runs for x in r["worker_compute_ms"]]),
        "raw_bytes_out": runs[-1]["raw_bytes_out"], "bytes_out": runs[-1]["bytes_out"],
        "raw_bytes_in": runs[-1]["raw_bytes_in"], "bytes_in": runs[-1]["bytes_in"],
        "codecs": runs[-1]["codecs"], "runs": runs,
    }


def phase_pool(report: dict, calls: list) -> dict:
    """``batch_ep_rmfe`` 2048^3 on a ``LocalPool`` of 8 CUDA worker processes
    through ``coded_matmul(..., backend=PoolBackend(pool))``: all live; then
    2 workers SIGKILLed in the middle of a request; then ``ep_rmfe_secure``
    1024^3 with a key on the 6 survivors.  Each against ``local``."""
    import threading

    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, ProblemSpec, coded_matmul, plan
    from repro_torch.core import make_ring
    from repro_torch.dist import LocalPool, PoolBackend, PoolConfig

    rng = np.random.default_rng(SEED + 4)
    Z32 = make_ring(2, 32, ())
    totals = dict.fromkeys(COUNTED, 0)
    rows = {}

    def add(*by_routes):
        for by_route in by_routes:
            for k, v in by_route.items():
                totals[k] += v

    # whole shares (no contraction-axis streaming: one product per share) in
    # raw frames: Z_2^32 words use all 32 bits, so packing saves nothing
    cfg = PoolConfig(workers=POOL_WORKERS, stream_chunk_bytes=0, transport="raw")
    t0 = time.perf_counter()
    pool = LocalPool(config=cfg)
    up_s = time.perf_counter() - t0
    try:
        card = torch.cuda.get_device_name(0)
        hellos = pool.master.worker_caps()
        if len(hellos) != POOL_WORKERS or any(
                c.get("device") != "gpu" or c.get("card") != card for c in hellos.values()):
            fail(f"pool: the workers' hellos do not all name the card: {hellos}")
        # the committed tile cache covers this card's kind
        if any(c["autotune"]["device_entries"] < 1 for c in hellos.values()):
            fail(f"pool: a worker reports no autotune coverage for {card}: {hellos}")
        log(f"pool up in {up_s:.1f} s: {POOL_WORKERS} CUDA worker processes, hello "
            f"{json.dumps({k: hellos[0].get(k) for k in ('device', 'card', 'torch_version', 'kernels', 'autotune')})}")
        report["pool_up_s"] = up_s
        be = PoolBackend(pool)
        expect = lambda out: (POOL_MASTER_LAUNCHES, POOL_WORKER_LAUNCHES)  # noqa: E731

        As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
        Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
        scheme = BatchRMFEAdapter(Z32, n=2, N=8, u=2, v=2, w=1, device="cuda")
        local = coded_matmul(As, Bs, scheme, backend="local")  # the oracle, not counted
        if max_abs_err(local, _direct(As, Bs, Z32)):
            fail("pool: the local oracle != direct product")
        wcall = _worker_call(scheme, As, Bs)

        # 1. all live
        C, master, workers, wall = _pool_counted(
            "pool_all_live", pool, lambda: coded_matmul(As, Bs, scheme, backend=be),
            calls, wcall, expect)
        add(master, workers)
        if max_abs_err(C, local):
            fail("pool_all_live: output != local's")
        rows["pool_all_live"] = {"launches_master": master, "launches_workers": workers,
                                 "first_call_wall_ms": wall, "stats": vars(be.last_stats),
                                 **_pool_warm(pool, scheme, As, Bs, local)}
        # the same request with the shares streamed in chunks of the
        # PoolConfig default (1 MiB: ~49 contraction slices of a share, each
        # its own product in the worker), timed, outside the launch counts
        pool.master.stream_chunk_bytes = PoolConfig().stream_chunk_bytes
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            C, st = pool.master.execute(scheme, As, Bs)
            torch.cuda.synchronize()
            rows["pool_all_live"]["streamed_1MiB_wall_ms"] = 1e3 * (time.perf_counter() - t1)
            rows["pool_all_live"]["streamed_1MiB_time_to_R_ms"] = st.time_to_R_ms
        finally:
            pool.master.stream_chunk_bytes = 0
        if max_abs_err(C, local):
            fail("pool_all_live: the streamed request's output != local's")

        # 2. dist.smoke's flow: every worker parked, 2 SIGKILLed mid-request,
        # once every share is on the wire (its holder parked on it)
        request_bytes = be.last_stats.raw_bytes_out

        def killed_request():
            # blind round-robin (no health ranking from the warm requests):
            # one share a worker, so each killed worker holds one share
            pool.master.health.reset_scores()
            for wid in pool.master.live_workers():
                pool.master.task_delay_ms[wid] = POOL_PARK_MS
            sent0 = pool.master.stats()["pool_raw_bytes_out"]
            result = {}

            def request():
                try:
                    result["C"] = coded_matmul(As, Bs, scheme, backend=be)
                except Exception as e:  # failed below
                    result["err"] = e

            t = threading.Thread(target=request, daemon=True)
            t.start()
            deadline = time.perf_counter() + 60
            while pool.master.stats()["pool_raw_bytes_out"] - sent0 < request_bytes:
                if time.perf_counter() > deadline:
                    fail("pool_kill: the request's shares were not all sent in 60 s")
                time.sleep(0.002)
            result["killed"] = pool.kill(POOL_KILL)
            t.join(timeout=300)
            pool.master.task_delay_ms.clear()
            if t.is_alive() or "err" in result:
                fail(f"pool_kill: the request did not complete after the kill: {result.get('err')!r}")
            return result

        redispatched0 = pool.master.stats()["pool_redispatched"]
        res, master, workers, wall = _pool_counted("pool_kill", pool, killed_request, calls,
                                                   wcall, expect)
        add(master, workers)
        st = be.last_stats
        if len(res["killed"]) != POOL_KILL or len(pool.master.live_workers()) != POOL_WORKERS - POOL_KILL:
            fail(f"pool_kill: killed {res['killed']}, live {pool.master.live_workers()}")
        # a re-dispatched share waits in a parked survivor's socket, so its
        # send can end after the decode: count them once every worker has
        # answered the ping of _pool_counted.  At least one per killed
        # worker; more when a share first went to the other killed worker
        # before its death was seen (survivors still compute each share once)
        redispatched = pool.master.stats()["pool_redispatched"] - redispatched0
        if max_abs_err(res["C"], local) or redispatched < POOL_KILL:
            fail(f"pool_kill: output != local's, or {redispatched} shares re-dispatched, "
                 f"fewer than the {POOL_KILL} of the killed workers")
        rows["pool_kill"] = {"killed_pids": res["killed"], "redispatched": redispatched,
                             "launches_master": master,
                             "launches_workers_survivors": workers, "first_call_wall_ms": wall,
                             "stats": vars(st), **_pool_warm(pool, scheme, As, Bs, local)}
        del As, Bs, local, C, res
        torch.cuda.empty_cache()

        # 3. a secure scheme with a key, on the survivors
        spec = ProblemSpec(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, n=2, ring=Z32, N=8,
                           straggler_budget=2, privacy_t=1)
        sch = plan(spec, schemes=["ep_rmfe_secure"]).instantiate(device="cuda")
        A = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        B = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        local = coded_matmul(A, B, sch, backend="local", key=KEY)
        if max_abs_err(local, _direct(A, B, Z32)):
            fail("pool_secure: the local oracle != direct product")
        C, master, workers, wall = _pool_counted(
            "pool_secure", pool, lambda: coded_matmul(A, B, sch, backend=be, key=KEY),
            calls, _worker_call(sch, A, B, key=KEY), expect)
        add(master, workers)
        if sch.ring.degrees != (4,) or max_abs_err(C, local):
            fail(f"pool_secure over {sch.ring}: output != local's with the same key")
        rows["pool_secure"] = {"scheme": sch.name, "partition": list(sch.partition), "R": sch.R,
                               "launches_master": master, "launches_workers": workers,
                               "first_call_wall_ms": wall, "stats": vars(be.last_stats),
                               **_pool_warm(pool, sch, A, B, local, key=KEY)}
        del A, B, local, C
        report["pool_stats"] = dict(pool.stats())
    finally:
        pool.close()
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"pool path {name}: " + json.dumps({k: v for k, v in row.items() if k != "runs"},
                                                default=str))
    report["pool"] = rows
    return totals


def phase_serve(report: dict, calls: list) -> dict:
    """``SERVE_REQUESTS`` concurrent 1024^3 requests over Z_2^32 through a
    ``ServeScheduler`` over a ``LocalPool`` of 8 CUDA workers, coalesced by
    the amortized plan; ``/metrics`` scraped once while they run."""
    import urllib.request

    import numpy as np
    import torch

    from repro_torch.cdmm import ProblemSpec
    from repro_torch.core import make_ring
    from repro_torch.dist import LocalPool, PoolConfig
    from repro_torch.kernels import gr_matmul_ref
    from repro_torch.obs import http as obs_http
    from repro_torch.obs import parse_prometheus
    from repro_torch.serve import CoalescePolicy, ServeScheduler

    rng = np.random.default_rng(SEED + 5)
    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, n=1, ring=Z32, N=POOL_WORKERS,
                       straggler_budget=1)
    cfg = PoolConfig(workers=POOL_WORKERS, stream_chunk_bytes=0, transport="raw",
                     obs_http_port=0)
    pairs = [(Z32.random(rng, (SINGLE_SIZE, SINGLE_SIZE), device="cuda"),
              Z32.random(rng, (SINGLE_SIZE, SINGLE_SIZE), device="cuda"))
             for _ in range(SERVE_REQUESTS)]
    oracles = [gr_matmul_ref(A, B, Z32) for A, B in pairs]
    pool = LocalPool(config=cfg)
    try:
        url = obs_http.server().url
        with ServeScheduler(pool.master, CoalescePolicy(**SERVE_POLICY), max_queue=64,
                            seed=SEED) as sched:
            entry = sched.entry_for(spec)
            sch = entry.scheme
            if entry.cap < 2 or sch.name != "batch_ep_rmfe":
                fail(f"serve: the amortized plan does not coalesce: {sch.name} cap {entry.cap}")
            zA = torch.stack([pairs[0][0]] * sch.batch)
            wcall = _worker_call(sch, zA, zA)
            # one warm batch: the workers' first product of this ring
            warm = [sched.submit(A, B, spec=spec) for A, B in pairs[: entry.cap]]
            for fut in warm:
                fut.result(timeout=300)
            base = sched.stats.snapshot()
            latencies, families = [], {}

            def serve_round():
                t0 = time.perf_counter()
                futs = []
                for A, B in pairs:
                    fut = sched.submit(A, B, spec=spec)
                    fut.add_done_callback(
                        lambda f, t=time.perf_counter(): latencies.append(1e3 * (time.perf_counter() - t)))
                    futs.append(fut)
                # one scrape while the requests run
                with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
                    families.update(parse_prometheus(resp.read().decode()))
                outs = [f.result(timeout=600) for f in futs]
                return outs, time.perf_counter() - t0

            def expect(out):
                batches = sched.stats.snapshot()["serve_batches"] - base["serve_batches"]
                return ({k: v * batches for k, v in POOL_MASTER_LAUNCHES.items()},
                        {k: v * batches for k, v in POOL_WORKER_LAUNCHES.items()})

            (outs, seconds), master, workers, wall = _pool_counted(
                "serve", pool, serve_round, calls, wcall, expect)
            snap = sched.stats.snapshot()
        for i, (C, want) in enumerate(zip(outs, oracles)):
            if max_abs_err(C, want):
                fail(f"serve: request {i}'s slice != its direct product")
        fills = [b["fill"] for b in snap["serve_recent_batches"]][base["serve_batches"]:]
        mean_fill = sum(fills) / len(fills)
        if mean_fill <= 1:
            fail(f"serve: mean fill {mean_fill} of the counted round is not > 1")
        missing = [p for p in ("repro_serve_", "repro_pool_")
                   if not any(name.startswith(p) for name in families)]
        if missing:
            fail(f"serve: /metrics scraped mid-round has no {missing} series")
        lat = sorted(latencies)
        stages = {"phi": "skinny", "encode_at": "skinny", "workers": wcall[0],
                  "decode": "skinny", "psi": "skinny"}
        row = {"plan": {"scheme": sch.name, "partition": list(sch.partition), "ring": str(sch.ring),
                        "R": sch.R, "N": sch.N, "cap": entry.cap, "policy": SERVE_POLICY,
                        "routes": stages, "worker_shapes": [list(wcall[2]), list(wcall[3])]},
               "requests": SERVE_REQUESTS, "seconds": seconds,
               "requests_per_s": SERVE_REQUESTS / seconds, "batches": len(fills),
               "mean_fill": mean_fill, "latency_ms_p50": lat[len(lat) // 2],
               "latency_ms_max": lat[-1], "wait_ms_p50": snap["serve_wait_ms_p50"],
               "wait_ms_p99": snap["serve_wait_ms_p99"],
               "amortized_us_per_request": snap["serve_amortized_us_per_request"],
               "launches_master": master, "launches_workers": workers,
               "metrics_families": len(families), "wall_ms": wall}
        report["serve_pool_stats"] = dict(pool.stats())
    finally:
        obs_http.stop_server()
        pool.close()
    del pairs, oracles, outs
    torch.cuda.empty_cache()
    log(f"serve: {json.dumps(row)}")
    report["serve"] = row
    totals = dict.fromkeys(COUNTED, 0)
    for by_route in (master, workers):
        for k, v in by_route.items():
            totals[k] += v
    return totals


# ---------------------------------------------------------------------------
# phase 13: a hedged straggler on CUDA pool workers
# ---------------------------------------------------------------------------


def _zero_slack_scheme(Z32, workers: int, size: int):
    """The plan of R = N (no slack: every share is needed), as the
    reference's hedging tests build it (tests/test_metrics.py)."""
    from repro_torch.cdmm import ProblemSpec, plan

    spec = ProblemSpec(size, size, size, n=1, ring=Z32, N=workers, straggler_budget=0)
    p = plan(spec, objective="threshold", calibration=False)
    rank = max(range(len(p.candidates)), key=lambda i: p.candidates[i].costs.R)
    scheme = p.instantiate(rank, device="cuda")
    if scheme.R != scheme.N:
        fail(f"hedge: no zero-slack plan for N = {workers} (R = {scheme.R})")
    return scheme


def phase_hedge(report: dict, calls: list) -> dict:
    """``HEDGE_WORKERS`` CUDA worker processes, a zero-slack scheme at
    ``HEDGE_SIZE``^3: after warm requests seed the hedge window, every
    worker is parked ``HEDGE_PARK_MS`` and the master re-ships the overdue
    shares (``Master._maybe_hedge``); the decode must equal ``local``'s and
    the duplicates must be computed and discarded."""
    import numpy as np
    import torch

    from repro_torch.cdmm import coded_matmul
    from repro_torch.core import make_ring
    from repro_torch.dist import LocalPool, PoolConfig
    from repro_torch.kernels import counters

    rng = np.random.default_rng(SEED + 6)
    Z32 = make_ring(2, 32, ())
    scheme = _zero_slack_scheme(Z32, HEDGE_WORKERS, HEDGE_SIZE)
    A = Z32.random(rng, (HEDGE_SIZE, HEDGE_SIZE), device="cuda")
    B = Z32.random(rng, (HEDGE_SIZE, HEDGE_SIZE), device="cuda")
    oracle = coded_matmul(A, B, scheme, backend="local")
    if max_abs_err(oracle, _direct(A, B, Z32)):
        fail("hedge: the local oracle != direct product")
    wcall = _worker_call(scheme, A, B)
    cfg = PoolConfig(workers=HEDGE_WORKERS, stream_chunk_bytes=0, transport="raw")
    with LocalPool(config=cfg, device="cuda") as pool:
        master = pool.master

        def warm_and_seed():
            master.hedge_factor = 0.0
            for _ in range(3):
                master.execute(scheme, A, B)
            master.health.clear_window()
            for _ in range(2):
                master.execute(scheme, A, B)

        warm_and_seed()
        before = master.worker_launches()
        hedged0 = master.stats()["pool_hedged"]
        for wid in master.live_workers():
            master.task_delay_ms[wid] = HEDGE_PARK_MS
        master.hedge_factor = HEDGE_FACTOR
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            C, st = master.execute(scheme, A, B)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        finally:
            master.hedge_factor = 0.0
            master.task_delay_ms.clear()
        master_launches = dict(counters.launches_by_route)
        # the ping behind the parked tasks: the duplicates' products count
        workers = dict.fromkeys(COUNTED, 0)
        for wid, counts in master.worker_launches().items():
            for route, n in counts.items():
                workers[route] += n - before.get(wid, {}).get(route, 0)
        hedged = master.stats()["pool_hedged"] - hedged0
        if max_abs_err(C, oracle):
            fail("hedge: the hedged request's output != local's")
        if st.hedged < 1 or hedged < 1:
            fail(f"hedge: no share was hedged ({st.hedged}, counter {hedged})")
        want_tc = HEDGE_WORKERS + st.hedged
        if (workers[wcall[0]] != want_tc
                or workers["limbs"] != (2 * want_tc if wcall[0] == "tc" else 0)
                or master_launches["tc"] or master_launches["simt"] or not master_launches["skinny"]):
            fail(f"hedge: launches master {master_launches}, workers {workers}; the workers "
                 f"should compute {HEDGE_WORKERS} shares and {st.hedged} duplicates on {wcall[0]}")
        # a clean request after the race still decodes exactly, unhedged
        C2, st2 = master.execute(scheme, A, B)
        if max_abs_err(C2, oracle) or st2.hedged:
            fail("hedge: the request after the race is not clean")
        calls.extend([("hedge",) + wcall] * workers[wcall[0]])
        row = {"scheme": scheme.name, "partition": list(scheme.partition), "ring": str(scheme.ring),
               "N": scheme.N, "R": scheme.R, "size": HEDGE_SIZE, "park_ms": HEDGE_PARK_MS,
               "hedge_factor": HEDGE_FACTOR, "hedged": st.hedged, "wall_ms": wall,
               "time_to_R_ms": st.time_to_R_ms, "launches_master": master_launches,
               "launches_workers": workers, "pool_stats": {k: v for k, v in master.stats().items()
                                                           if "hedge" in k}}
    log(f"hedge: {json.dumps(row)}")
    report["hedge"] = row
    totals = dict.fromkeys(COUNTED, 0)
    for by_route in (master_launches, workers):
        for k, v in by_route.items():
            totals[k] += v
    return totals


# ---------------------------------------------------------------------------
# phase 12: the SPMD backend over ranks of one card
# ---------------------------------------------------------------------------


def _rank_rows(name: str, reports: list, N: int) -> dict:
    """Hold every rank's launches per route against ``SPMD_RANK_LAUNCHES``;
    returns the ranks' launches summed and their spans (ms) by stage."""
    if len(reports) != N:
        fail(f"{name}: {len(reports)} rank reports, expected {N}")
    summed = dict.fromkeys(COUNTED, 0)
    stages: dict = {}
    for rep in reports:
        if rep["launches"] != SPMD_RANK_LAUNCHES:
            fail(f"{name}: rank {rep['rank']} launched {rep['launches']}, "
                 f"expected {SPMD_RANK_LAUNCHES}")
        for k, v in rep["launches"].items():
            summed[k] += v
        for sp in rep.get("spans", []):
            stages.setdefault(sp["name"], []).append(1e3 * (sp["t1"] - sp["t0"]))
            if sp["name"] == "gather":
                stages.setdefault("gather_bytes_in", []).append(sp["tags"]["bytes_in"])
    return {"launches": summed, "stages": {
        k: {"mean": sum(v) / len(v), "max": max(v)} for k, v in stages.items()}}


def phase_spmd(report: dict, calls: list) -> dict:
    """``ShardMapBackend`` over N ranks on this card (this process rank 0,
    N - 1 spawned; a gloo group): ``batch_ep_rmfe`` 2048^3 with ranks 2, 5
    dead, worker encode and master encode; ``ep_rmfe_secure`` 1024^3 keyed;
    the sharded ``CodedQuantMatmul`` over 16 ranks, 12 dead."""
    import numpy as np
    import torch

    from repro_torch.cdmm import BatchRMFEAdapter, CodedQuantMatmul, ProblemSpec, coded_matmul, plan
    from repro_torch.cdmm.backends import ShardMapBackend
    from repro_torch.cdmm.quantized import quantize_int8
    from repro_torch.cdmm.runtime import DistributedBatchRMFE, RankPool, cdmm_shard_map
    from repro_torch.core import make_ring

    rng = np.random.default_rng(SEED + 7)
    Z32 = make_ring(2, 32, ())
    mask = torch.tensor(MASK, device="cuda")
    totals = dict.fromkeys(COUNTED, 0)
    rows = {}
    expect = lambda out: SPMD_RANK_LAUNCHES  # noqa: E731  (rank 0, this process)

    def add(by_route):
        for k, v in by_route.items():
            totals[k] += v

    def timed(fn, runs=3):
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        return walls

    As = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    Bs = Z32.random(rng, (2, MAIN_SIZE, MAIN_SIZE), device="cuda")
    scheme = BatchRMFEAdapter(Z32, n=2, N=SPMD_N, u=2, v=2, w=1, device="cuda")
    local = coded_matmul(As, Bs, scheme, backend="local", mask=mask)  # oracles, not counted
    if max_abs_err(local, _direct(As, Bs, Z32)):
        fail("spmd: the local oracle != direct product")
    t0 = time.perf_counter()
    be = ShardMapBackend(trace=True)
    try:
        pool = be.pool(SPMD_N, "cuda")
        report["spmd_ranks_up_s"] = time.perf_counter() - t0
        log(f"spmd: {SPMD_N} ranks up in {report['spmd_ranks_up_s']:.1f} s (gloo, one card)")
        # 1. worker encode (each rank encode_*_at its own point)
        C, by_route, wall = _counted("spmd_worker_encode", lambda: coded_matmul(
            As, Bs, scheme, backend=be, mask=mask), calls, expect=expect)
        if max_abs_err(C, local):
            fail("spmd_worker_encode: output != local's (and the direct product)")
        ranks = _rank_rows("spmd_worker_encode", be.last_reports, SPMD_N)
        add(ranks["launches"])
        walls = timed(lambda: coded_matmul(As, Bs, scheme, backend=be, mask=mask))
        rows["spmd_worker_encode"] = {"first_call_wall_ms": wall, "warm_wall_ms": walls,
                                      **ranks, "stages_warm": _rank_rows(
                                          "spmd_worker_encode", be.last_reports, SPMD_N)["stages"]}
        # 2. master encode: the Vandermonde encode of all N shares on every
        # rank, read at its row (DistributedBatchRMFE under cdmm_shard_map)
        f = cdmm_shard_map(DistributedBatchRMFE(scheme.inner, "workers", master_encode=True),
                           pool, "workers")
        C, by_route, wall = _counted("spmd_master_encode", lambda: f(As, Bs, mask.cpu()),
                                     calls, expect=expect)
        if max_abs_err(C, local):
            fail("spmd_master_encode: output != local's (and the direct product)")
        ranks = _rank_rows("spmd_master_encode", pool.last_reports, SPMD_N)
        add(ranks["launches"])
        rows["spmd_master_encode"] = {"first_call_wall_ms": wall, **ranks,
                                      "warm_wall_ms": timed(lambda: f(As, Bs, mask.cpu()))}
        del As, Bs, local, C
        torch.cuda.empty_cache()
        # 3. a secure scheme, keyed: every rank draws the same masks
        spec = ProblemSpec(SINGLE_SIZE, SINGLE_SIZE, SINGLE_SIZE, n=2, ring=Z32, N=SPMD_N,
                           straggler_budget=2, privacy_t=1)
        sch = plan(spec, schemes=["ep_rmfe_secure"], calibration=False).instantiate(device="cuda")
        A = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        B = Z32.random(rng, (2, SINGLE_SIZE, SINGLE_SIZE), device="cuda")
        local = coded_matmul(A, B, sch, backend="local", mask=mask, key=KEY)
        if max_abs_err(local, _direct(A, B, Z32)):
            fail("spmd_secure: the local oracle != direct product")
        C, by_route, wall = _counted("spmd_secure", lambda: coded_matmul(
            A, B, sch, backend=be, mask=mask, key=KEY), calls, expect=expect)
        if max_abs_err(C, local):
            fail("spmd_secure: output != local's with the same key")
        ranks = _rank_rows("spmd_secure", be.last_reports, SPMD_N)
        add(ranks["launches"])
        rows["spmd_secure"] = {"scheme": sch.name, "ring": str(sch.ring), "R": sch.R,
                               "first_call_wall_ms": wall, **ranks}
        del A, B, local, C
    finally:
        be.close()
    torch.cuda.empty_cache()
    # 4. the sharded CodedQuantMatmul: 16 ranks, 12 dead
    tokens, d_model, d_ff = QUANT_SPMD_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    x = torch.randn((tokens, d_model), generator=gen, device="cuda")
    w = torch.randn((d_model, d_ff), generator=gen, device="cuda")
    qx, _ = quantize_int8(x, axis=-1)
    qw, _ = quantize_int8(w, axis=0)
    qmask = torch.zeros(QUANT_N, dtype=torch.bool)
    qmask[list(QUANT_LIVE)] = True
    cq = CodedQuantMatmul(QUANT_N, "workers", device="cuda")
    oracle = torch._int_mm(qx, qw.t().contiguous().t())  # an oracle only
    t0 = time.perf_counter()
    with RankPool(QUANT_N, device="cuda", trace=True) as pool16:
        up = time.perf_counter() - t0
        f = cdmm_shard_map(cq.exact_int_matmul, pool16, "workers")
        acc, by_route, wall = _counted("spmd_quantized", lambda: f(qx, qw, qmask), calls,
                                       expect=expect)
        if not torch.equal(acc, oracle):
            fail("spmd_quantized: exact_int_matmul over 16 ranks != torch._int_mm")
        ranks = _rank_rows("spmd_quantized", pool16.last_reports, QUANT_N)
        add(ranks["launches"])
        rows["spmd_quantized"] = {"shape": list(QUANT_SPMD_SHAPE), "N": QUANT_N, "R": cq.R,
                                  "live": list(QUANT_LIVE), "ranks_up_s": up,
                                  "first_call_wall_ms": wall, **ranks,
                                  "warm_wall_ms": timed(lambda: f(qx, qw, qmask), runs=2)}
    del x, w, qx, qw, acc, oracle
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"spmd path {name}: {json.dumps(row)}")
    report["spmd"] = rows
    return totals


# ---------------------------------------------------------------------------
# phase 10: the autotuner; phase 11: planner calibration
# ---------------------------------------------------------------------------


def phase_autotune(report: dict) -> None:
    """Tune every point of ``autotune.DEFAULT_POINTS`` (all candidates; each
    held against the plain version inside ``autotune``), write the cache to
    ``build/autotune_cache.json``, and check the committed cache with the
    module's ``--check``.  The in-process view is dropped afterwards, so
    later phases launch with the committed entries."""
    import os

    from repro_torch.core import make_ring
    from repro_torch.kernels import autotune as at

    out = ROOT / "build" / "autotune_cache.json"
    rows = []
    t0 = time.perf_counter()
    try:
        for route, (p, e, deg), batch, (t, r, s) in at.DEFAULT_POINTS:
            ring = make_ring(p, e, tuple(deg))
            res = at.autotune(ring, t, r, s, batch=batch, route=route)
            bytes_ms, int8_ms, _ = _bounds(ring, batch, t, r, s)
            row = {"key": res.key, "batch": batch, "static": res.entry["default"],
                   "static_ms": res.default_ms, "tuned": res.entry["name"], "tuned_ms": res.ms,
                   "bound_ms": max(bytes_ms, int8_ms),
                   "bound_by": "operations" if int8_ms >= bytes_ms else "bytes",
                   "candidates_ms": res.entry["candidates"], "usage": res.entry["usage"]}
            if route == "tc":
                row["int8_yardstick_ms"] = _int8_yardstick_ms(ring, batch, t, r, s)[0]
            rows.append(row)
            log(f"autotune {json.dumps(row)}")
        at.save_cache(at._disk_cache(), out, meta=at._card_meta("cuda"))
    finally:
        at.invalidate_memory_cache()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    checks = {}
    for label, extra in (("committed", []), ("this run", ["--out", str(out)])):
        res = subprocess.run([sys.executable, "-m", "repro_torch.kernels.autotune", "--check",
                              *extra], capture_output=True, text=True, env=env, cwd=ROOT)
        checks[label] = res.stdout.strip().splitlines()
        if res.returncode != 0:
            fail(f"autotune --check on the {label} cache: rc {res.returncode}\n"
                 f"{res.stdout}{res.stderr[-2000:]}")
    log(f"autotune --check: {json.dumps(checks)}")
    report["autotune"] = {"points": rows, "seconds": time.perf_counter() - t0, "check": checks,
                          "cache": str(out)}


def phase_calibrate(report: dict) -> None:
    """Fit a ``CalibrationSet`` for ``local`` and ``elastic`` from the spans
    of traced requests (three families at three sizes), print the
    coefficients and the predicted against the measured time of the rows,
    and rank the main-path spec with the calibration and without."""
    from collections import defaultdict

    from repro_torch.cdmm import ProblemSpec, plan
    from repro_torch.cdmm.calibrate import (
        STAGE_FEATURES,
        CalibrationSet,
        fit_rows,
        measure_rows,
        save_calibration,
    )
    from repro_torch.core import make_ring

    t0 = time.perf_counter()
    rows = measure_rows(device="cuda", runs=2, seed=SEED + 8)
    cal = fit_rows(rows, device="cuda")
    path = save_calibration(cal, ROOT / "build" / "calibration.json")
    for backend in ("local", "elastic"):
        c = cal.backends.get(backend)
        if c is None or not all(c.coef.get(k, 0) > 0 for k in ("encode", "compute", "decode")):
            fail(f"calibrate: no positive encode/compute/decode fit for {backend}: {c}")
    if not cal.matches_device("cuda"):
        fail(f"calibrate: the fit's device {cal.device} does not match this card")
    ref_payload = json.loads((ROOT / "benchmarks" / "calibration.json").read_text())
    if CalibrationSet.from_payload(ref_payload).matches_device("cuda"):
        fail("calibrate: the reference's JAX/CPU calibration passes as this card's")
    # predicted against measured, per (backend, stage, feature value)
    groups = defaultdict(list)
    coef_of = {stage: name for stage, (_, name) in STAGE_FEATURES.items()}
    for row in rows:
        stage = row["name"].rsplit("_", 1)[-1]
        feat = row["derived"][STAGE_FEATURES[stage][0]]
        groups[(row["derived"]["backend"], stage, feat)].append(row["us"])
    table = []
    for (backend, stage, feat), us in sorted(groups.items()):
        pred = cal.backends[backend].coef.get(coef_of[stage], 0.0) * feat
        table.append({"backend": backend, "stage": stage, "feature": feat, "rows": len(us),
                      "measured_us": sum(us) / len(us), "predicted_us": pred})
    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(MAIN_SIZE, MAIN_SIZE, MAIN_SIZE, n=2, ring=Z32, N=8, straggler_budget=2)
    rank = lambda p: [(c.scheme, c.u, c.v, c.w, c.n, c.costs.R, c.score)  # noqa: E731
                      for c in p.candidates[:5]]
    rankings = {"calibrated_local": rank(plan(spec, calibration=cal, backend="local")),
                "calibrated_elastic": rank(plan(spec, calibration=cal, backend="elastic")),
                "analytic": rank(plan(spec, calibration=False))}
    for name, c in sorted(cal.backends.items()):
        log(f"calibrate {name}: coef {json.dumps(c.coef)} r2 {json.dumps(c.r2)} rows {c.nrows}")
    for row in table:
        log(f"calibrate row {json.dumps(row)}")
    for name, r in rankings.items():
        log(f"calibrate plan ({name}): {json.dumps(r)}")
    report["calibration"] = {"payload": cal.to_payload(), "path": str(path), "rows": rows,
                             "table": table, "rankings": rankings,
                             "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 14: the LM substrate's serving path (plain PyTorch ops, no ring kernel)
# ---------------------------------------------------------------------------

LM_ARCH = "gemma2-2b"
# (batch, prompt, generated): the reference's defaults, then the timed run
LM_RUNS = [(2, 8, 8), (8, 64, 32)]
# phases 16 and 18: the same batches with fewer steps at batch 8 (the
# smoke run's 1200 s), every step's time still read from CUDA events
SHORT_RUNS = [(2, 8, 8), (8, 16, 16)]
# (c): sequence beyond the local window of 4096, depth and vocab cut so the
# CPU can run the same float32 prefill; TF32 off on the card
LM_SEQ = 4160
LM_CUT = {"num_layers": 2, "vocab_size": 32768}
# relative L2 tolerances.  bf16: two bf16 computations of the same logits
# (the cached decode, M = batch GEMMs and the direct attention; the prefill,
# M = batch x seq GEMMs and the chunked attention) through 26 layers whose
# stacked weights have std 1/sqrt(13) (the reference's std rule): each
# rounding difference grows ~10x a matmul.  The CPU tests hold the port to
# 5e-2 against the reference through 2-6 such layers; at 26 they differ by
# 4.3e-2 (NVIDIA H100 80GB HBM3, 700 W).  float32 (TF32 off): summation
# order only, for (b)'s float32 twin and (c)'s card against CPU
LM_BF16_TOL = 1e-1
LM_F32_TOL = 1e-3


def _lm_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def _device_profile(step, steps: int, what: str, **row) -> dict:
    """Kernels and device-busy time of ``steps`` calls of ``step()`` from
    ``torch.profiler``, beside the host wall of the same calls: the
    device's idle share.  ``row`` names the run.  Only the device's
    activity is traced: the host's ops would add an event each for the
    profiler to process, and nothing here reads them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_call = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {**row, "wall_ms_per_step": wall_ms, "device": "not measured"}
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {**row, "kernels_per_step": len(kernels) / steps,
           "device_busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
           "idle_share": 1 - busy_ms / wall_ms, "top_kernels_ms": dict(top),
           "seconds": time.perf_counter() - t_call}
    log(f"{what}: {row['kernels_per_step']:.0f} kernels a step, device busy "
        f"{busy_ms:.3f} of {wall_ms:.3f} ms (idle {100 * row['idle_share']:.1f}%); top "
        + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
    return row


def _lm_generate(what: str, arch: str, cfg, params, batch: int, prompt_len: int,
                 gen_len: int, nbytes: int, cache_bytes=None):
    """``greedy_generate(smoke=False)`` of ``arch`` on the card with
    ``params``, checked (every token in range, the last logits finite);
    returns its output and a timing row: per-step time from CUDA events
    after the first step, tokens/s, and the least a step can take with
    every weight (``nbytes``) and the whole cache read once from HBM (a
    decoder's KV cache, unless ``cache_bytes`` gives a step's cache
    traffic)."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import greedy_generate

    t0 = time.perf_counter()
    gen = greedy_generate(arch, smoke=False, batch=batch, prompt_len=prompt_len,
                          gen_len=gen_len, seed=SEED, device="cuda", params=params)
    wall = time.perf_counter() - t0
    toks, logits = gen["generated"], gen["logits"]
    if toks.shape != (batch, gen_len) or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{what} generation ({batch}, {prompt_len}, {gen_len}): tokens out of range")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{what} generation ({batch}, {prompt_len}, {gen_len}): non-finite logits")
    steps = np.asarray(gen["step_ms"][1:])  # the first step pays the first calls
    if cache_bytes is None:
        cache_bytes = (2 * cfg.num_layers * batch * (prompt_len + gen_len + 8)
                       * cfg.num_kv_heads * cfg.hd * 2)
    row = {"batch": batch, "prompt": prompt_len, "generated": gen_len, "wall_s": wall,
           "first_step_ms": gen["step_ms"][0],
           "step_ms_median": float(np.median(steps)),
           "step_ms_p90": float(np.percentile(steps, 90)),
           "tokens_per_s": batch * 1e3 / float(np.median(steps)),
           "bound_ms": 1e3 * (nbytes + cache_bytes) / HBM_BYTES_PER_S,
           "cache_bytes": cache_bytes,
           "tokens_head": toks[0, :8].tolist()}
    return gen, row


def _lm_profile(api, params, batch: int, steps: int = 3, what: str = "lm") -> dict:
    """Kernels and device-busy time of ``steps`` decode steps at ``batch``
    (a fresh cache, after two warm steps) from ``torch.profiler``, beside
    the host wall of the same steps: the device's idle share."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime.sharding import _map_leaves

    decl = api.cache_decl(ShapeConfig("profile", steps + 10, batch, "decode"))
    cache = _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype, device="cuda"), decl)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    state = {"cache": cache}

    def step():
        _, state["cache"] = api.decode_fn(params, state["cache"], {"tokens": tok})

    with torch.inference_mode():
        for _ in range(2):
            step()
        return _device_profile(step, steps, f"{what} profile, batch {batch}", batch=batch)


def phase_lm(report: dict) -> None:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_bytes, param_count

    t_phase = time.perf_counter()
    counters.reset()
    out: dict = {"arch": LM_ARCH}
    cfg = ARCHS[LM_ARCH]
    api = build_model(cfg)
    nbytes, nparams = param_bytes(api.param_specs), param_count(api.param_specs)
    out.update(params=nparams, param_bytes=nbytes, layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, dtype=cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(api.param_specs, SEED, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    log(f"lm {LM_ARCH}: {nparams} parameters, {nbytes} bytes (bf16) on the card in "
        f"{out['init_s']:.2f} s")

    # (a) greedy generation at full width and depth
    runs = []
    for batch, prompt_len, gen_len in LM_RUNS:
        gen, row = _lm_generate("lm", LM_ARCH, cfg, params, batch, prompt_len, gen_len, nbytes)
        toks, logits = gen["generated"], gen["logits"]
        row["weight_bound_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
        runs.append(row)
        log(f"lm generate batch {batch} prompt {prompt_len} gen {gen_len}: step median "
            f"{row['step_ms_median']:.3f} ms p90 {row['step_ms_p90']:.3f} ms (first "
            f"{row['first_step_ms']:.1f}), {row['tokens_per_s']:.1f} tokens/s, bound "
            f"{row['bound_ms']:.3f} ms; wall {row['wall_s']:.2f} s")
    out["generate"] = runs
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["profile"] = _lm_profile(api, params, LM_RUNS[-1][0])

    # (b) the last cached step against prefill_fn over the same tokens: in
    # bf16 as generated, then in float32 with a float32 cache (TF32 off),
    # where only the summation order differs
    seq = np.concatenate([gen["prompt"], toks], axis=1).astype(np.int32)
    tseq = torch.from_numpy(seq).cuda()
    with torch.inference_mode():
        pre = api.prefill_fn(params, {"tokens": tseq})
    err = _lm_rel(logits, pre)
    ref = pre[:, -1].float().cpu().numpy()
    got = logits[:, -1].float().cpu().numpy()
    checked = agree = 0
    for b in range(ref.shape[0]):
        top2 = np.sort(ref[b])[-2:]
        if top2[1] - top2[0] > 2 * LM_BF16_TOL * np.abs(ref[b]).max():
            checked += 1
            agree += int(got[b].argmax() == ref[b].argmax())
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    api32 = build_model(cfg32)
    decl = api32.cache_decl(ShapeConfig("check", seq.shape[1] + 8, seq.shape[0], "decode"))
    cache = _map_leaves(lambda _, ps: torch.zeros(ps.shape, device="cuda", dtype=torch.float32
                                                  if ps.shape else ps.dtype), decl)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for t in range(seq.shape[1]):
                lg32, cache = api32.decode_fn(params, cache, {"tokens": tseq[:, t:t + 1]})
            pre32 = api32.prefill_fn(params, {"tokens": tseq})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    err32 = _lm_rel(lg32, pre32)
    r32, g32 = pre32[:, -1].cpu().numpy(), lg32[:, -1].cpu().numpy()
    checked32 = agree32 = 0
    for b in range(r32.shape[0]):
        top2 = np.sort(r32[b])[-2:]
        if top2[1] - top2[0] > 2 * LM_F32_TOL * np.abs(r32[b]).max():
            checked32 += 1
            agree32 += int(g32[b].argmax() == r32[b].argmax())
    out["cache_vs_prefill"] = {
        "seq": list(seq.shape), "rel_l2": err, "tol": LM_BF16_TOL, "rows_checked": checked,
        "argmax_agree": agree, "argmax_agree_all_rows": int((got.argmax(-1) == ref.argmax(-1)).sum()),
        "float32_rel_l2": err32, "float32_tol": LM_F32_TOL, "float32_rows_checked": checked32,
        "float32_argmax_agree": agree32,
        # how far each bf16 computation is from the float32 prefill
        "bf16_prefill_vs_float32": _lm_rel(pre, pre32),
        "bf16_cached_vs_float32": _lm_rel(logits, pre32)}
    log(f"lm cache vs prefill over {seq.shape}: bf16 rel L2 {err:.3e} (tol {LM_BF16_TOL}); "
        f"argmax agrees in {agree} of {checked} rows with a clear top-2 gap "
        f"({out['cache_vs_prefill']['argmax_agree_all_rows']} of {ref.shape[0]} in all); "
        f"float32 (float32 cache) rel L2 {err32:.3e} (tol {LM_F32_TOL}), argmax agrees in "
        f"{agree32} of {checked32} rows; bf16 prefill / cached "
        f"vs float32 prefill {out['cache_vs_prefill']['bf16_prefill_vs_float32']:.3e} / "
        f"{out['cache_vs_prefill']['bf16_cached_vs_float32']:.3e}")
    if err > LM_BF16_TOL or agree != checked or err32 > LM_F32_TOL or agree32 != checked32:
        fail(f"lm cache vs prefill: bf16 rel L2 {err:.3e}, argmax {agree}/{checked}, "
             f"float32 rel L2 {err32:.3e}, argmax {agree32}/{checked32}")
    del params, pre, pre32, logits, lg32, cache, gen
    torch.cuda.empty_cache()

    # (c) the card against the host CPU, float32, at a sequence beyond the window
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cut = dataclasses.replace(cfg, dtype="float32", **LM_CUT)
        capi = build_model(cut)
        host = materialize(capi.param_specs, SEED, device="cpu")
        card = _map_leaves(lambda _, t: t.cuda(), host)
        toks = np.random.default_rng(SEED).integers(0, cut.vocab_size, (1, LM_SEQ)).astype(np.int32)
        with torch.inference_mode():
            t0 = time.perf_counter()
            lg = capi.prefill_fn(card, {"tokens": torch.from_numpy(toks).cuda()})
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lc = capi.prefill_fn(host, {"tokens": torch.from_numpy(toks)})
            cpu_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    err = _lm_rel(lg, lc)
    maxrel = float((lg.double().cpu() - lc.double()).abs().max() / lc.double().abs().max())
    out["card_vs_cpu"] = {
        "seq": LM_SEQ, "dtype": "float32", "tf32": False, "rel_l2": err, "max_rel": maxrel,
        "tol": LM_F32_TOL, "card_s": card_s, "cpu_s": cpu_s,
        "reduced": {k: f"{getattr(cfg, k)} -> {v}" for k, v in LM_CUT.items()},
        "finite": bool(torch.isfinite(lg).all())}
    log(f"lm card vs cpu, float32 prefill at {LM_SEQ} (reduced: "
        f"{out['card_vs_cpu']['reduced']}): rel L2 {err:.3e}, max rel {maxrel:.3e} "
        f"(tol {LM_F32_TOL}); card {card_s:.2f} s, cpu {cpu_s:.2f} s")
    if not out["card_vs_cpu"]["finite"] or err > LM_F32_TOL or maxrel > LM_F32_TOL:
        fail(f"lm card vs cpu: rel L2 {err:.3e}, max rel {maxrel:.3e}")
    del host, card, lg, lc
    torch.cuda.empty_cache()

    # (d) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"lm path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"lm phase: peak {out['peak_bytes']} bytes allocated, ring launches "
        f"{out['launches']}, {out['seconds']:.1f} s")
    report["lm"] = out


# ---------------------------------------------------------------------------
# phase 15: the LM substrate's training path (plain PyTorch ops, no ring kernel)
# ---------------------------------------------------------------------------

# (a): train_4k's sequence at full width and depth; the global batch of 256
# cut to the largest that fits on one card beside the AdamW state (31.4 GB
# with the gradients): at batch 2 the step peaks at 77.2 GB (the logits'
# float32 copies, 2 x 4096 x 256000, and the recomputed attention), batch 3
# would add ~25 GB (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_STEPS = 6
# (b), (c): LM_CUT's 2-layer gemma2-2b at published widths, its tokens a
# batch of 2 x 1024 (the CPU runs (b)'s forward and backward too)
TRAIN_CUT_SHAPE = (1024, 2)
# (b): relative L2 of the card's float32 gradients and first moments
# against the CPU's (the loss and the parameters after the step are held to
# LM_F32_TOL).  At the cut the stacked weights have std 1 (the reference's
# std rule at U = 1): the global layer's attention saturates and its wq and
# wk gradients are ill-conditioned, so summation order alone moves them by
# 5.5e-4 between two CPU thread counts (2 x 256 tokens); the card's GEMMs
# sum in another order again.  Second moments are squared gradients: twice
# the tolerance
TRAIN_GRAD_TOL = 1e-2
# (c): the reference's own tolerance for a resumed run's losses
# (tests/test_train_loop.py): the embedding's backward accumulates through
# atomics, so runs on the card are not bit-reproducible
RESUME_RTOL = 2e-2


def _train_flops(cfg, nparams: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, without the recompute: 6 N a token for
    the matmuls (the tied head included) plus the attention's 12 L H hd S a
    token (QK^T and PV over every key, forward and backward)."""
    tokens = batch * seq
    return 6.0 * nparams * tokens + 12.0 * cfg.num_layers * cfg.num_heads * cfg.hd * seq * tokens


def _same_bits(a, b) -> bool:
    """Two trees of tensors hold the same keys, dtypes, shapes and bits."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            _same_bits(a[k], b[k]) for k in a)
    if not (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape):
        return False
    view = (lambda t: t.view(torch.int16)) if a.dtype == torch.bfloat16 else (lambda t: t)
    return bool(torch.equal(view(a.detach()), view(b.detach())))


def _leaf_errs(card: dict, host: dict, prefix: str = "") -> dict:
    """Relative L2 error of every leaf of ``card`` against ``host``."""
    if isinstance(card, dict):
        out: dict = {}
        for k in sorted(card):
            out.update(_leaf_errs(card[k], host[k], f"{prefix}/{k}"))
        return out
    return {prefix: _lm_rel(card.float(), host.float())}


def _train_rows(what: str, cfg, api, run: dict, shape, flops: float, steps: int) -> dict:
    """The training rows of a ``launch.train.train`` run on the card (its
    return value ``run``, the config ``cfg`` it trained and ``api`` its
    model): every loss, lr and gradient norm finite; step time (median and
    p90 after the first), tokens/s, the model FLOPs ``flops`` a step and
    their share of the dense bf16 peak, the peak memory; the optimizer's
    update alone (CUDA events) on the trained state with one batch's
    gradients, against its byte bound; one profiled step (``build_cell``'s
    train step: kernels, device-busy time, idle share, top kernels)."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import build_cell, opt_config_for, value_and_grad
    from repro_torch.optim import opt_update
    from repro_torch.optim.optimizers import _leaves

    peak = torch.cuda.max_memory_allocated()
    hist = run["history"]
    for h in hist:
        if not all(np.isfinite([h["loss"], h["lr"], h["gnorm"]])):
            fail(f"{what} step: non-finite loss, lr or gnorm {h}")
    ms = np.asarray([h["ms"] for h in hist[1:]])
    batch_n, seq = shape.global_batch, shape.seq_len
    step_s = float(np.median(ms)) / 1e3
    out = dict(history=hist, first_step_ms=hist[0]["ms"],
               step_ms_median=float(np.median(ms)), step_ms_p90=float(np.percentile(ms, 90)),
               tokens_per_s=batch_n * seq / step_s, model_flops_per_step=flops,
               flops_share_of_bf16_peak=flops / step_s / BF16_FLOPS_PER_S,
               bound_ms=1e3 * flops / BF16_FLOPS_PER_S, peak_bytes=peak)
    lrs = [f"{h['lr']:.3e}" for h in hist]
    log(f"{what} {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}, remat {cfg.remat}) at "
        f"{batch_n} x {seq}: losses {[round(h['loss'], 4) for h in hist]}, lr {lrs}, "
        f"gnorm {[round(h['gnorm'], 3) for h in hist]}")
    log(f"{what} step median {out['step_ms_median']:.1f} ms p90 {out['step_ms_p90']:.1f} ms "
        f"(first {out['first_step_ms']:.0f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"{flops / 1e12:.2f} TFLOP a step = {100 * out['flops_share_of_bf16_peak']:.1f}% of the "
        f"bf16 peak (bound {out['bound_ms']:.1f} ms); peak {peak} bytes")

    # the optimizer's update alone, on the trained state, with one batch's gradients
    state = run["state"]
    pipe = TokenPipeline(DataConfig(seed=SEED + 1, source="markov"), cfg, shape)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in pipe.with_frontend(pipe.batch_at(0), 0).items()}
    _, grads = value_and_grad(api.loss_fn, state["params"], batch)
    ocfg = opt_config_for(cfg, total_steps=max(steps, 10))
    times = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        opt_update(ocfg, grads, state["opt"], state["params"])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    # every parameter and AdamW moment read once and written once, the
    # gradients (the parameters' dtype) read once: the update's byte bound
    opt_bytes = (3 * sum(t.numel() * t.element_size() for t in _leaves(state["params"]))
                 + 2 * sum(t.numel() * t.element_size() for t in _leaves(state["opt"]["mu"])))
    out["optimizer"] = {"ms": times, "ms_median": float(np.median(times)),
                        "bytes": opt_bytes, "bound_ms": 1e3 * opt_bytes / HBM_BYTES_PER_S,
                        "share_of_step": float(np.median(times)) / out["step_ms_median"]}
    log(f"{what} optimizer update alone: {[round(t, 2) for t in times]} ms (bound "
        f"{out['optimizer']['bound_ms']:.2f} ms by bytes), "
        f"{100 * out['optimizer']['share_of_step']:.1f}% of the step")
    del grads

    # one profiled step: build_cell's train step on the same state
    cell = build_cell(cfg, shape)
    out["profile"] = _device_profile(
        lambda: cell.step_fn(state["params"], state["opt"], batch), 1,
        f"{what} profile, {batch_n} x {seq}", batch=batch_n, seq=seq)
    out["peak_bytes_with_profile"] = torch.cuda.max_memory_allocated()
    return out


def phase_train(report: dict) -> None:
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import counters
    from repro_torch.launch.steps import opt_config_for, value_and_grad
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.optim import opt_init, opt_update
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_count

    t_phase = time.perf_counter()
    counters.reset()
    cfg = ARCHS[LM_ARCH]
    out: dict = {"arch": LM_ARCH, "dtype": cfg.dtype, "remat": cfg.remat,
                 "optimizer_config": f"{cfg.optimizer} ({cfg.opt_state_dtype} state)",
                 "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
                 "reduced": {"global_batch": f"256 -> {TRAIN_BATCH}"}}

    # (a) full width and depth, through the user's entry point
    shape = ShapeConfig("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
    api = build_model(cfg)
    nparams = param_count(api.param_specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train(LM_ARCH, smoke=False, steps=TRAIN_STEPS, shape=shape, seed=SEED,
                data_source="markov", log_every=1, device="cuda")
    wall = time.perf_counter() - t0
    flops = _train_flops(cfg, nparams, TRAIN_BATCH, TRAIN_SEQ)
    out.update(params=nparams, wall_s=wall,
               **_train_rows("train", cfg, api, run, shape, flops, TRAIN_STEPS))
    del run
    torch.cuda.empty_cache()

    # (b) the card against the host CPU, float32, TF32 off
    seq, b = TRAIN_CUT_SHAPE
    cut = dataclasses.replace(cfg, dtype="float32", **LM_CUT)
    capi = build_model(cut)
    cpipe = TokenPipeline(DataConfig(seed=SEED + 1, source="markov"), cut,
                          ShapeConfig("cut", seq, b, "train"))
    hbatch = {k: torch.from_numpy(v) for k, v in cpipe.batch_at(0).items()}
    cbatch = {k: v.cuda() for k, v in hbatch.items()}
    host = materialize(capi.param_specs, SEED, device="cpu")
    card = _map_leaves(lambda _, t: t.cuda(), host)
    ocut = opt_config_for(cut)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        (lc, _), gc = value_and_grad(capi.loss_fn, card, cbatch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (lh, _), gh = value_and_grad(capi.loss_fn, host, hbatch)
        cpu_s = time.perf_counter() - t0
        sc, sh = opt_init(ocut, card), opt_init(ocut, host)
        opt_update(ocut, gc, sc, card)
        opt_update(ocut, gh, sh, host)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    grad_errs, param_errs = _leaf_errs(gc, gh), _leaf_errs(card, host)
    state_errs = _leaf_errs(sc["mu"], sh["mu"])
    loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
    # each error over its tolerance: the check fails above 1
    ratios = ([loss_err / LM_F32_TOL] + [e / LM_F32_TOL for e in param_errs.values()]
              + [e / TRAIN_GRAD_TOL for e in grad_errs.values()]
              + [e / (TRAIN_GRAD_TOL if k.endswith("/m") else 2 * TRAIN_GRAD_TOL)
                 for k, e in state_errs.items()])
    out["card_vs_cpu"] = {
        "shape": [b, seq], "dtype": "float32", "tf32": False, "tol": LM_F32_TOL,
        "grad_tol": TRAIN_GRAD_TOL, "loss_card": float(lc), "loss_cpu": float(lh),
        "loss_rel": loss_err, "grad_rel_l2": grad_errs, "param_rel_l2_after_step": param_errs,
        "moment_rel_l2_after_step": state_errs, "worst_over_tol": max(ratios),
        "card_s": card_s, "cpu_s": cpu_s,
        "reduced": {k: f"{getattr(cfg, k)} -> {v}" for k, v in LM_CUT.items()}}
    log(f"train card vs cpu, float32 at {b} x {seq} (reduced: "
        f"{out['card_vs_cpu']['reduced']}): loss {float(lc):.6f} / {float(lh):.6f} (rel "
        f"{loss_err:.2e}), parameters after AdamW {max(param_errs.values()):.2e} (tol "
        f"{LM_F32_TOL}); worst gradient leaf {max(grad_errs.values()):.2e} "
        f"({max(grad_errs, key=grad_errs.get)}), moment {max(state_errs.values()):.2e} "
        f"({max(state_errs, key=state_errs.get)}) (tol {TRAIN_GRAD_TOL}, second moments "
        f"{2 * TRAIN_GRAD_TOL}); card {card_s:.2f} s, cpu {cpu_s:.2f} s")
    if not np.isfinite(ratios).all() or max(ratios) > 1:
        fail(f"train card vs cpu: an error {max(ratios):.2f} times its tolerance")
    del host, card, gc, gh, sc, sh, hbatch, cbatch
    torch.cuda.empty_cache()

    # (c) checkpoint and resume on the card, the same cut in bf16
    name = f"{LM_ARCH}-cut"
    ARCHS[name] = dataclasses.replace(cfg, name=name, **LM_CUT)
    cshape = ShapeConfig("cut", seq, b, "train")
    kw = dict(smoke=False, shape=cshape, seed=SEED, data_source="markov", log_every=0,
              device="cuda")
    (ROOT / "build").mkdir(exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            t0 = time.perf_counter()
            first = train(name, steps=8, ckpt_dir=d, ckpt_every=4, **kw)
            restored = Checkpointer(d).restore(8, device="cuda")
            same = (_same_bits(restored["params"], first["state"]["params"])
                    and _same_bits(restored["opt"], first["state"]["opt"])
                    and int(restored["meta"]["step"]) == 8)
            del restored, first
            resumed = train(name, steps=12, ckpt_dir=d, ckpt_every=4, resume=True, **kw)
            straight = train(name, steps=12, **kw)
            compressed = train(name, steps=4, compress_grads=True, **kw)
            resume_s = time.perf_counter() - t0
    finally:
        del ARCHS[name]
    got, want = np.asarray(resumed["losses"]), np.asarray(straight["losses"][8:])
    worst_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    out["resume"] = {"shape": [b, seq], "dtype": cfg.dtype, "restored_bits_equal": same,
                     "resumed_losses": got.tolist(), "straight_losses": want.tolist(),
                     "max_rel_diff": worst_rel, "rtol": RESUME_RTOL,
                     "compressed_losses": compressed["losses"], "seconds": resume_s}
    log(f"train resume ({b} x {seq}, bf16): restored step 8 equals the saved bits: {same}; "
        f"steps 9-12 resumed {got.round(4).tolist()} vs straight "
        f"{want.round(4).tolist()}, largest relative difference {worst_rel:.2e} (rtol "
        f"{RESUME_RTOL}); compressed-gradient losses "
        f"{[round(x, 4) for x in compressed['losses']]}; {resume_s:.1f} s")
    if not same or len(got) != 4 or worst_rel > RESUME_RTOL \
            or not np.isfinite(compressed["losses"]).all():
        fail(f"train resume: bits equal {same}, resumed {got}, straight {want}, compressed "
             f"{compressed['losses']}")
    del resumed, straight, compressed
    torch.cuda.empty_cache()

    # (d) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"train path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"train phase: ring launches {out['launches']}, {out['seconds']:.1f} s")
    report["train"] = out


# ---------------------------------------------------------------------------
# phase 16: the MoE family's serving path (plain PyTorch ops, no ring kernel)
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
# (b): LM_CUT's 2-layer cut at full width (128 experts, top-8), float32 with
# TF32 off: a prefill of MOE_PREFILL tokens through the cache, then
# MOE_DECODE cached steps, at each batch of MOE_BATCHES (a step at batch 2
# or 8 has C = 1: two tokens choosing one expert drop the later route)
MOE_PREFILL = 64
MOE_DECODE = 4
MOE_BATCHES = (2, 8)
# a call whose routes may differ between card and CPU: some token's K-th and
# (K+1)-th router probabilities on the CPU within this share of the K-th
MOE_NEAR_TIE = 1e-6


def _route_sets(experts, kept):
    """Each token's routes as (expert, kept) pairs sorted by expert (the
    rank order among a token's own experts changes no bin)."""
    order = experts.argsort(dim=1, stable=True)
    return experts.gather(1, order), kept.gather(1, order)


def _moe_routes(routes, steps: int, layers: int) -> dict:
    """Routes dropped and distinct experts chosen, per decode step, from a
    greedy run's ``recording_routes`` (``layers`` calls a step)."""
    import torch

    experts = torch.stack([r.experts for r in routes]).cpu()
    kept = torch.stack([r.kept for r in routes]).cpu()
    experts = experts.view(steps, layers, -1)
    dropped = (~kept).view(steps, -1).sum(1)
    distinct = [[int(experts[s, l].unique().numel()) for l in range(layers)] for s in range(steps)]
    return {"dropped": dropped.tolist(), "distinct": distinct}


def phase_moe(report: dict) -> None:
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tf_mod
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_bytes, param_count

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    out: dict = {"arch": MOE_ARCH}
    cfg = ARCHS[MOE_ARCH]
    api = build_model(cfg)
    nbytes, nparams = param_bytes(api.param_specs), param_count(api.param_specs)
    moe = api.param_specs["blocks"]["l0"]["moe"]
    experts_bytes = param_bytes({k: moe[k] for k in ("w_gate", "w_in", "w_out")})
    one_expert = experts_bytes // (cfg.num_layers * cfg.num_experts)  # one layer's
    out.update(params=nparams, param_bytes=nbytes, expert_bytes=experts_bytes,
               layers=cfg.num_layers, d_model=cfg.d_model, experts=cfg.num_experts,
               top_k=cfg.experts_per_tok, vocab=cfg.vocab_size, dtype=cfg.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(api.param_specs, SEED, device="cuda")
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"moe {MOE_ARCH}: {nparams} parameters, {nbytes} bytes (bf16) on the card in "
        f"{out['init_s']:.2f} s (peak {out['init_peak_bytes']} bytes)")

    # (a) greedy generation at full width and depth
    runs = []
    for batch, prompt_len, gen_len in SHORT_RUNS:
        with lm_layers.recording_routes() as routes:
            gen, row = _lm_generate("moe", MOE_ARCH, cfg, params, batch, prompt_len, gen_len,
                                    nbytes)
        nsteps = prompt_len + gen_len
        if len(routes) != nsteps * cfg.num_layers:
            fail(f"moe generation: {len(routes)} MoE calls for {nsteps} steps")
        r = _moe_routes(routes, nsteps, cfg.num_layers)
        del routes
        # the least a step can take with only the weights its routes need
        # (all but the experts, and each layer's distinct chosen experts) and
        # the cache read once; "bound_ms" reads every weight, as the dense
        # dispatch does
        active = [nbytes - experts_bytes + one_expert * sum(d) for d in r["distinct"][1:]]
        row.update(
            active_bound_ms=1e3 * (float(np.median(active)) + row["cache_bytes"]) / HBM_BYTES_PER_S,
            experts_a_layer_median=float(np.median(r["distinct"][1:])),
            dropped_per_step_median=float(np.median(r["dropped"])),
            dropped_per_step_max=int(max(r["dropped"])),
            routes_per_step=batch * cfg.experts_per_tok * cfg.num_layers)
        runs.append(row)
        log(f"moe generate batch {batch} prompt {prompt_len} gen {gen_len}: step median "
            f"{row['step_ms_median']:.3f} ms p90 {row['step_ms_p90']:.3f} ms (first "
            f"{row['first_step_ms']:.1f}), {row['tokens_per_s']:.1f} tokens/s; bounds: every "
            f"weight {row['bound_ms']:.3f} ms, active weights {row['active_bound_ms']:.3f} ms "
            f"({row['experts_a_layer_median']:.0f} experts a layer); routes dropped a step "
            f"median {row['dropped_per_step_median']:.0f} (max {row['dropped_per_step_max']}) "
            f"of {row['routes_per_step']}; wall {row['wall_s']:.2f} s")
    out["generate"] = runs
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["profile"] = _lm_profile(api, params, SHORT_RUNS[-1][0], what="moe")
    del params, gen
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the card against the host CPU: the 2-layer cut in float32, a
    # prefill through the cache and cached decode steps, same weights
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cut = dataclasses.replace(cfg, dtype="float32", **LM_CUT)
    capi = build_model(cut)
    K = cut.experts_per_tok
    card = materialize(capi.param_specs, SEED, device="cuda")
    host = _map_leaves(lambda _, t: t.cpu(), card)
    rng = np.random.default_rng(SEED)
    checks = []
    worst = {"logits": 0.0, "aux": 0.0}
    excused = dropped = 0
    spans = [(0, MOE_PREFILL)] + [(MOE_PREFILL + i, MOE_PREFILL + i + 1) for i in range(MOE_DECODE)]
    try:
        for batch in MOE_BATCHES:
            toks = torch.from_numpy(rng.integers(0, cut.vocab_size, (batch, spans[-1][1])).astype(np.int32))
            runs_b = {}
            for dev, p in (("cuda", card), ("cpu", host)):
                decl = capi.cache_decl(ShapeConfig("check", spans[-1][1] + 8, batch, "decode"))
                cache = _map_leaves(lambda _, ps: torch.zeros(
                    ps.shape, device=dev, dtype=torch.float32 if ps.shape else ps.dtype), decl)
                outs = []
                t0 = time.perf_counter()
                with torch.inference_mode(), lm_layers.recording_routes() as routes:
                    for a, b in spans:
                        lg, cache, aux = tf_mod.decoder_forward(
                            p, toks[:, a:b].to(dev), cut, cache=cache, cache_len=cache["len"])
                        outs.append((lg.cpu(), aux.cpu()))
                if dev == "cuda":
                    torch.cuda.synchronize()
                runs_b[dev] = (outs, [(r.experts.cpu(), r.kept.cpu(), r.top.cpu()) for r in routes],
                               time.perf_counter() - t0)
            (gouts, groutes, card_s), (couts, croutes, cpu_s) = runs_b["cuda"], runs_b["cpu"]
            for i, ((gl, ga), (cl, ca)) in enumerate(zip(gouts, couts)):
                e_l, e_a = _lm_rel(gl, cl), _lm_rel(ga, ca)
                worst["logits"], worst["aux"] = max(worst["logits"], e_l), max(worst["aux"], e_a)
                if not bool(torch.isfinite(gl).all()) or e_l > LM_F32_TOL or e_a > LM_F32_TOL:
                    fail(f"moe card vs cpu, batch {batch}, call {i}: logits rel L2 {e_l:.3e}, "
                         f"aux {e_a:.3e} (tol {LM_F32_TOL})")
            mismatched = 0
            for j, ((ge, gk, _), (ce, ck, ctop)) in enumerate(zip(groutes, croutes)):
                dropped += int((~ck).sum())
                (ge, gk), (ce, ck) = _route_sets(ge, gk), _route_sets(ce, ck)
                if torch.equal(ge, ce) and torch.equal(gk, ck):
                    continue
                mismatched += 1
                if bool((ctop[:, K - 1] - ctop[:, K] <= MOE_NEAR_TIE * ctop[:, K - 1]).any()):
                    excused += 1
                    continue
                fail(f"moe card vs cpu, batch {batch}, MoE call {j}: routes differ with no "
                     f"near-tie (experts equal {torch.equal(ge, ce)}, drops equal {torch.equal(gk, ck)})")
            checks.append({"batch": batch, "calls": len(spans), "moe_calls": len(croutes),
                           "routes_differing_calls": mismatched, "card_s": card_s, "cpu_s": cpu_s})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    out["card_vs_cpu"] = {
        "prefill": MOE_PREFILL, "decode_steps": MOE_DECODE, "batches": list(MOE_BATCHES),
        "dtype": "float32", "tf32": False, "tol": LM_F32_TOL, "near_tie": MOE_NEAR_TIE,
        "worst_logits_rel_l2": worst["logits"], "worst_aux_rel": worst["aux"],
        "excused_near_ties": excused, "dropped_routes_cpu": dropped, "runs": checks,
        "reduced": {k: f"{getattr(cfg, k)} -> {v}" for k, v in LM_CUT.items()}}
    log(f"moe card vs cpu, float32 2-layer cut (reduced: {out['card_vs_cpu']['reduced']}), "
        f"prefill {MOE_PREFILL} + {MOE_DECODE} steps at batch {MOE_BATCHES}: worst logits rel L2 "
        f"{worst['logits']:.3e}, aux {worst['aux']:.3e} (tol {LM_F32_TOL}); expert ids and drop "
        f"masks equal in every MoE call but {excused} excused near-ties; {dropped} routes dropped; "
        + ", ".join(f"batch {c['batch']} card {c['card_s']:.2f} s cpu {c['cpu_s']:.2f} s"
                    for c in checks))
    if dropped == 0:
        fail("moe card vs cpu: no route was dropped, the capacity path went unchecked")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()

    # (c) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"moe path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe phase: peak {out['peak_bytes']} bytes allocated, ring launches "
        f"{out['launches']}, {out['seconds']:.1f} s")
    report["moe"] = out


# ---------------------------------------------------------------------------
# phase 17: the MoE family's training path (plain PyTorch ops, no ring kernel)
# ---------------------------------------------------------------------------

# (a): qwen3-moe-30b-a3b at full width (128 experts, top-8), its depth cut
# from 48 to MOE_TRAIN_LAYERS layers (2.804 B parameters: with their
# gradients and AdamW's float32 state about 34 GB, beside the float32
# logits of 2 x 2048 tokens over a vocab of 151936, 2.5 GB), train_4k's
# sequence and global batch cut to MOE_TRAIN_SHAPE (seq, batch)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_SHAPE = (2048, 2)
MOE_TRAIN_STEPS = 4
# (b): phase 16 (b)'s 2-layer float32 cut (128 experts), its loss, aux and
# every gradient leaf at (seq, batch) tokens, card against CPU
MOE_GRAD_SHAPE = (64, 2)


def _recompute_routes(routes, units: int, steps: int):
    """Split a ``recording_routes`` list of train steps under remat
    ``"full"`` (each step: ``units`` forward calls, then their recomputes in
    reverse order) into (whether every recompute routed as its forward did,
    routes dropped a step in the forward)."""
    import torch

    same, dropped = True, []
    for st in range(steps):
        fwd = routes[2 * units * st:2 * units * st + units]
        again = routes[2 * units * st + units:2 * units * (st + 1)][::-1]
        same = same and len(again) == units and all(
            torch.equal(a.experts, b.experts) and torch.equal(a.kept, b.kept)
            for a, b in zip(fwd, again))
        dropped.append(int(sum(int((~r.kept).sum()) for r in fwd)))
    return same, dropped


def phase_moe_train(report: dict) -> None:
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import counters
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.models import layers as lm_layers
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_count

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    seq, batch = MOE_TRAIN_SHAPE
    cfg = dataclasses.replace(ARCHS[MOE_ARCH], num_layers=MOE_TRAIN_LAYERS)
    api = build_model(cfg)
    nparams = param_count(api.param_specs)
    moe = api.param_specs["blocks"]["l0"]["moe"]
    experts = param_count({k: moe[k] for k in ("w_gate", "w_in", "w_out")})
    # a token's parameters: all but the experts, and K of each layer's E
    active = nparams - experts + experts * cfg.experts_per_tok // cfg.num_experts
    out: dict = {"arch": MOE_ARCH, "layers": cfg.num_layers, "params": nparams,
                 "active_params": active, "dtype": cfg.dtype, "remat": cfg.remat,
                 "optimizer_config": f"{cfg.optimizer} ({cfg.opt_state_dtype} state)",
                 "seq": seq, "batch": batch, "steps": MOE_TRAIN_STEPS,
                 "reduced": {"num_layers": f"{ARCHS[MOE_ARCH].num_layers} -> {cfg.num_layers}",
                             "seq_len": f"4096 -> {seq}", "global_batch": f"256 -> {batch}"}}

    # (a) full width, depth cut, through the user's entry point; the routes
    # of every forward and of its recompute in the backward recorded
    shape = ShapeConfig("train_moe_cut", seq, batch, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with lm_layers.recording_routes() as routes:
        run = train(MOE_ARCH, smoke=False, layers=MOE_TRAIN_LAYERS, steps=MOE_TRAIN_STEPS,
                    shape=shape, seed=SEED, data_source="markov", log_every=1, device="cuda")
    wall = time.perf_counter() - t0
    units = cfg.num_layers  # one MoE layer a unit
    if len(routes) != 2 * units * MOE_TRAIN_STEPS:
        fail(f"moe train: {len(routes)} MoE calls for {MOE_TRAIN_STEPS} steps of {units} units")
    same, dropped = _recompute_routes(routes, units, MOE_TRAIN_STEPS)
    del routes
    flops = _train_flops(cfg, active, batch, seq)
    out.update(wall_s=wall, recompute_routes_equal=same, dropped_per_step=dropped,
               routes_per_step=batch * seq * cfg.experts_per_tok * units,
               **_train_rows("moe train", cfg, api, run, shape, flops, MOE_TRAIN_STEPS))
    log(f"moe train routes: the recompute under remat full routed as the forward: {same}; "
        f"routes dropped a step {dropped} of {out['routes_per_step']}")
    if not same:
        fail("moe train: a recompute's routes differ from its forward's")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t_phase

    # (b) the card against the host CPU: the 2-layer float32 cut, loss, aux
    # and every gradient leaf, TF32 off
    cut = dataclasses.replace(ARCHS[MOE_ARCH], dtype="float32", **LM_CUT)
    capi = build_model(cut)
    K = cut.experts_per_tok
    gseq, gb = MOE_GRAD_SHAPE
    card = materialize(capi.param_specs, SEED, device="cuda")
    host = _map_leaves(lambda _, t: t.cpu(), card)
    pipe = TokenPipeline(DataConfig(seed=SEED + 1, source="markov"), cut,
                         ShapeConfig("cut", gseq, gb, "train"))
    hbatch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    cbatch = {k: v.cuda() for k, v in hbatch.items()}
    runs = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, p, b in (("cuda", card, cbatch), ("cpu", host, hbatch)):
            t0 = time.perf_counter()
            with lm_layers.recording_routes() as rr:
                (loss, m), grads = value_and_grad(capi.loss_fn, p, b)
                loss, aux = float(loss), float(m["aux"])
            runs[dev] = (loss, aux, grads, rr, time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    (lc, ac, gcard, rc, card_s), (lh, ah, ghost, rh, cpu_s) = runs["cuda"], runs["cpu"]
    cu = len(rc) // 2
    same_c, _ = _recompute_routes(rc, cu, 1)
    mismatched = excused = 0
    for j, (a, b) in enumerate(zip(rc[:cu], rh[:cu])):
        (ge, gk), (ce, ck) = (_route_sets(a.experts.cpu(), a.kept.cpu()),
                              _route_sets(b.experts, b.kept))
        if torch.equal(ge, ce) and torch.equal(gk, ck):
            continue
        mismatched += 1
        if bool((b.top[:, K - 1] - b.top[:, K] <= MOE_NEAR_TIE * b.top[:, K - 1]).any()):
            excused += 1
            continue
        fail(f"moe train card vs cpu, MoE call {j}: routes differ with no near-tie")
    grad_errs = _leaf_errs(gcard, ghost)
    loss_err, aux_err = abs(lc - lh) / abs(lh), abs(ac - ah) / abs(ah)
    ratios = [loss_err / LM_F32_TOL, aux_err / LM_F32_TOL] + [
        e / TRAIN_GRAD_TOL for e in grad_errs.values()]
    out["card_vs_cpu"] = {
        "shape": [gb, gseq], "dtype": "float32", "tf32": False, "tol": LM_F32_TOL,
        "grad_tol": TRAIN_GRAD_TOL, "loss_card": lc, "loss_cpu": lh, "loss_rel": loss_err,
        "aux_card": ac, "aux_cpu": ah, "aux_rel": aux_err, "grad_rel_l2": grad_errs,
        "worst_over_tol": max(ratios), "routes_differing_calls": mismatched,
        "excused_near_ties": excused, "dropped_routes_cpu": int(sum(int((~r.kept).sum())
                                                                 for r in rh[:cu])),
        "recompute_routes_equal": same_c, "card_s": card_s, "cpu_s": cpu_s,
        "reduced": {k: f"{getattr(cfg, k)} -> {v}" for k, v in LM_CUT.items()}}
    log(f"moe train card vs cpu, float32 2-layer cut ({cut.num_experts} experts) at {gb} x "
        f"{gseq}: loss {lc:.6f} / {lh:.6f} (rel {loss_err:.2e}), aux {ac:.6f} / {ah:.6f} (rel "
        f"{aux_err:.2e}) (tol {LM_F32_TOL}); worst gradient leaf "
        f"{max(grad_errs.values()):.2e} ({max(grad_errs, key=grad_errs.get)}) (tol "
        f"{TRAIN_GRAD_TOL}); routes differ in {mismatched} calls ({excused} near-ties), "
        f"{out['card_vs_cpu']['dropped_routes_cpu']} dropped; recompute routes equal "
        f"{same_c}; card {card_s:.2f} s, cpu {cpu_s:.2f} s")
    if not np.isfinite(ratios).all() or max(ratios) > 1 or not same_c:
        fail(f"moe train card vs cpu: an error {max(ratios):.2f} times its tolerance, "
             f"recompute routes equal {same_c}")
    del card, host, gcard, ghost, runs, rc, rh
    gc.collect()
    torch.cuda.empty_cache()

    # (c) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"moe train path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"moe train phase: ring launches {out['launches']}, {out['seconds']:.1f} s")
    report["moe_train"] = out


# ---------------------------------------------------------------------------
# phase 18: the SSM family's serving and training paths (plain PyTorch ops,
# no ring kernel)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-370m", "zamba2-7b")
# (b): mamba2-370m at full width and depth, train_4k's sequence (16 chunks
# of 256 a layer) and its global batch cut to 2
SSM_TRAIN_ARCH = "mamba2-370m"
SSM_TRAIN_SHAPE = (4096, 2)
SSM_TRAIN_STEPS = 4
# (c): each arch's float32 cut, card against CPU: mamba2 2 layers, zamba2
# 2 units of 6 and one tail layer (13 layers, 1.25 B parameters).  Its
# matrices are rescaled to std 1/sqrt(fan-in), as the CPU tests draw them:
# the std rule's 1/sqrt(U) at U = 2 makes dt reach ~150 and the
# within-chunk cumulative decays ~3e3, whose float32 differences lose
# ~4e-3 to summation order alone (NVIDIA H100 80GB HBM3, 700 W).  A
# prefill of (seq, batch) tokens, cached calls of the spans' lengths (S > 1
# from a zero state, single steps, S > 1 continuing from their state), then
# loss_fn's gradients at (seq, batch) tokens; zamba2's shorter, for the
# host CPU's time
SSM_CUT_LAYERS = {"mamba2-370m": 2, "zamba2-7b": 13}
SSM_CUT_PREFILL = {"mamba2-370m": (512, 2), "zamba2-7b": (128, 1)}
SSM_CUT_SPANS = {"mamba2-370m": (256, 1, 1, 128, 1, 1), "zamba2-7b": (64, 1, 1, 32, 1, 1)}
SSM_CUT_GRADS = {"mamba2-370m": (512, 2), "zamba2-7b": (64, 1)}


def _fan_in_std(tree) -> None:
    """Each bf16 weight matrix of a ``materialize`` draw rescaled in place
    from the std rule's 1/sqrt(shape[0]) (1/sqrt(U) for a stacked leaf) to
    1/sqrt(fan-in), its second-to-last dim; the embedding and the float32
    leaves keep theirs."""
    import torch

    for k, v in tree.items():
        if isinstance(v, dict):
            _fan_in_std(v)
        elif k != "embed" and v.dtype == torch.bfloat16 and v.dim() >= 2:
            v.mul_((v.shape[0] / v.shape[-2]) ** 0.5)


def _ssm_step_bytes(cfg, api, batch: int, cache_len: int) -> tuple:
    """(the weight bytes a decode step reads, the cache bytes it moves):
    every weight once, and zamba2's shared block once more at each of its
    applications after the first; the float32 SSM state and the conv
    history read and written (new tensors a step), the shared block's KV
    cache read once."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime.sharding import param_bytes

    weights = param_bytes(api.param_specs)
    if cfg.family == "hybrid":
        weights += (cfg.num_layers // cfg.shared_attn_every - 1) * param_bytes(
            api.param_specs["shared"])
    decl = api.cache_decl(ShapeConfig("bound", cache_len, batch, "decode"))
    moved = sum(2 * param_bytes(v) for k, v in decl.items()
                if k in ("conv", "state", "tail_conv", "tail_state"))
    kv = sum(param_bytes(v) for k, v in decl.items() if k in ("shared_k", "shared_v"))
    return weights, moved + kv


def _ssd_flops(cfg, batch: int, seq: int) -> float:
    """The SSD scan's matmul FLOPs of a train step (forward and backward,
    3x the forward's): a chunk of c tokens forms C B^T (c^2 N), the
    intra-chunk product (c^2 H P), the carried state's output and update
    (2 c N H P)."""
    c = min(cfg.ssm_chunk, seq)
    H, N, P = cfg.ssm_d_inner // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim
    per_chunk = 2 * c * c * (N + H * P) + 4 * c * N * H * P
    return 3.0 * per_chunk * (seq // c) * batch * cfg.num_layers


def phase_ssm(report: dict) -> None:
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import counters
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_bytes, param_count

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    out: dict = {}

    # (a) greedy generation at full width and depth
    t_part = time.perf_counter()
    for arch in SSM_ARCHS:
        cfg = ARCHS[arch]
        api = build_model(cfg)
        nbytes, nparams = param_bytes(api.param_specs), param_count(api.param_specs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = materialize(api.param_specs, SEED, device="cuda")
        torch.cuda.synchronize()
        entry = {"params": nparams, "param_bytes": nbytes, "layers": cfg.num_layers,
                 "d_model": cfg.d_model, "d_inner": cfg.ssm_d_inner, "state": cfg.ssm_state,
                 "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                 "init_s": time.perf_counter() - t0}
        if cfg.family == "hybrid":
            entry["shared_params"] = param_count(api.param_specs["shared"])
        log(f"ssm {arch}: {nparams} parameters, {nbytes} bytes (bf16) on the card in "
            f"{entry['init_s']:.2f} s")
        runs = []
        for batch, prompt_len, gen_len in SHORT_RUNS:
            wbytes, cbytes = _ssm_step_bytes(cfg, api, batch, prompt_len + gen_len + 8)
            gen, row = _lm_generate(f"ssm {arch}", arch, cfg, params, batch, prompt_len,
                                    gen_len, wbytes, cache_bytes=cbytes)
            row.update(weight_bytes_a_step=wbytes, weight_bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
            runs.append(row)
            log(f"ssm {arch} generate batch {batch} prompt {prompt_len} gen {gen_len}: step "
                f"median {row['step_ms_median']:.3f} ms p90 {row['step_ms_p90']:.3f} ms (first "
                f"{row['first_step_ms']:.1f}), {row['tokens_per_s']:.1f} tokens/s, bound "
                f"{row['bound_ms']:.3f} ms ({wbytes} weight bytes, {cbytes} cache bytes a "
                f"step); wall {row['wall_s']:.2f} s")
        entry["generate"] = runs
        entry["peak_bytes"] = torch.cuda.max_memory_allocated()
        entry["profile"] = _lm_profile(api, params, SHORT_RUNS[-1][0], steps=1,
                                       what=f"ssm {arch}")
        out[arch] = entry
        del params, gen
        gc.collect()
        torch.cuda.empty_cache()

    out["generate_s"] = time.perf_counter() - t_part

    # (b) mamba2-370m training at full width and depth
    t_part = time.perf_counter()
    seq, batch = SSM_TRAIN_SHAPE
    cfg = ARCHS[SSM_TRAIN_ARCH]
    api = build_model(cfg)
    nparams = param_count(api.param_specs)
    shape = ShapeConfig("train_4k_cut", seq, batch, "train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train(SSM_TRAIN_ARCH, smoke=False, steps=SSM_TRAIN_STEPS, shape=shape, seed=SEED,
                data_source="markov", log_every=1, device="cuda")
    wall = time.perf_counter() - t0
    flops = _train_flops(cfg, nparams, batch, seq) + _ssd_flops(cfg, batch, seq)
    out["train"] = {"arch": SSM_TRAIN_ARCH, "params": nparams, "seq": seq, "batch": batch,
                    "steps": SSM_TRAIN_STEPS, "dtype": cfg.dtype, "remat": cfg.remat,
                    "wall_s": wall, "reduced": {"global_batch": f"256 -> {batch}"},
                    **_train_rows("ssm train", cfg, api, run, shape, flops, SSM_TRAIN_STEPS)}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t_part

    # (c) each arch's float32 cut, the card against the host CPU, TF32 off:
    # prefill logits, every cached call's logits, loss_fn's gradients
    checks = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in SSM_ARCHS:
            cut = dataclasses.replace(ARCHS[arch], dtype="float32", num_layers=SSM_CUT_LAYERS[arch])
            capi = build_model(cut)
            forward = ssm_mod.mamba_forward if cut.family == "ssm" else ssm_mod.zamba_forward
            card = materialize(capi.param_specs, SEED, device="cuda")
            _fan_in_std(card)
            # the bf16 matrices held as float32 (exact: the values the model
            # casts them to at every use), so no call pays the cast
            card = _map_leaves(lambda _, t: t.float(), card)
            host = _map_leaves(lambda _, t: t.cpu(), card)
            pseq, pb = SSM_CUT_PREFILL[arch]
            spans = SSM_CUT_SPANS[arch]
            toks = torch.from_numpy(np.random.default_rng(SEED).integers(
                0, cut.vocab_size, (pb, pseq)).astype(np.int32))
            gseq, gb = SSM_CUT_GRADS[arch]
            pipe = TokenPipeline(DataConfig(seed=SEED + 1, source="markov"), cut,
                                 ShapeConfig("cut", gseq, gb, "train"))
            gbatch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
            runs = {}
            for dev, p in (("cuda", card), ("cpu", host)):
                t0 = time.perf_counter()
                t = toks.to(dev)
                with torch.inference_mode():
                    pre = forward(p, t, cut)[0].cpu()
                    decl = capi.cache_decl(ShapeConfig("check", sum(spans) + 8, pb, "decode"))
                    cache = _map_leaves(lambda _, ps: torch.zeros(
                        ps.shape, device=dev, dtype=torch.float32 if ps.shape else ps.dtype),
                        decl)
                    calls, at = [], 0
                    for S in spans:
                        lg, cache = capi.decode_fn(p, cache, {"tokens": t[:, at:at + S]})
                        calls.append(lg.cpu())
                        at += S
                (loss, _), grads = value_and_grad(
                    capi.loss_fn, p, {k: v.to(dev) for k, v in gbatch.items()})
                if dev == "cuda":
                    torch.cuda.synchronize()
                runs[dev] = (pre, calls, float(loss), grads, time.perf_counter() - t0)
            (gp, gcalls, gl, gg, card_s), (hp, hcalls, hl, hg, cpu_s) = runs["cuda"], runs["cpu"]
            pre_err = _lm_rel(gp, hp)
            call_errs = [_lm_rel(a, b) for a, b in zip(gcalls, hcalls)]
            loss_err = abs(gl - hl) / abs(hl)
            grad_errs = _leaf_errs(gg, hg)
            finite = bool(torch.isfinite(gp).all()) and all(
                bool(torch.isfinite(c).all()) for c in gcalls)
            ratios = ([pre_err / LM_F32_TOL, loss_err / LM_F32_TOL]
                      + [e / LM_F32_TOL for e in call_errs]
                      + [e / TRAIN_GRAD_TOL for e in grad_errs.values()])
            checks[arch] = {
                "layers": cut.num_layers, "params": param_count(capi.param_specs),
                "prefill": [pb, pseq], "spans": list(spans), "grad_shape": [gb, gseq],
                "prefill_rel_l2": pre_err, "call_rel_l2": call_errs, "loss_card": gl,
                "loss_cpu": hl, "loss_rel": loss_err, "grad_rel_l2": grad_errs,
                "worst_over_tol": max(ratios), "finite": finite, "card_s": card_s,
                "cpu_s": cpu_s,
                "reduced": {"num_layers": f"{ARCHS[arch].num_layers} -> {cut.num_layers}"}}
            log(f"ssm {arch} card vs cpu, float32 {cut.num_layers}-layer cut: prefill "
                f"{pb} x {pseq} rel L2 {pre_err:.3e}; cached calls {list(spans)} "
                f"worst {max(call_errs):.3e} (tol {LM_F32_TOL}); loss at {gb} x {gseq} "
                f"{gl:.6f} / {hl:.6f} (rel {loss_err:.2e}); worst gradient leaf "
                f"{max(grad_errs.values()):.2e} ({max(grad_errs, key=grad_errs.get)}) (tol "
                f"{TRAIN_GRAD_TOL}); card {card_s:.2f} s, cpu {cpu_s:.2f} s")
            if not finite or not np.isfinite(ratios).all() or max(ratios) > 1:
                fail(f"ssm {arch} card vs cpu: an error {max(ratios):.2f} times its tolerance "
                     f"(finite {finite})")
            del card, host, runs, gg, hg
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    out["card_vs_cpu"] = checks

    # (d) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"ssm path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"ssm phase: ring launches {out['launches']}, {out['seconds']:.1f} s")
    report["ssm"] = out


# ---------------------------------------------------------------------------
# phase 19: the encoder-decoder and VLM families' serving and training paths
# (plain PyTorch ops, no ring kernel)
# ---------------------------------------------------------------------------

XV_ENCDEC, XV_VLM = "seamless-m4t-medium", "internvl2-2b"
XV_ARCHS = (XV_ENCDEC, XV_VLM)
# (a) the real serving path at each batch: seamless encodes XV_FRAMES
# frames, fills its cross cache and prefills a prompt of
# XV_PROMPT[seamless] tokens into the cache in one call; internvl2 prefills
# its 256 patches and XV_PROMPT[internvl2] tokens in one call; then
# XV_STEPS greedy decode steps, each timed by CUDA events
XV_BATCHES = (2, 8)
XV_FRAMES = 512
XV_PROMPT = {XV_ENCDEC: 16, XV_VLM: 64}
XV_STEPS = 32
XV_PROFILE_STEPS = 2  # profiled steps continuing the batch-8 cache
# (b) training at full width and depth: train_4k's sequence, its batch cut
# from 256 to 2 (seamless: 1024 source frames; internvl2: the 256 patches
# ahead of the 4096 text tokens); one warm-up step and three timed
XV_TRAIN_SHAPE = (4096, 2)
XV_TRAIN_STEPS = 4
# (c) float32 cuts, card against CPU: 2 decoder layers (and 2 encoder
# layers), the published widths and vocabularies, the matrices at std
# 1/sqrt(fan-in) as the CPU tests draw them (the std rule's 1/sqrt(U) at U
# = 2 makes every matrix ~30x larger).  seamless: XV_CUT_FRAMES frames,
# internvl2: its 256 patches; a prompt of XV_CUT_PROMPT tokens prefilled
# into the cache in one call, then XV_CUT_STEPS cached steps fed fixed
# tokens; loss_fn's gradients at XV_CUT_GRADS (seq, batch) text tokens
XV_CUT_LAYERS = 2
XV_CUT_FRAMES = 128
XV_CUT_PROMPT = 32
XV_CUT_STEPS = 8
XV_CUT_GRADS = (128, 2)
# relative L2: logits, encoder outputs, cross K/V and the loss (float32,
# TF32 off: summation order only); every gradient leaf
XV_F32_TOL = 1e-5
XV_GRAD_TOL = 2e-3


def _xv_decode_weight_bytes(cfg, specs) -> int:
    """The weights a decode step reads: all but the encoder (its work is
    done before the first step) and the patch projection (the prompt's)."""
    from repro_torch.runtime.sharding import param_bytes

    skip = {k: specs[k] for k in ("encoder", "frontend_proj") if k in specs}
    return param_bytes(specs) - param_bytes(skip)


def _xv_train_flops(cfg, specs, batch: int, seq: int) -> float:
    """Model FLOPs of one train step of ``batch`` x ``seq`` text tokens,
    without the recompute: 6 N a token for every matmul by the parameters
    that token meets (the tied head included), and 12 L H hd a (query, key)
    pair for the attention (QK^T and PV, forward and backward).  The VLM's
    decoder sees 256 patches ahead of the text (``frontend_proj`` only
    them); the encoder-decoder's encoder and its cross K/V projections see
    the source frames, its cross-attention pairs every text token with
    every frame."""
    from repro_torch.models.registry import _src_len
    from repro_torch.runtime.sharding import param_count

    hh = cfg.num_heads * cfg.hd
    if cfg.family == "vlm":
        fp = param_count(specs["frontend_proj"])
        S = seq + cfg.frontend_len
        return (6.0 * (param_count(specs) - fp) * batch * S + 6.0 * fp * batch * cfg.frontend_len
                + 12.0 * cfg.num_layers * hh * S * S * batch)
    src = _src_len(cfg, seq)
    enc = param_count(specs["encoder"])
    xkv = sum(param_count(specs["blocks"][f"l{i}"]["xattn"][w])
              for i in range(len(cfg.layer_pattern)) for w in ("wk", "wv"))
    dec = param_count(specs) - enc - xkv
    return (6.0 * dec * batch * seq + 6.0 * (enc + xkv) * batch * src
            + 12.0 * hh * batch * (cfg.num_layers * (seq * seq + seq * src)
                                   + cfg.encoder_layers * src * src))


def _xv_serve(arch: str, cfg, api, params, batch: int, pipe_cls, dcfg) -> tuple:
    """seamless: ``encoder_forward`` over XV_FRAMES frames from
    ``with_frontend``, ``build_xattn_cache`` into the ``xkv`` entry of a cache
    from ``cache_decl``, the prompt prefilled into the cache in one
    ``decoder_forward`` call; internvl2: its patches and the prompt
    prefilled in one call; then XV_STEPS greedy ``decode_fn`` steps.  Every
    stage timed by CUDA events; checked: tokens in range, logits finite,
    the cache's length.  Returns (timing row, the cache after the steps,
    the last tokens)."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import transformer as tf_mod
    from repro_torch.optim.optimizers import _leaves
    from repro_torch.runtime.sharding import _map_leaves

    prompt_len = XV_PROMPT[arch]
    seq = XV_FRAMES * cfg.src_ratio if cfg.family == "encdec" else prompt_len
    pipe = pipe_cls(dcfg, cfg, ShapeConfig("serve", seq, batch, "prefill"))
    raw = pipe.with_frontend(pipe.batch_at(0), 0)
    prompt = torch.from_numpy(raw["tokens"][:, :prompt_len].copy()).cuda()
    decl = api.cache_decl(ShapeConfig("serve", cfg.frontend_len + prompt_len + XV_STEPS + 8,
                                      batch, "decode"))
    cache = _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype, device="cuda"), decl)
    ev = [torch.cuda.Event(enable_timing=True)]
    row: dict = {"batch": batch, "prompt": prompt_len, "steps": XV_STEPS}
    kw = {}
    toks = []
    with torch.inference_mode():
        ev[0].record()
        if cfg.family == "encdec":
            frames = torch.from_numpy(raw["frames"]).cuda()
            enc_out = tf_mod.encoder_forward(params, frames, cfg)
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
            cache["xkv"] = tf_mod.build_xattn_cache(params, enc_out, cfg)
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
            row["frames"] = list(frames.shape)
        else:
            kw["patches"] = torch.from_numpy(raw["patches"]).cuda()
            row["patches"] = list(kw["patches"].shape)
        logits, cache, _ = tf_mod.decoder_forward(params, prompt, cfg, cache=cache,
                                                  cache_len=cache["len"], **kw)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        for _ in range(XV_STEPS):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks.append(nxt)
            logits, cache = api.decode_fn(params, cache, {"tokens": nxt})
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
        torch.cuda.synchronize()
        gen = torch.cat(toks, dim=1).cpu().numpy()
    ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    if cfg.family == "encdec":
        row["encoder_ms"], row["xattn_cache_ms"] = ms[0], ms[1]
        ms = ms[2:]
    steps = np.asarray(ms[2:])  # the first step pays its first calls
    if not ((gen >= 0) & (gen < cfg.vocab_size)).all() or not bool(torch.isfinite(logits).all()):
        fail(f"xv {arch} serve batch {batch}: tokens out of range or logits not finite")
    if cache["len"] != cfg.frontend_len + prompt_len + XV_STEPS:
        fail(f"xv {arch} serve batch {batch}: cache length {cache['len']}")
    wbytes = _xv_decode_weight_bytes(cfg, api.param_specs)
    cbytes = sum(t.numel() * t.element_size()
                 for t in _leaves({k: v for k, v in cache.items() if k != "len"}))
    row.update(prefill_ms=ms[0], first_step_ms=ms[1], step_ms=ms[1:],
               step_ms_median=float(np.median(steps)), step_ms_p90=float(np.percentile(steps, 90)),
               tokens_per_s=batch * 1e3 / float(np.median(steps)), weight_bytes=wbytes,
               cache_bytes=cbytes, bound_ms=1e3 * (wbytes + cbytes) / HBM_BYTES_PER_S,
               tokens_head=gen[0, :8].tolist())
    enc = (f"encoder {row['encoder_ms']:.2f} ms over {row['frames']} frames, cross cache "
           f"{row['xattn_cache_ms']:.2f} ms, " if cfg.family == "encdec"
           else f"patches {row['patches']}, ")
    log(f"xv {arch} serve batch {batch}: {enc}prefill of {prompt_len} tokens {row['prefill_ms']:.2f}"
        f" ms; {XV_STEPS} steps median {row['step_ms_median']:.3f} ms p90 "
        f"{row['step_ms_p90']:.3f} ms (first {row['first_step_ms']:.1f}), "
        f"{row['tokens_per_s']:.1f} tokens/s, bound {row['bound_ms']:.3f} ms ({wbytes} weight "
        f"bytes, {cbytes} cache bytes a step)")
    return row, cache, toks[-1]


def _xv_cut_run(arch: str, cut, capi, p, dev: str, inputs: dict) -> dict:
    """The float32 cut on ``dev``: (encoder output and cross K/V,) the
    prompt prefilled into a float32 cache in one call, XV_CUT_STEPS cached
    steps fed ``inputs["fed"]``, and loss_fn's loss and gradients."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as tf_mod
    from repro_torch.runtime.sharding import _map_leaves

    out: dict = {}
    t0 = time.perf_counter()
    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        return [to(v) for v in x] if isinstance(x, list) else x.to(dev)

    on = to(inputs)
    with torch.inference_mode():
        decl = capi.cache_decl(ShapeConfig("check", cut.frontend_len + XV_CUT_PROMPT
                                           + XV_CUT_STEPS + 8, 2, "decode"))
        cache = _map_leaves(lambda _, ps: torch.zeros(
            ps.shape, device=dev, dtype=torch.float32 if ps.shape else ps.dtype), decl)
        kw = {}
        if cut.family == "encdec":
            enc = tf_mod.encoder_forward(p, on["frames"], cut)
            cache["xkv"] = tf_mod.build_xattn_cache(p, enc, cut)
            out["enc_out"] = enc.cpu()
            out["xkv"] = _map_leaves(lambda _, t: t.cpu(), cache["xkv"])
        else:
            kw["patches"] = on["patches"]
        lg, cache, _ = tf_mod.decoder_forward(p, on["prompt"], cut, cache=cache,
                                              cache_len=cache["len"], **kw)
        calls = [lg.cpu()]
        for tok in on["fed"]:
            lg, cache = capi.decode_fn(p, cache, {"tokens": tok})
            calls.append(lg.cpu())
        out["calls"] = calls
    (loss, m), grads = value_and_grad(capi.loss_fn, p, on["grad_batch"])
    if dev == "cuda":
        torch.cuda.synchronize()
    out.update(loss=float(loss), ce=float(m["ce"]), grads=grads, s=time.perf_counter() - t0)
    return out


def phase_encdec_vlm(report: dict) -> None:
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import counters
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import _leaves
    from repro_torch.runtime.sharding import _map_leaves, materialize, param_bytes, param_count

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    out: dict = {}
    dcfg = DataConfig(seed=SEED + 1, source="markov")

    # (a) serving at full width and depth: the real path at each batch, one
    # profiled stretch of batch-8 steps, and greedy_generate (the CLI's path)
    t_part = time.perf_counter()
    for arch in XV_ARCHS:
        cfg = ARCHS[arch]
        api = build_model(cfg)
        nbytes, nparams = param_bytes(api.param_specs), param_count(api.param_specs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = materialize(api.param_specs, SEED, device="cuda")
        torch.cuda.synchronize()
        entry = {"params": nparams, "param_bytes": nbytes, "layers": cfg.num_layers,
                 "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
                 "vocab": cfg.vocab_size, "dtype": cfg.dtype,
                 "init_s": time.perf_counter() - t0}
        if cfg.family == "encdec":
            entry["encoder_params"] = param_count(api.param_specs["encoder"])
            entry["encoder_layers"] = cfg.encoder_layers
        log(f"xv {arch}: {nparams} parameters, {nbytes} bytes (bf16) on the card in "
            f"{entry['init_s']:.2f} s")
        runs = []
        for batch in XV_BATCHES:
            row, cache, last = _xv_serve(arch, cfg, api, params, batch, TokenPipeline, dcfg)
            runs.append(row)
        entry["serve"] = runs
        state = {"cache": cache, "tok": last}

        def step():
            _, state["cache"] = api.decode_fn(params, state["cache"], {"tokens": state["tok"]})

        with torch.inference_mode():
            entry["profile"] = _device_profile(step, XV_PROFILE_STEPS,
                                               f"xv {arch} profile, batch {XV_BATCHES[-1]}",
                                               batch=XV_BATCHES[-1])
        del cache, state
        b, pl, gl = SHORT_RUNS[0]
        decl = api.cache_decl(ShapeConfig("serve", pl + gl + 8, b, "decode"))
        gen, row = _lm_generate(f"xv {arch}", arch, cfg, params, b, pl, gl,
                                _xv_decode_weight_bytes(cfg, api.param_specs),
                                cache_bytes=param_bytes({k: v for k, v in decl.items()
                                                         if k != "len"}))
        entry["greedy_generate"] = row
        log(f"xv {arch} greedy_generate (the CLI's path) batch {b} prompt {pl} gen {gl}: step "
            f"median {row['step_ms_median']:.3f} ms, tokens {row['tokens_head']}")
        entry["peak_bytes"] = torch.cuda.max_memory_allocated()
        log(f"xv {arch} serving peak {entry['peak_bytes']} bytes allocated")
        out[arch] = entry
        del params, gen
        gc.collect()
        torch.cuda.empty_cache()
    out["serve_s"] = time.perf_counter() - t_part

    # (b) training at full width and depth through launch.train.train
    t_part = time.perf_counter()
    seq, batch = XV_TRAIN_SHAPE
    shape = ShapeConfig("train_4k_cut", seq, batch, "train")
    for arch in XV_ARCHS:
        cfg = ARCHS[arch]
        api = build_model(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train(arch, smoke=False, steps=XV_TRAIN_STEPS, shape=shape, seed=SEED,
                    data_source="markov", log_every=1, device="cuda")
        wall = time.perf_counter() - t0
        flops = _xv_train_flops(cfg, api.param_specs, batch, seq)
        out[arch]["train"] = {
            "params": param_count(api.param_specs), "seq": seq, "batch": batch,
            "steps": XV_TRAIN_STEPS, "dtype": cfg.dtype, "remat": cfg.remat, "wall_s": wall,
            "reduced": {"global_batch": f"256 -> {batch}"},
            **_train_rows(f"xv {arch} train", cfg, api, run, shape, flops, XV_TRAIN_STEPS)}
        del run
        gc.collect()
        torch.cuda.empty_cache()
    out["train_s"] = time.perf_counter() - t_part

    # (c) each arch's float32 cut, the card against the host CPU, TF32 off
    t_part = time.perf_counter()
    checks = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in XV_ARCHS:
            full = ARCHS[arch]
            cut = dataclasses.replace(full, dtype="float32", num_layers=XV_CUT_LAYERS,
                                      encoder_layers=min(full.encoder_layers, XV_CUT_LAYERS))
            capi = build_model(cut)
            card = materialize(capi.param_specs, SEED, device="cuda")
            _fan_in_std(card)
            # the bf16 matrices held as float32 (exact: the values the model
            # casts them to at every use)
            card = _map_leaves(lambda _, t: t.float(), card)
            host = _map_leaves(lambda _, t: t.cpu(), card)
            rng = np.random.default_rng(SEED)
            gseq, gb = XV_CUT_GRADS
            gpipe = TokenPipeline(dcfg, cut, ShapeConfig("cut", gseq, gb, "train"))
            inputs = {
                "prompt": torch.from_numpy(rng.integers(0, cut.vocab_size, (2, XV_CUT_PROMPT))
                                           .astype(np.int32)),
                "fed": [torch.from_numpy(rng.integers(0, cut.vocab_size, (2, 1)).astype(np.int32))
                        for _ in range(XV_CUT_STEPS)],
                "grad_batch": {k: torch.from_numpy(v) for k, v in
                               gpipe.with_frontend(gpipe.batch_at(0), 0).items()}}
            spipe = TokenPipeline(dcfg, cut, ShapeConfig(
                "cut", XV_CUT_FRAMES * cut.src_ratio, 2, "prefill"))
            raw = spipe.with_frontend(spipe.batch_at(0), 0)
            key = "frames" if cut.family == "encdec" else "patches"
            inputs[key] = torch.from_numpy(raw[key])
            g = _xv_cut_run(arch, cut, capi, card, "cuda", inputs)
            h = _xv_cut_run(arch, cut, capi, host, "cpu", inputs)
            errs = {"prefill": _lm_rel(g["calls"][0], h["calls"][0]),
                    "steps": max(_lm_rel(a, b) for a, b in zip(g["calls"][1:], h["calls"][1:])),
                    "loss": abs(g["loss"] - h["loss"]) / abs(h["loss"])}
            if cut.family == "encdec":
                errs["enc_out"] = _lm_rel(g["enc_out"], h["enc_out"])
                errs.update({f"xkv{k}": v for k, v in _leaf_errs(g["xkv"], h["xkv"]).items()})
            grad_errs = _leaf_errs(g["grads"], h["grads"])
            finite = all(bool(torch.isfinite(c).all()) for c in g["calls"]) and all(
                bool(torch.isfinite(t).all()) for t in _leaves(g["grads"]))
            ratios = ([e / XV_F32_TOL for e in errs.values()]
                      + [e / XV_GRAD_TOL for e in grad_errs.values()])
            checks[arch] = {
                "layers": cut.num_layers, "encoder_layers": cut.encoder_layers,
                "params": param_count(capi.param_specs), key: list(inputs[key].shape),
                "prompt": XV_CUT_PROMPT, "steps": XV_CUT_STEPS, "grad_shape": [gb, gseq],
                "rel_l2": errs, "grad_rel_l2": grad_errs, "loss_card": g["loss"],
                "loss_cpu": h["loss"], "worst_over_tol": max(ratios), "finite": finite,
                "card_s": g["s"], "cpu_s": h["s"],
                "reduced": {"num_layers": f"{full.num_layers} -> {cut.num_layers}",
                            "encoder_layers": f"{full.encoder_layers} -> {cut.encoder_layers}",
                            "dtype": "bfloat16 -> float32"}}
            worst_grad = max(grad_errs, key=grad_errs.get)
            log(f"xv {arch} card vs cpu, float32 {cut.num_layers}-layer cut: "
                + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + f" (tol {XV_F32_TOL}); loss {g['loss']:.6f} / {h['loss']:.6f}; worst gradient "
                f"leaf {grad_errs[worst_grad]:.2e} ({worst_grad}) (tol {XV_GRAD_TOL}); card "
                f"{g['s']:.2f} s, cpu {h['s']:.2f} s")
            if not finite or not np.isfinite(ratios).all() or max(ratios) > 1:
                fail(f"xv {arch} card vs cpu: an error {max(ratios):.2f} times its tolerance "
                     f"(finite {finite})")
            del card, host, g, h
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    out["card_vs_cpu"] = checks
    out["card_vs_cpu_s"] = time.perf_counter() - t_part

    # (d) no ring kernel ran
    out["launches"] = dict(counters.launches_by_route)
    if any(out["launches"].values()):
        fail(f"encdec/vlm path launched ring kernels: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"encdec/vlm phase: ring launches {out['launches']}, serve {out['serve_s']:.1f} s, "
        f"train {out['train_s']:.1f} s, card vs cpu {out['card_vs_cpu_s']:.1f} s, "
        f"{out['seconds']:.1f} s")
    report["encdec_vlm"] = out


def _kernel_rows(report: dict, totals: dict) -> list:
    """The ``{"kernels": [...]}`` rows: one per route and one per pre-pass,
    each at its representative main-path shape (the (3, 7) tower's lift and
    ``tower`` at ElasticStream's step 9), with the times of every other
    timed shape of the route in ``per_shape_ms``."""
    t = report["kernel_timings"]
    w, enc = t["workers"], t["encode_a"]
    shape = lambda row: (f"{row['batch']} x ({row['t']}x{row['r']} @ {row['r']}x{row['s']}) "
                         f"over GR(2^32) degrees {row['ring']}")
    d4 = lambda route: {f"{'+'.join(x['paths'])} {x['a']} @ {x['b']} degrees {x['ring']}": x["ms"]
                        for x in report["path_kernel_timings"] if x["route"] == route}
    base = {"route": "cuda", "replaces": "src/repro/kernels/gr_matmul.py:40", "library_ms": None,
            "tolerance": 0}  # integer-exact: each kernel and its plain version agree bit for bit

    def tuned(route, row):  # phase 10's row at this representative shape
        key = f"|{route}|{row['ring'].strip('(),') or '1'}x1e32|{row['t']}x{row['r']}x{row['s']}"
        for point in report["autotune"]["points"]:
            if point["key"].endswith(key):
                return {k: point[k] for k in ("static", "static_ms", "tuned", "tuned_ms")}
        return None

    src = "src/repro_torch/kernels/csrc/"
    # this slice's kernels at ElasticStream's step 9 (phase 4's timings)
    step9 = {(x["route"], tuple(x["a"])): x for x in report["path_kernel_timings"]
             if x["ring"] == "(3, 7)"}
    lift, tower = step9[("tc", (8, 512, 1024))], step9[("tower", (8, 8))]
    shape9 = lambda row: f"{row['a']} @ {row['b']} over GR(2^32, (3, 7))"  # noqa: E731
    # this slice's tc_left and its stack pre-pass at the (3, 7) tower's
    # 32 x 32 decode for 64 workers (phase 4), the other shapes beside it
    left = {f"{'+'.join(x['paths'])} {x['a']} @ {x['b']} degrees {x['ring']}": x
            for x in report["path_kernel_timings"] if x["route"] == "tc_left"}
    dec = next(x for x in left.values()
               if x["ring"] == str(LEFT_LINE_CALL[0]) and tuple(x["a"]) == LEFT_LINE_CALL[1])
    left_rows = [
        {**base, "name": "gr_matmul_tc_left", "source": src + "gr_matmul_tc_left.cu",
         "launches": totals["tc_left"], "max_abs_err": report["kernel_max_abs_err"]["tc_left"],
         "ms": dec["ms"], "plain_ms": dec["plain_ms"], "bound_ms": dec["bound_ms"],
         "bound_by": dec["bound_by"], "int8_yardstick_ms": dec["int8_yardstick_ms"],
         "main_ms": dec["main_ms"], "grid": dec["grid"],
         "simt_ms": dec["simt_ms"], "tc_ms": dec["rivals_ms"]["tc"], "shape": shape9(dec),
         "per_shape_ms": {k: v["ms"] for k, v in left.items()},
         "per_shape_main_ms": {k: v["main_ms"] for k, v in left.items()}},
        {**base, "name": "gr_matmul_tc_stack", "source": src + "gr_matmul_tc_left.cu",
         "launches": totals["stack"], "max_abs_err": report["kernel_max_abs_err"]["stack"],
         "ms": dec["stack_ms"], "plain_ms": dec["stack_plain_ms"], "bound_ms": dec["stack_bound_ms"],
         "bound_by": "bytes", "shape": shape9(dec),
         "per_shape_ms": {k: v["stack_ms"] for k, v in left.items()}},
        {**base, "name": "gr_matmul_tc_left_lift", "source": src + "gr_matmul_tc_left.cu",
         "launches": totals["left_lift"], "max_abs_err": report["kernel_max_abs_err"]["left_lift"],
         "ms": dec["lift_a_ms"], "plain_ms": dec["lift_a_plain_ms"],
         "bound_ms": dec["lift_a_bound_ms"], "bound_by": dec["lift_a_bound_by"], "shape": shape9(dec),
         "per_shape_ms": {k: v["lift_a_ms"] for k, v in left.items()}},
    ]
    new = left_rows + [
        {**base, "name": "gr_matmul_tc_lift", "source": src + "gr_matmul_tc.cu",
         "launches": totals["lift"], "max_abs_err": report["kernel_max_abs_err"]["lift"],
         "ms": lift["lift_ms"], "plain_ms": lift["lift_plain_ms"], "bound_ms": lift["lift_bound_ms"],
         "bound_by": "bytes", "shape": shape9(lift),
         "tc_with_prepasses_ms": lift["ms"], "tc_simt_ms": lift["simt_ms"],
         "tc_bound_ms": lift["bound_ms"],
         "per_shape_ms": {f"{'+'.join(x['paths'])} {x['a']} @ {x['b']} degrees {x['ring']}":
                          x["lift_ms"] for x in report["path_kernel_timings"] if "lift_ms" in x}},
        {**base, "name": "gr_matmul_tower", "source": src + "gr_matmul_tower.cu",
         "launches": totals["tower"], "max_abs_err": report["kernel_max_abs_err"]["tower"],
         "ms": tower["ms"], "plain_ms": tower["tower_plain_ms"], "bound_ms": tower["bound_ms"],
         "bound_by": tower["bound_by"], "int32_bound_ms": tower["int32_bound_ms"],
         "simt_ms": tower["simt_ms"], "shape": shape9(tower), "per_shape_ms": d4("tower")},
    ]
    # simt at CodedQuantMatmul's 8-token worker product (phase 4), its other
    # timed shapes beside it, and the tile kernel at the main path's workers
    simt = next(x for x in report["path_kernel_timings"]
                if x["route"] == "simt" and QUANT_DECODE_LINE in x["paths"])
    return new + [
        {**base, "name": "gr_matmul_simt", "source": src + "gr_matmul.cu",
         "launches": totals["simt"], "max_abs_err": report["kernel_max_abs_err"]["simt"],
         "ms": simt["ms"], "plain_ms": simt["plain_ms"], "bound_ms": simt["bound_ms"],
         "bound_by": simt["bound_by"], "int32_bound_ms": simt["int32_bound_ms"],
         "int8_yardstick_ms": simt["int8_yardstick_ms"], "grid": simt["grid"],
         "shape": f"{simt['a']} @ {simt['b']} over GR(2^32) degrees {simt['ring']}",
         "per_shape_ms": d4("simt"), "tile_kernel_ms": w["simt_ms"],
         "tile_kernel_shape": shape(w)},
        {**base, "name": "gr_matmul_tc", "source": src + "gr_matmul_tc.cu",
         "launches": totals["tc"], "max_abs_err": report["kernel_max_abs_err"]["tc"],
         "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
         "bound_by": w["bound_by"], "int8_yardstick_ms": w["int8_yardstick_ms"],
         "simt_ms": w["simt_ms"], "shape": shape(w), "per_shape_ms": d4("tc"),
         "autotune": tuned("tc", w)},
        {**base, "name": "gr_matmul_tc_limbs", "source": src + "gr_matmul_tc.cu",
         "launches": totals["limbs"], "max_abs_err": report["kernel_max_abs_err"]["limbs"],
         "ms": w["limbs_ms"], "plain_ms": w["limbs_plain_ms"], "bound_ms": w["limbs_bound_ms"],
         "bound_by": "bytes", "shape": shape(w)},
        {**base, "name": "gr_matmul_skinny", "source": src + "gr_matmul_skinny.cu",
         "launches": totals["skinny"], "max_abs_err": report["kernel_max_abs_err"]["skinny"],
         "ms": enc["ms"], "plain_ms": enc["plain_ms"], "bound_ms": enc["bound_ms"],
         "bound_by": enc["bound_by"], "simt_ms": enc["simt_ms"], "shape": shape(enc),
         "autotune": tuned("skinny", enc),
         "per_shape_ms": {**{k: v["ms"] for k, v in t.items() if v["route"] == "skinny"},
                          **d4("skinny")}},
    ]


# ---------------------------------------------------------------------------
# phase 20: the LM substrate on a device mesh (plain PyTorch ops and DTensor;
# no ring kernel)
# ---------------------------------------------------------------------------

# 8 ranks on this card (this process rank 0, 7 spawned) in one gloo default
# group, meshed (2, 4) ("data", "model")
MESH_WORLD = 8
MESH_SHAPE = ((2, 4), ("data", "model"))
MESH_ARCH = "qwen3-moe-30b-a3b"
MESH_LAYERS = 2
MESH_TRAIN_SHAPE = (2048, 2)       # (seq, global batch): the a2a island
MESH_TRAIN_STEPS = 3
MESH_DECODE = (8, 8, 16)           # (batch, cached steps, cache slots): the shardmap island
MESH_F32_DECODE = 4
MESH_F32_SHAPE = (512, 2)          # (seq, batch) of (b)'s gradients: the a2a island
# (b) routes top-8 as published.  Top-K routing is discontinuous: the
# mesh's float32 sums, in another order than one device's, move the router
# probabilities a little, and a token whose K-th and (K+1)-th probabilities
# lie closer than that may take another expert set.  Such a flip is
# judged against the moves measured in the same run, and only the tokens
# that no flip reaches are held to the tolerances
PIPE_MESH_RANKS = 4
PIPE_SHAPE = (8, 8, 16, 4)         # (layers, batch, width, microbatches)
MESH_CPSUM_N = 4096
MESH_TIMEOUT_S = 600
# the dry-run's production cell, run in a subprocess (256 fake ranks)
MESH_DRYRUN = ("qwen3-moe-30b-a3b", "decode_32k", "single")


def _mesh_routes(routes) -> dict:
    """Calls by island and routes dropped (summed over the calls) by shard."""
    calls: dict = {}
    dropped: dict = {}
    for r in routes:
        calls[r.route] = calls.get(r.route, 0) + 1
        key = ",".join(f"{a}={i}" for a, i in (r.shard or {}).items())
        dropped[key] = dropped.get(key, 0) + int((~r.kept).sum())
    return {"calls": calls, "dropped_by_shard": dropped}


def _routed_sets(calls, layers: int, rows: int, shard_rows):
    """Each of the first ``layers`` MoE calls' expert sets, sorted, and
    router probabilities, as (rows, K) and (rows, E) tensors a layer in
    global token order: ``calls`` holds every rank's recorded (shard,
    experts, probs) triples, ``shard_rows(shard, T)`` the global rows of a
    shard's T tokens (None: a shard whose routes another rank's copy
    already gave)."""
    import torch

    out = []
    for layer in range(layers):
        K, E = calls[0][layer][1].shape[1], calls[0][layer][2].shape[1]
        sets = torch.full((rows, K), -1, dtype=torch.int64)
        probs = torch.full((rows, E), float("nan"), dtype=torch.float64)
        for rank_calls in calls:
            shard, experts, p = rank_calls[layer]
            idx = shard_rows(shard, experts.shape[0])
            if idx is not None:
                sets[idx] = experts.sort(dim=1).values.long()
                probs[idx] = p.double()
        out.append((sets, probs))
    return out


def _layer_flips(sets, probs, solo, K: int):
    """One MoE call, the mesh's (expert sets, probabilities) against one
    device's ``Routing``: the tokens routed to another expert set, each
    token's largest router-probability move, one device's gap between its
    K-th and (K+1)-th probabilities, and its top probability."""
    mine = solo.experts.cpu().sort(dim=1).values.long()
    ps = solo.probs.cpu().double()
    top = solo.top.cpu().double()
    return ((sets != mine).any(dim=1), (probs - ps).abs().amax(dim=1),
            top[:, K - 1] - top[:, K], top[:, 0])


class _FlipTally:
    """Flips judged against the run's own noise, layer by layer: the
    probability moves of the tokens routed alike that no flip reaches are
    the noise; a flip that no earlier flip reaches is explained when one
    device's K-th to (K+1)-th gap is at most twice the layer's largest
    move; a flip that an earlier one reaches is counted as downstream."""

    def __init__(self, layers: int):
        self.noise = [[] for _ in range(layers)]
        self.top = [(0.0, None)] * layers  # each layer's largest move and its token
        self.fresh = []
        self.downstream = 0

    def add(self, layer: int, bad, eps, gap, top0, tainted, where) -> None:
        import torch

        clean = ~bad & ~tainted
        self.noise[layer].append(torch.stack([eps[clean], eps[clean] / top0[clean]]))
        if clean.any():
            i = int(torch.where(clean, eps, -1.0).argmax())
            if float(eps[i]) > self.top[layer][0]:
                self.top[layer] = (float(eps[i]), where(i))
        for t in torch.nonzero(bad & ~tainted).flatten().tolist():
            self.fresh.append((layer, where(t), float(gap[t])))
        self.downstream += int((bad & tainted).sum())

    def summary(self) -> dict:
        import torch

        noise = [torch.cat(n, dim=1) if n else torch.zeros(2, 0) for n in self.noise]
        out = {"noise_max": [float(n[0].max()) if n.numel() else 0.0 for n in noise],
               "noise_median": [float(n[0].median()) if n.numel() else 0.0 for n in noise],
               "noise_p99": [float(n[0].quantile(0.99)) if n.numel() else 0.0 for n in noise],
               "noise_max_at": [where for _, where in self.top],
               "noise_rel_max": [float(n[1].max()) if n.numel() else 0.0 for n in noise],
               "flips": len(self.fresh) + self.downstream, "downstream": self.downstream,
               "explained": [], "unexplained": []}
        for layer, where, gap in self.fresh:
            bound = 2 * out["noise_max"][layer]
            rec = {"layer": layer, "token": where, "gap": gap, "bound": bound}
            out["explained" if gap <= bound else "unexplained"].append(rec)
        return out


def _gather_to_rank0(tree, rank: int):
    """Every DTensor leaf gathered whole (a collective, leaf by leaf), kept
    on rank 0 only: the other ranks drop each leaf at once."""
    from repro_torch.runtime.sharding import full_tree

    if isinstance(tree, dict):
        return {k: _gather_to_rank0(v, rank) for k, v in tree.items()}
    full = full_tree(tree)
    return full if rank == 0 else None


def _mesh_body(rank: int, device: str, small: bool) -> dict:
    """One rank's share of phase 20 ((a)-(c)); every rank runs it alike."""
    import dataclasses
    import gc
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import recording, rules_for, value_and_grad
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.models import layers as lm_layers
    from repro_torch.optim import compressed_psum
    from repro_torch.optim.compression import quantize_ef
    from repro_torch.runtime import collectives as coll
    from repro_torch.runtime.pipeline import pipelined_apply
    from repro_torch.runtime.sharding import (_map_leaves, axis_rules, distribute_tree, full_tree,
                                              materialize)

    cuda = device == "cuda"
    counters.reset()
    out: dict = {"rank": rank, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):  # host seconds of each part, for the phase's budget
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now

    mesh = make_debug_mesh(*MESH_SHAPE, device=device)
    base = ARCHS[MESH_ARCH].smoke() if small else dataclasses.replace(
        ARCHS[MESH_ARCH], num_layers=MESH_LAYERS)
    seq, batch = (64, 2) if small else MESH_TRAIN_SHAPE
    shape = ShapeConfig("mesh_train", seq, batch, "train")
    api = build_model(base)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def release():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # (a) train(mesh=...): the a2a island; collectives counted op by op
    layers = None if small else MESH_LAYERS
    with lm_layers.recording_routes() as routes, recording(memory=False) as rec:
        run = train(MESH_ARCH, smoke=small, steps=MESH_TRAIN_STEPS, shape=shape, seed=SEED,
                    data_source="markov", log_every=0, device=device, mesh=mesh, layers=layers)
    ms = [h["ms"] for h in run["history"]]
    out["train"] = {
        "losses": run["losses"], "step_ms": ms, "warm_step_ms_median": statistics.median(ms[1:]),
        "collectives_per_step": {k: {"count": v["count"] / MESH_TRAIN_STEPS,
                                     "bytes": v["bytes"] / MESH_TRAIN_STEPS}
                                 for k, v in rec.coll.items()},
        # host seconds inside the collective calls, each entered after a
        # device sync (the transport and the wait for the other ranks), and
        # in those syncs (the device work queued before a collective)
        "collective_s": rec.comm_s, "collective_share": rec.comm_s / (sum(ms) / 1e3),
        "sync_s": rec.sync_s, "sync_share": rec.sync_s / (sum(ms) / 1e3),
        "rules": rules_for(base, shape), **_mesh_routes(routes)}
    if not np.isfinite(run["losses"]).all():
        raise RuntimeError(f"mesh train: a loss is not finite: {run['losses']}")
    params = full_tree(run["state"]["params"])
    del run
    part("train")
    # decode under the decode rules: the shardmap island
    dbatch, dsteps, slots = MESH_DECODE
    dshape = ShapeConfig("mesh_decode", slots, dbatch, "decode")
    drules = rules_for(base, dshape)
    decl = api.cache_decl(dshape)
    dparams = distribute_tree(params, api.param_specs, mesh, drules)
    cache = distribute_tree(_map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype,
                                                                  device=device), decl),
                            decl, mesh, drules)
    cache["len"] = 0
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED + 20)
    toks = torch.randint(0, base.vocab_size, (dbatch, dsteps), generator=gen,
                         dtype=torch.int32).to(device)
    walls = []
    with axis_rules(mesh, drules), torch.no_grad(), lm_layers.recording_routes() as droutes:
        for t in range(dsteps):
            sync()
            t0 = time.perf_counter()
            logits, cache = api.decode_fn(dparams, cache, {"tokens": toks[:, t:t + 1]})
            logits = full_tree(logits)
            sync()
            walls.append(1e3 * (time.perf_counter() - t0))
    if not torch.isfinite(logits).all():
        raise RuntimeError("mesh decode: a logit is not finite")
    out["decode"] = {"step_ms": walls, "warm_step_ms_median": statistics.median(walls[1:]),
                     "rules": drules, **_mesh_routes(droutes)}
    del dparams, cache, params
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    # the same training without a mesh, on rank 0 alone: the others give
    # their cached blocks back to the card first, and wait
    release()
    if rank == 0:
        solo = train(MESH_ARCH, smoke=small, steps=MESH_TRAIN_STEPS, shape=shape, seed=SEED,
                     data_source="markov", log_every=0, device=device, layers=layers)
        sms = [h["ms"] for h in solo["history"]]
        out["train_no_mesh"] = {"losses": solo["losses"], "step_ms": sms,
                                "warm_step_ms_median": statistics.median(sms[1:])}
        del solo
    release()

    part("decode_and_no_mesh_train")
    # (b) float32, TF32 off, top-8, no drops: the mesh against one device
    # from the same weights
    E, K = base.num_experts, base.experts_per_tok
    cut = dataclasses.replace(base, dtype="float32", capacity_factor=E / K)  # C = T
    capi = build_model(cut)
    world = dist.get_world_size()
    sizes = dict(zip(MESH_SHAPE[1], MESH_SHAPE[0]))
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = materialize(capi.param_specs, SEED + 1, device)
        gseq, gbatch = (64, 2) if small else MESH_F32_SHAPE
        gshape = ShapeConfig("mesh_f32", gseq, gbatch, "train")
        pipe = TokenPipeline(DataConfig(seed=SEED + 2, source="markov"), cut, gshape)
        b32 = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(0).items()}
        trules = rules_for(cut, gshape)
        L = cut.num_layers
        bl, sl = gbatch // sizes["data"], gseq // sizes["model"]

        def train_rows(shard, T):  # the a2a island: batch rows by data, seq by model
            b0, s0 = shard["data"] * bl, shard["model"] * sl
            return torch.tensor([(b0 + i // sl) * gseq + s0 + i % sl for i in range(T)])

        def gathered(calls):  # every rank's (shard, experts, probs) a call
            mine = [(r.shard, r.experts.cpu(), r.probs.cpu()) for r in calls]
            out = [None] * world
            dist.all_gather_object(out, mine)
            return out

        # a forward with every label: loss, aux, and each token's routes
        dp = distribute_tree(p32, capi.param_specs, mesh, trules)
        db = distribute_tree(b32, capi.batch_specs(gshape), mesh, trules)
        with axis_rules(mesh, trules), torch.no_grad(), lm_layers.recording_routes() as fr:
            lm, mm = capi.loss_fn(dp, db)
        lm, am = float(full_tree(lm)), float(full_tree(mm["aux"]))
        tcalls = gathered(fr[:L])
        island_calls = {"train": _mesh_routes(fr)["calls"]}
        del db, fr
        held = [None]
        if rank == 0:
            with torch.no_grad(), lm_layers.recording_routes() as sr:
                l0, m0 = capi.loss_fn(p32, b32)
            l0, a0 = float(l0), float(m0["aux"])
            train_tally = _FlipTally(L)
            flipped = torch.zeros(gbatch * gseq, dtype=torch.bool)
            tainted = torch.zeros_like(flipped)  # reached by an earlier layer's flip
            for layer, (sets, probs) in enumerate(_routed_sets(tcalls, L, gbatch * gseq,
                                                               train_rows)):
                bad, eps, gap, top0 = _layer_flips(sets, probs, sr[layer], K)
                train_tally.add(layer, bad, eps, gap, top0, tainted,
                                lambda t: [t // gseq, t % gseq])
                flipped |= bad
                # the layers after see every later token of the sequence
                tainted = (bad | tainted).view(gbatch, gseq).int().cummax(dim=1).values
                tainted = tainted.bool().view(-1)
            held = [(~(flipped | tainted)).view(gbatch, gseq)]
            del sr
        dist.broadcast_object_list(held, src=0)
        held = held[0].to(device)
        # the gradients of the loss over the tokens no flip reaches
        m32 = dict(b32, labels=torch.where(held, b32["labels"], -1))
        db = distribute_tree(m32, capi.batch_specs(gshape), mesh, trules)
        with axis_rules(mesh, trules):
            (lh, _), gm = value_and_grad(capi.loss_fn, dp, db)
        lh = float(full_tree(lh))
        gm = _gather_to_rank0(gm, rank)
        del dp, db
        dlog = []
        dshape32 = ShapeConfig("mesh_f32_decode", slots, dbatch, "decode")
        drules32 = rules_for(cut, dshape32)
        decl32 = capi.cache_decl(dshape32)
        dp = distribute_tree(p32, capi.param_specs, mesh, drules32)
        # a float32 cache (the declaration's is bf16): the probabilities' cast
        # to the cache's dtype would round in bf16 sums taken in two orders
        c = distribute_tree(_map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=torch.float32,
                                                                  device=device), decl32),
                            decl32, mesh, drules32)
        c["len"] = 0
        with axis_rules(mesh, drules32), torch.no_grad(), lm_layers.recording_routes() as dr:
            for t in range(MESH_F32_DECODE):
                lg, c = capi.decode_fn(dp, c, {"tokens": toks[:, t:t + 1]})
                dlog.append(full_tree(lg))
        dcalls = gathered(dr)
        island_calls["decode"] = _mesh_routes(dr)["calls"]
        del dp, c, dr
        if rank != 0:
            del p32, b32, m32, gm
        release()
        if rank == 0:
            with lm_layers.recording_routes() as sr:
                (l0h, _), g0 = value_and_grad(capi.loss_fn, p32, m32)
            l0h = float(l0h)
            dropped = sum(int((~r.kept).sum()) for r in sr)
            del sr
            c0 = _map_leaves(lambda _, ps: torch.zeros(ps.shape, dtype=torch.float32,
                                                       device=device), decl32)
            c0["len"] = 0
            dbl = dbatch // sizes["data"]

            def decode_rows(shard, T):  # the shardmap island: rows by data, alike by model
                return None if shard["model"] else torch.arange(T) + shard["data"] * dbl

            decode_tally = _FlipTally(L)
            gone = torch.zeros(dbatch, dtype=torch.bool)  # rows a flip has reached
            errs, rows_held = [], []
            with torch.no_grad(), lm_layers.recording_routes() as sdr:
                for t in range(MESH_F32_DECODE):
                    lg0, c0 = capi.decode_fn(p32, c0, {"tokens": toks[:, t:t + 1]})
                    step = [calls[t * L:(t + 1) * L] for calls in dcalls]
                    tainted = gone.clone()
                    for layer, (sets, probs) in enumerate(_routed_sets(step, L, dbatch,
                                                                       decode_rows)):
                        bad, eps, gap, top0 = _layer_flips(sets, probs, sdr[t * L + layer], K)
                        decode_tally.add(layer, bad, eps, gap, top0, tainted,
                                         lambda r, t=t: [t, r])
                        tainted |= bad
                    gone |= tainted  # a flipped row's cache differs from here on
                    keep = (~gone).nonzero().flatten()
                    rows_held.append(len(keep))
                    if len(keep):
                        errs.append(_lm_rel(dlog[t].float()[keep.to(device)],
                                            lg0.float()[keep.to(device)]))
            grad_errs = _leaf_errs(gm, g0)
            out["f32"] = {
                "shape": [gbatch, gseq], "loss_mesh": lm, "loss_one_device": l0,
                "loss_rel": abs(lm - l0) / abs(l0), "aux_mesh": am, "aux_one_device": a0,
                "aux_rel": abs(am - a0) / abs(a0), "tokens_held": int(held.sum()),
                "held_loss_mesh": lh, "held_loss_one_device": l0h,
                "held_loss_rel": abs(lh - l0h) / abs(l0h), "grad_rel_l2": grad_errs,
                "decode_logits_rel_l2": errs, "decode_rows_held": rows_held,
                "tol": LM_F32_TOL, "grad_tol": TRAIN_GRAD_TOL, "experts_per_token": K,
                "capacity_factor": cut.capacity_factor, "dropped": dropped,
                "routes": island_calls,
                "train_flips": train_tally.summary(), "decode_flips": decode_tally.summary()}
            del g0, gm, p32, b32, m32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    dist.barrier()

    part("float32")
    # (c) pipelined_apply and compressed_psum over a 4-rank "pod" mesh
    from torch.distributed.device_mesh import DeviceMesh

    pmesh = DeviceMesh(device, list(range(PIPE_MESH_RANKS)), mesh_dim_names=("pod",))
    if rank < PIPE_MESH_RANKS:
        L, B, D, M = PIPE_SHAPE
        g = torch.Generator(device="cpu")
        g.manual_seed(SEED + 21)
        Ws = (torch.randn((L, D, D), generator=g) * 0.1).to(device)
        x = torch.randn((B, D), generator=g).to(device)

        def stage_fn(ws, h):
            for w in ws:
                h = torch.tanh(h @ w)
            return h

        y = pipelined_apply(stage_fn, Ws, x, pmesh, axis="pod", microbatches=M).to_local()
        pipe_err = float((y - stage_fn(Ws, x)).abs().max())
        gs = [torch.randn(MESH_CPSUM_N, generator=g) for _ in range(PIPE_MESH_RANKS)]
        with coll.host_staging(pmesh):
            mean, _ = compressed_psum(gs[rank].to(device), torch.zeros(MESH_CPSUM_N, device=device),
                                      "pod", pmesh)
        if rank == 0:
            qs, scales = zip(*[quantize_ef(gi, torch.zeros_like(gi))[:2] for gi in gs])
            host = torch.tensordot(torch.stack(scales), torch.stack(qs).float(),
                                   dims=([0], [0])) / PIPE_MESH_RANKS
            out["pipeline"] = {"shape": list(PIPE_SHAPE), "ranks": PIPE_MESH_RANKS,
                               "max_abs_err": pipe_err}
            out["compressed_psum"] = {"n": MESH_CPSUM_N, "ranks": PIPE_MESH_RANKS,
                                      "max_abs_err_vs_host": float((mean.cpu() - host).abs().max()),
                                      "max_abs_err_vs_mean": float(
                                          (mean.cpu() - torch.stack(gs).mean(0)).abs().max())}
    dist.barrier()
    part("pipeline")
    out["launches"] = dict(counters.launches_by_route)
    return out


def _mesh_rank(rank: int, world: int, port: int, device: str, small: bool, q) -> None:
    """A spawned rank of phase 20: joins the group, runs ``_mesh_body``, and
    reports its summary (or its traceback) on ``q``."""
    import traceback

    try:
        q.put((rank, "ok", _mesh_group_run(rank, world, port, device, small)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()[-3000:]))
        raise


def _mesh_group_run(rank: int, world: int, port: int, device: str, small: bool) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        out = _mesh_body(rank, device, small)
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(device: str = "cuda", small: bool = False) -> list:
    """Phase 20's (a)-(c) on ``MESH_WORLD`` ranks: this process rank 0, the
    rest spawned; returns every rank's summary, rank 0's first.  A rank that
    fails fails the run."""
    import multiprocessing as mp
    import socket
    import traceback

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mesh_rank, args=(r, MESH_WORLD, port, device, small, q),
                         daemon=True) for r in range(1, MESH_WORLD)]
    for p in procs:
        p.start()
    try:
        try:
            mine = _mesh_group_run(0, MESH_WORLD, port, device, small)
        except BaseException:
            # a rank that failed first leaves the others a closed connection:
            # report the ranks' own errors before rank 0's
            mine_tb, others = traceback.format_exc()[-2000:], []
            deadline = time.time() + 20
            while time.time() < deadline:
                try:
                    r, status, payload = q.get(timeout=1)
                except Exception:
                    if not any(p.is_alive() for p in procs):
                        break
                    continue
                if status != "ok":
                    others.append(f"rank {r}:\n{payload[-2500:]}")
            others.sort(key=lambda e: "Connection closed" in e)  # the root cause first
            fail("mesh ranks failed:\n" + "\n".join(others[:2]) + f"\nrank 0:\n{mine_tb}")
        results = {0: mine}
        deadline = time.time() + MESH_TIMEOUT_S
        while len(results) < MESH_WORLD and time.time() < deadline:
            r, status, payload = q.get(timeout=max(deadline - time.time(), 1))
            if status != "ok":
                fail(f"mesh rank {r} failed:\n{payload}")
            results[r] = payload
        for p in procs:
            p.join(timeout=60)
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if len(results) < MESH_WORLD or bad:
            fail(f"mesh ranks: {len(results)} of {MESH_WORLD} reported, exit codes {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(MESH_WORLD)]


def phase_mesh(report: dict) -> None:
    import gc
    import os
    import subprocess

    import torch

    from repro_torch.kernels import counters

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counters.reset()
    # (d) the production dry-run cell, in a subprocess beside the ranks
    arch, shape, mesh_kind = MESH_DRYRUN
    art = ROOT / "build" / "dryrun_torch"
    env = {**os.environ, "PYTHONPATH": str(SRC), "REPRO_TORCH_DRYRUN_DIR": str(art),
           "CUDA_VISIBLE_DEVICES": ""}
    t_dry = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", mesh_kind, "--force"], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_mesh_ranks("cuda")
    finally:
        dry_out, _ = dry.communicate(timeout=MESH_TIMEOUT_S)
    dry_s = time.perf_counter() - t_dry
    r0 = ranks[0]
    out: dict = {"arch": MESH_ARCH, "mesh": dict(zip(MESH_SHAPE[1], MESH_SHAPE[0])),
                 "world": MESH_WORLD, "backend": "gloo (ranks sharing one card)",
                 "reduced": {"num_layers": f"48 -> {MESH_LAYERS}",
                             "seq_len": f"4096 -> {MESH_TRAIN_SHAPE[0]}",
                             "global_batch": f"256 -> {MESH_TRAIN_SHAPE[1]}"}}
    tr, de = r0["train"], r0["decode"]
    out["train"] = tr
    out["train_no_mesh"] = r0["train_no_mesh"]
    out["decode"] = de
    out["peak_bytes_by_rank"] = [r["peak_bytes"] for r in ranks]
    calls, dropped = {}, {"train": {}, "decode": {}}
    for r in ranks:
        for part in ("train", "decode"):
            for k, v in r[part]["calls"].items():
                calls[k] = calls.get(k, 0) + v
            dropped[part].update(r[part]["dropped_by_shard"])
    out["island_calls_all_ranks"] = calls
    out["dropped_by_shard"] = dropped  # routes dropped over the run, by the shard that routed them
    out["part_s"] = r0["part_s"]
    log(f"mesh parts (rank 0, s): {json.dumps(r0['part_s'])}")
    log(f"mesh (a): {MESH_ARCH} {MESH_LAYERS} layers on {out['mesh']}: train losses "
        f"{tr['losses']}, warm step {tr['warm_step_ms_median']:.1f} ms (no mesh, one device "
        f"{out['train_no_mesh']['warm_step_ms_median']:.1f} ms); collectives a step (rank 0) "
        f"{json.dumps(tr['collectives_per_step'])}; of the steps' host wall "
        f"{100 * tr['collective_share']:.1f}% inside collective calls entered after a device "
        f"sync, {100 * tr['sync_share']:.1f}% in those syncs; decode warm step "
        f"{de['warm_step_ms_median']:.1f} ms; island calls {calls}; routes dropped by shard "
        f"{json.dumps(dropped)}; peak bytes by rank {out['peak_bytes_by_rank']}")
    for island in ("ep_a2a", "shardmap"):
        if calls.get(island, 0) < 1:
            fail(f"mesh: the {island} island never ran ({calls})")
    f32 = r0["f32"]
    out["f32"] = f32
    ratios = [f32["loss_rel"] / LM_F32_TOL, f32["aux_rel"] / LM_F32_TOL,
              f32["held_loss_rel"] / LM_F32_TOL] + [
        e / LM_F32_TOL for e in f32["decode_logits_rel_l2"]] + [
        e / TRAIN_GRAD_TOL for e in f32["grad_rel_l2"].values()]
    worst = sorted(f32["grad_rel_l2"].items(), key=lambda kv: -kv[1])[:3]
    tf, df = f32["train_flips"], f32["decode_flips"]
    # routing is discontinuous: a flip is explained by the probability moves
    # measured on the tokens routed alike; the tokens a flip reaches are not
    # compared, every other one is
    for name, fl in (("training", tf), ("decode", df)):
        log(f"mesh (b): {name}: {fl['flips']} tokens routed apart ({len(fl['explained'])} "
            f"explained, {fl['downstream']} downstream of a flip, {len(fl['unexplained'])} "
            f"unexplained {fl['unexplained'][:4]}); router probability moves a layer: max "
            f"{fl['noise_max']} (at {fl['noise_max_at']}), p99 {fl['noise_p99']}, median "
            f"{fl['noise_median']}, max relative {fl['noise_rel_max']}; "
            f"explained gaps {[round(e['gap'], 9) for e in fl['explained']]}")
    if tf["unexplained"] or df["unexplained"]:
        fail("mesh (b): a route differs from one device's by more than the measured noise")
    if not f32["tokens_held"] or not f32["decode_logits_rel_l2"]:
        fail(f"mesh (b): no token left to hold ({f32['tokens_held']} training tokens, decode "
             f"rows {f32['decode_rows_held']})")
    if f32["dropped"]:
        fail(f"mesh (b): {f32['dropped']} routes dropped at capacity factor E / K")
    if (f32["routes"]["train"].get("ep_a2a", 0) < 1
            or f32["routes"]["decode"].get("shardmap", 0) < 1):
        fail(f"mesh (b): an island did not run: {f32['routes']}")
    log(f"mesh (b): float32 (TF32 off, top-{f32['experts_per_token']}, cf "
        f"{f32['capacity_factor']}, {f32['dropped']} dropped) mesh vs one device: loss rel "
        f"{f32['loss_rel']:.2e}, aux rel {f32['aux_rel']:.2e}; held tokens "
        f"{f32['tokens_held']} of {f32['shape'][0] * f32['shape'][1]}: loss rel "
        f"{f32['held_loss_rel']:.2e}, worst gradient leaves {worst} (tol {TRAIN_GRAD_TOL}); "
        f"decode logits rel {[f'{e:.2e}' for e in f32['decode_logits_rel_l2']]} on rows "
        f"{f32['decode_rows_held']} (tol {LM_F32_TOL}); routes {f32['routes']}")
    if not all(x == x for x in ratios) or max(ratios) > 1:
        fail(f"mesh (b): an error {max(ratios):.2f} times its tolerance")
    out["pipeline"], out["compressed_psum"] = r0["pipeline"], r0["compressed_psum"]
    log(f"mesh (c): pipelined_apply vs sequential max abs err {r0['pipeline']['max_abs_err']:.2e}; "
        f"compressed_psum vs the host's tensordot {r0['compressed_psum']['max_abs_err_vs_host']:.2e}"
        f" (vs the true mean {r0['compressed_psum']['max_abs_err_vs_mean']:.2e})")
    if r0["pipeline"]["max_abs_err"] > 1e-5 or r0["compressed_psum"]["max_abs_err_vs_host"] > 1e-6:
        fail("mesh (c): the pipeline or compressed_psum disagrees")
    # (d) the dry-run cell
    path = art / f"{arch}__{shape}__{mesh_kind}.json"
    if dry.returncode != 0 or not path.is_file():
        fail(f"mesh (d): the dry-run of {MESH_DRYRUN} failed:\n{dry_out[-3000:]}")
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok":
        fail(f"mesh (d): dry-run status {rec.get('status')}: {rec.get('error')}")
    if not rec["fits_hbm"]:  # 5.1 GiB a device by the host's dry-run
        fail(f"mesh (d): {arch} x {shape} needs {rec['bytes_per_device'] / 2**30:.1f} GiB a "
             "device, past the H100's 80 GB")
    out["dryrun"] = {k: rec[k] for k in ("arch", "shape", "mesh", "chips", "lower_s",
                                         "bytes_per_device", "fits_hbm", "collectives",
                                         "collective_counts", "roofline", "memory")}
    out["dryrun"]["subprocess_s"] = dry_s
    t = rec["roofline"]
    log(f"mesh (d): dry-run {arch} x {shape} x {mesh_kind} ({rec['chips']} fake ranks): ok in "
        f"{rec['lower_s']} s (subprocess {dry_s:.1f} s); {rec['bytes_per_device'] / 2**30:.2f} "
        f"GiB a device (fits the H100's 80 GB: {rec['fits_hbm']}); collectives "
        f"{json.dumps(rec['collectives'])}; roofline t_compute {t['t_compute_s']:.3g} s, "
        f"t_memory {t['t_memory_s']:.3g} s, t_collective {t['t_collective_s']:.3g} s, dominant "
        f"{t['dominant']} ({rec['device']})")
    # (e) no ring kernel on any rank
    launches = {r["rank"]: r["launches"] for r in ranks}
    launches["phase"] = dict(counters.launches_by_route)
    out["launches"] = launches
    if any(any(v.values()) for v in launches.values()):
        fail(f"mesh path launched ring kernels: {launches}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase: ring launches none, {out['seconds']:.1f} s")
    report["mesh"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=ROOT / "build" / "chip_smoke.json",
                    help="where to write the full JSON report")
    ap.add_argument("--seed", type=int, default=SEED, help="seed of every operand drawn")
    args = ap.parse_args()
    globals()["SEED"] = args.seed
    csrc = SRC / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / f).is_file() for f in ("gr_matmul.cu", "gr_matmul_tc.cu", "gr_matmul_tc_left.cu",
                                               "gr_matmul_tc_common.cuh", "gr_matmul_skinny.cu",
                                               "gr_matmul_tower.cu")):
        print(f"chip_smoke: the port's sources are not under {SRC}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    report: dict = {"phase_seconds": {}}
    t0 = time.perf_counter()

    def timed(phase, *args):  # the phase's wall seconds go into the report
        start = time.perf_counter()
        out = phase(report, *args)
        report["phase_seconds"][phase.__name__] = time.perf_counter() - start
        return out

    timed(phase_env_build)
    timed(phase_kernels)
    totals, calls = timed(phase_main_path)
    for phase in (phase_elastic, phase_stream, phase_quantized, phase_pool, phase_serve,
                  phase_hedge, phase_spmd):
        for route, n in timed(phase, calls).items():
            totals[route] += n
    for route in COUNTED:
        if totals[route] == 0:
            fail(f"the main path never launched the {route} kernel")
    report["main_path_launches"] = totals
    timed(phase_autotune)
    timed(phase_calibrate)
    timed(phase_lm)
    timed(phase_train)
    timed(phase_moe)
    timed(phase_moe_train)
    timed(phase_ssm)
    timed(phase_encdec_vlm)
    timed(phase_mesh)
    timed(phase_path_calls, calls)
    report["seconds"] = time.perf_counter() - t0
    log(f"phase seconds: {json.dumps(report['phase_seconds'])}")
    kernels = _kernel_rows(report, totals)
    args.report.parent.mkdir(parents=True, exist_ok=True)
    args.report.write_text(json.dumps(report, indent=1, default=str))
    log(f"total {report['seconds']:.1f} s; report in {args.report}")
    log(report["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

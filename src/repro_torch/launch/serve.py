"""Serving driver — the port's counterpart of ``repro.launch.serve``:
greedy token generation through a KV-cached decoder (always first), then
optionally the coded matmul plane (``--coded``) and continuous-batching
serving over a worker pool (``--serve``), on the card unless ``--device
cpu``::

    python -m repro_torch.launch.serve --device cpu --gen-len 2
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --full
    python -m repro_torch.launch.serve --arch zamba2-7b --full
    python -m repro_torch.launch.serve --arch seamless-m4t-medium --full
    python -m repro_torch.launch.serve --coded --coded-backend pool --pool-workers 4
    python -m repro_torch.launch.serve --serve 16 --serve-batch 4 --pool-workers 8

The coded path swaps one matmul onto the CDMM plane: int8-quantized,
lifted to Z_{2^32}, EP_RMFE-I encoded across N workers, decoded from the
first R responders — bit-identical outputs under worker failures.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..cdmm import CodedQuantMatmul, ProblemSpec, coded_matmul, plan
from ..configs import ARCHS, ShapeConfig
from ..core import make_ring, sample_trace
from ..device import resolve_device
from ..kernels import gr_matmul_ref
from ..models import build_model
from ..runtime.sharding import _map_leaves, materialize

__all__ = ["batch_serving_demo", "coded_matmul_demo", "greedy_generate", "main"]


def greedy_generate(
    arch: str,
    *,
    smoke: bool = True,
    prompt_len: int = 8,
    gen_len: int = 8,
    batch: int = 2,
    seed: int = 0,
    device=None,
    params: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Greedy generation with ``arch`` (its ``.smoke()`` reduction unless
    ``smoke=False``) on ``device`` (default: the card).

    The prompt, ``batch`` x ``prompt_len`` tokens from
    ``np.random.default_rng(seed)``, is fed token by token through
    ``decode_fn`` (exercising the cache writes), then each next token is
    the argmax of the last logits.  Each step goes on with the cache
    ``decode_fn`` returned: a decoder's is its input, written in place; an
    SSM's ``conv`` and ``state`` are new tensors.  ``params`` takes a converted tree
    (``models.convert.params_from_numpy``); left at None the weights are
    ``materialize``'s draw from ``seed`` on ``device``.

    Returns ``generated`` (batch, gen_len) int32, ``config``, ``prompt``,
    ``logits`` (the last step's, on ``device``) and ``step_ms``: the time of
    each of the prompt_len + gen_len steps, from CUDA events on the card
    (recorded between steps, read once at the end), from the host clock
    on the CPU.
    """
    device = resolve_device(device)
    cfg = ARCHS[arch].smoke() if smoke else ARCHS[arch]
    api = build_model(cfg)
    if params is None:
        params = materialize(api.param_specs, seed, device)
    rng = np.random.default_rng(seed)
    cache_shape = ShapeConfig("serve", prompt_len + gen_len + 8, batch, "decode")
    cache = _map_leaves(
        lambda _, ps: torch.zeros(ps.shape, dtype=ps.dtype, device=device),
        api.cache_decl(cache_shape),
    )
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    tokens = torch.as_tensor(prompt, dtype=torch.int32).to(device)

    cuda = device.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    out_tokens = []
    with torch.inference_mode():
        mark()
        # prefill token-by-token through the decode path (exercises cache writes)
        for t in range(prompt_len):
            logits, cache = api.decode_fn(params, cache, {"tokens": tokens[:, t:t + 1]})
            mark()
        for _ in range(gen_len):
            nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out_tokens.append(nxt)
            logits, cache = api.decode_fn(params, cache, {"tokens": nxt})
            mark()
        gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    if cuda:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return {"generated": gen, "config": cfg, "prompt": prompt, "logits": logits,
            "step_ms": step_ms}


def coded_matmul_demo(
    N: int = 8, fail: int = 3, size: int = 64, seed: int = 0,
    backend: str = "local", privacy_t: int = 0, pool_workers: int = 4,
    device=None,
) -> Dict[str, Any]:
    """The paper's serving integration in one function: the planner picks a
    scheme for the problem spec, and the quantized coded matmul survives
    ``fail`` dead workers out of N bit-identically.

    ``backend``: ``"local"``, ``"elastic"`` (decodes at the R-th response
    under a randomized join/slowdown trace) or ``"pool"`` (``pool_workers``
    worker OS processes on ``device``, shut down on return).
    ``privacy_t > 0`` plans a secure family and masks with the int key
    ``seed``; the int8-quantized plane stays insecure, as in the reference.
    """
    device = resolve_device(device)
    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(
        t=size, r=size, s=size, n=1, ring=Z32, N=N, straggler_budget=fail,
        privacy_t=privacy_t,
    )
    objective = "time_to_R" if backend == "elastic" else "latency"
    p = plan(spec, objective=objective,
             schemes=["ep_rmfe1"] if privacy_t == 0 else None)
    chosen = p.best
    rng = np.random.default_rng(seed)
    mask = np.ones(N, dtype=bool)
    dead = rng.choice(N, size=fail, replace=False)
    mask[dead] = False
    tmask = torch.as_tensor(mask, device=device)

    exact = True
    if privacy_t == 0:
        cm = CodedQuantMatmul(N=N, axis_name=None, n=chosen.n, u=chosen.u,
                              v=chosen.v, w=chosen.w, device=device)
        x = torch.as_tensor(rng.standard_normal((size, size)).astype(np.float32), device=device)
        w = torch.as_tensor(rng.standard_normal((size, size)).astype(np.float32), device=device)
        y = cm(x, w, mask=tmask)
        exact = torch.equal(y.view(torch.int32), cm(x, w).view(torch.int32))

    # the same planned scheme through the pluggable backend plane: every
    # backend must match the local one bit for bit
    scheme = p.instantiate(device=device)
    key = seed if privacy_t > 0 else None
    A = scheme.base.random(rng, (size, size), device=device)
    B = scheme.base.random(rng, (size, size), device=device)
    exec_backend: Any = backend
    pool = None
    if backend == "elastic":
        from ..cdmm import ElasticBackend

        exec_backend = ElasticBackend(
            trace=sample_trace(seed, N, slowdown_prob=0.3).restrict(mask))
    elif backend == "pool":
        from ..dist import LocalPool, PoolBackend, PoolConfig

        pool = LocalPool(config=PoolConfig(workers=pool_workers), device=device)
        exec_backend = PoolBackend(pool)
    try:
        C = coded_matmul(
            A, B, scheme, backend=exec_backend,
            mask=None if backend == "elastic" else tmask, key=key,
        )
        C_sync = coded_matmul(A, B, scheme, backend="local", key=key)
    finally:
        if pool is not None:
            pool.close()  # clean shutdown: reap every worker process
    return {
        "scheme": chosen.scheme,
        "backend": backend,
        "privacy_t": privacy_t,
        "partition": (chosen.u, chosen.v, chosen.w, chosen.n),
        "R": chosen.costs.R,
        "dead_workers": sorted(int(d) for d in dead),
        "bit_identical": bool(exact and torch.equal(C, C_sync)),
    }


def batch_serving_demo(
    requests: int = 32, size: int = 64, pool_workers: int = 6,
    wait_ms: float = 50.0, target_batch: int = 8, privacy_t: int = 0,
    stats_every: float = 0.0, seed: int = 0, trace: bool = False,
    trace_out: str = "", obs_http_port: Optional[int] = None, device=None,
) -> Dict[str, Any]:
    """Continuous-batching serving in one function: ``requests`` concurrent
    same-shape matmuls through :class:`repro_torch.serve.ServeScheduler`
    over a pool of ``pool_workers`` processes the engine launches on
    ``device``, coalesced into RMFE batch codewords wherever the planner's
    ``"amortized"`` objective says one batch job beats per-request
    dispatch.  ``stats_every > 0`` prints the merged ``serve_``/``pool_``
    snapshot that often while requests run; ``trace`` returns the last
    request's merged timeline (``trace_out`` also writes it as Chrome
    ``trace_event`` JSON); ``obs_http_port`` (0 = ephemeral) serves
    ``/metrics`` ``/healthz`` ``/stats`` ``/trace/<rid>`` while requests
    run.  Every result is held against the plain version's product.
    """
    from .. import obs
    from ..dist import PoolConfig
    from ..serve import CoalescePolicy, ServeScheduler
    from ..stats import merge_snapshots

    device = resolve_device(device)
    if trace:
        obs.set_enabled(True)
    Z32 = make_ring(2, 32, ())
    spec = ProblemSpec(
        t=size, r=size, s=size, n=1, ring=Z32, N=pool_workers,
        straggler_budget=1, privacy_t=privacy_t,
    )
    rng = np.random.default_rng(seed)
    pairs = [
        (Z32.random(rng, (size, size), device=device),
         Z32.random(rng, (size, size), device=device))
        for _ in range(requests)
    ]
    policy = CoalescePolicy(target_batch_n=target_batch, max_wait_ms=wait_ms)

    def merged_stats(sched):
        # both snapshots arrive pre-prefixed (serve_* / pool_*)
        return merge_snapshots(sched.stats.snapshot(), sched.master.stats())

    timeline = None
    pool_cfg = PoolConfig(workers=pool_workers)
    if obs_http_port is not None:
        pool_cfg = pool_cfg.with_(obs_http_port=obs_http_port)
    with ServeScheduler(
        config=pool_cfg, policy=policy, max_queue=requests, seed=seed, device=device,
    ) as sched:
        if obs_http_port is not None:
            from ..obs import http as obs_http

            srv = obs_http.server()
            if srv is not None:
                print(f"obs admin plane: {srv.url}/metrics  {srv.url}/stats"
                      f"  (python -m repro_torch.obs.top --url {srv.url})")
        futs = [sched.submit(A, B, spec=spec) for A, B in pairs]
        if stats_every > 0:
            while any(not f.done() for f in futs):
                time.sleep(stats_every)
                snap = merged_stats(sched)
                print(json.dumps({
                    k: snap[k] for k in (
                        "serve_submitted", "serve_completed",
                        "serve_batches", "serve_mean_fill",
                        "serve_wait_ms_p50", "serve_wait_ms_p99",
                        "pool_completed", "pool_bytes_out",
                        "pool_raw_bytes_out", "pool_time_to_R_ms_p50",
                    )
                }))
        results = [f.result(timeout=600) for f in futs]
        snap = merged_stats(sched)
        if trace:
            timeline = sched.trace(futs[-1])
    ok = all(torch.equal(C, gr_matmul_ref(A, B, Z32)) for C, (A, B) in zip(results, pairs))
    out: Dict[str, Any] = {"bit_identical": ok, "stats": snap}
    if timeline is not None:
        out["timeline"] = timeline
        if trace_out:
            with open(trace_out, "w") as f:
                f.write(obs.to_chrome_trace(timeline, indent=1))
            print(f"wrote Chrome trace_event timeline to {trace_out} "
                  f"(load in about://tracing or ui.perfetto.dev)")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument(
        "--full", dest="smoke", action="store_false",
        help="generate with the arch as published, at its full width and depth "
        "(qwen3-moe-30b-a3b: 30.2 B bf16 parameters, zamba2-7b: 6.66 B, one H100), "
        "not its smoke reduction; as in the reference, an encoder-decoder's "
        "cross cache stays zeros and a VLM gets no patches",
    )
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--coded", action="store_true")
    ap.add_argument(
        "--coded-backend", default="local",
        choices=["local", "elastic", "pool"],
        help="execution backend for the coded matmul plane (elastic = "
        "event-driven any-R decode; pool = worker OS processes over sockets)",
    )
    ap.add_argument(
        "--pool-workers", type=int, default=4, metavar="N",
        help="worker OS processes to spawn for --coded-backend pool and --serve",
    )
    ap.add_argument(
        "--privacy-t", type=int, default=0, metavar="T",
        help="serve the coded matmul plane T-privately (secure families only)",
    )
    ap.add_argument(
        "--serve", type=int, default=0, metavar="REQUESTS",
        help="continuous-batching demo: serve this many concurrent "
        "same-shape coded matmuls through repro_torch.serve (0 = off)",
    )
    ap.add_argument(
        "--serve-batch", type=int, default=8, metavar="N",
        help="--serve policy: max batch arity the amortized planner scans",
    )
    ap.add_argument(
        "--serve-wait-ms", type=float, default=50.0, metavar="MS",
        help="--serve policy: max time a request waits for batch peers",
    )
    ap.add_argument(
        "--stats-every", type=float, default=0.0, metavar="SECONDS",
        help="print the merged serve/pool stats this often while --serve "
        "requests are in flight (0 = only the final snapshot)",
    )
    ap.add_argument(
        "--trace", action="store_true",
        help="record per-request span timelines for --serve and print the "
        "last request's",
    )
    ap.add_argument(
        "--trace-out", default="", metavar="PATH",
        help="with --trace: also write the last request's timeline as "
        "Chrome trace_event JSON",
    )
    ap.add_argument(
        "--obs-http", type=int, default=None, metavar="PORT",
        help="with --serve: expose /metrics /healthz /stats /trace/<rid> on "
        "this port while requests run (0 = ephemeral)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of the model, the engine, the master and the "
        "workers (default: the card)",
    )
    args = ap.parse_args(argv)
    t0 = time.time()
    out = greedy_generate(args.arch, smoke=args.smoke, gen_len=args.gen_len,
                          device=args.device)
    print(f"generated tokens ({time.time() - t0:.1f}s):\n{out['generated']}")
    ok = True
    if args.serve > 0:
        demo = batch_serving_demo(
            requests=args.serve, pool_workers=args.pool_workers,
            wait_ms=args.serve_wait_ms, target_batch=args.serve_batch,
            privacy_t=args.privacy_t, stats_every=args.stats_every,
            trace=args.trace, trace_out=args.trace_out,
            obs_http_port=args.obs_http, device=args.device,
        )
        s = demo["stats"]
        print(
            f"batch serving [{args.serve} requests, {args.pool_workers} "
            f"workers]: {s['serve_batches']} batch jobs, mean fill "
            f"{s['serve_mean_fill']:.2f}, bit-identical={demo['bit_identical']}"
        )
        timeline = demo.get("timeline")
        if timeline is not None:
            print(f"last request timeline [{timeline.trace_id}] "
                  f"({timeline.wall_s * 1e3:.1f} ms wall):")
            for sp in timeline.spans:
                rel = (sp.t_start - timeline.t_start) * 1e3
                wid = sp.tags.get("wid")
                lane = f" wid={wid}" if wid is not None else ""
                print(f"  +{rel:8.2f}ms {sp.component:9s} {sp.name:13s} "
                      f"{sp.duration_s * 1e3:8.2f}ms{lane}")
        print(json.dumps(s, indent=2, default=str))
        ok = ok and demo["bit_identical"]
    if args.coded:
        demo = coded_matmul_demo(backend=args.coded_backend,
                                 privacy_t=args.privacy_t,
                                 pool_workers=args.pool_workers,
                                 device=args.device)
        private = (f" T={demo['privacy_t']}-private"
                   if demo["privacy_t"] else " int8")
        print(
            f"coded{private} matmul [{demo['scheme']} via {demo['backend']} "
            f"(u,v,w,n)={demo['partition']} "
            f"R={demo['R']}] with dead workers {demo['dead_workers']}: "
            f"bit-identical={demo['bit_identical']}"
        )
        ok = ok and demo["bit_identical"]
    return 0 if ok else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())

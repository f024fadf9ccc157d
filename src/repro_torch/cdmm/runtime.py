"""Distributed CDMM runtime: the paper's master/worker protocol as SPMD over
``torch.distributed`` — counterpart of ``repro.cdmm.runtime``.

The N CDMM workers are the N ranks of a group bound to an axis name (the
reference's mesh axis).  Each rank

  1. *encodes its own point*: f(alpha_i), g(alpha_i) from the (replicated)
     operands, or, in ``master_encode`` mode, the master-side Vandermonde
     encode of all N shares (replicated, as the reference's shard body
     computes it) read at its own row;
  2. computes its block product (on the card: the ``tc`` route);
  3. all-gathers the N responses and decodes from the first R live workers
     (every rank doubles as the master).

Straggler tolerance is a mask: dead workers' responses are gathered but
never read by the any-R decode.

Two ways to get a group:

* **SPMD**: inside an existing ``torch.distributed`` group of world size N
  (e.g. under ``torchrun``), every rank calls with replicated operands;
  :func:`cdmm_shard_map` with ``world=None`` binds the default group.
* **Single process**: :class:`RankPool` makes the caller rank 0 and spawns
  N - 1 rank processes once, joined in a gloo group over
  ``tcp://127.0.0.1``; each call pickles the per-rank function to them,
  broadcasts the tensor operands from rank 0 and returns rank 0's result.
  ``close()`` shuts the ranks down.

Ranks sharing one card: NCCL refuses two ranks on one device, so the group
is gloo, and gloo's ``allgather`` and ``broadcast`` take the CUDA tensors
as they are (gloo stages them through host memory itself; checked on an
H100 by ``chip_smoke.py`` phase 12).  Every rank's encode, product and
decode run on the card.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import pickle
import traceback
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from ..core.batch_rmfe import BatchEPRMFE
from ..core.ep_codes import EPCode
from ..core.straggler import select_workers

__all__ = [
    "DistributedBatchRMFE",
    "DistributedEP",
    "RankGroup",
    "RankPool",
    "all_gather",
    "axis_group",
    "axis_index",
    "bind_axis",
    "cdmm_shard_map",
]

# collectives block at most this long before they raise (a rank that
# failed before one leaves the others waiting there)
TIMEOUT = datetime.timedelta(seconds=300)


class RankGroup:
    """This process's rank in a group of ``size`` ranks, and the group's
    collectives: a gloo process group made by :class:`RankPool` (``pg``),
    or a ``torch.distributed`` group of the default world (``group``)."""

    def __init__(self, rank: int, size: int, *, pg=None, group=None):
        self.rank, self.size = rank, size
        self._pg, self._group = pg, group

    @classmethod
    def world(cls) -> "RankGroup":
        """The default group of an initialized ``torch.distributed``."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: no default group")
        return cls(dist.get_rank(), dist.get_world_size(), group=dist.group.WORLD)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x``, in rank order."""
        x = x.contiguous()
        out = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
        outs = list(out.unbind(0))
        if self._pg is not None:
            self._pg.allgather([outs], [x]).wait()
        else:
            dist.all_gather(outs, x, group=self._group)
        return out

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` of rank ``src`` into ``x`` of every rank (in place)."""
        if self._pg is not None:
            opts = dist.BroadcastOptions()
            opts.rootRank = src
            self._pg.broadcast([x], opts).wait()
        else:
            dist.broadcast(x, src, group=self._group)
        return x


_AXES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_axes", default={})


@contextlib.contextmanager
def bind_axis(axis: str, group: RankGroup):
    """Bind ``axis`` to ``group`` for the block: the counterpart of running
    inside ``shard_map`` over a mesh axis."""
    token = _AXES.set({**_AXES.get(), axis: group})
    try:
        yield group
    finally:
        _AXES.reset(token)


def axis_group(axis: str) -> RankGroup:
    """The group bound to ``axis``; unbound, the default ``torch.distributed``
    group when one is initialized, else RuntimeError."""
    group = _AXES.get().get(axis)
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError(f"axis {axis!r} is bound to no group of ranks "
                               "(use cdmm_shard_map, or initialize torch.distributed)")
        group = RankGroup.world()
    return group


def axis_index(axis: str) -> int:
    """This rank's index on ``axis`` (``lax.axis_index``)."""
    return axis_group(axis).rank


def all_gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order (``lax.all_gather``)."""
    return axis_group(axis).all_gather(x)


# ---------------------------------------------------------------------------
# the ranks of one machine
# ---------------------------------------------------------------------------


def _broadcast_arg(x) -> bool:
    # tensors travel by broadcast from rank 0; a bool mask (N values) pickled
    return isinstance(x, torch.Tensor) and x.dtype != torch.bool


def _tensor_spec(x):
    if _broadcast_arg(x):
        return ("tensor", tuple(x.shape), x.dtype)
    return ("value", x.cpu() if isinstance(x, torch.Tensor) else x)


def _receive_args(group: RankGroup, specs, device) -> list:
    args = []
    for spec in specs:
        if spec[0] == "tensor":
            args.append(group.broadcast(torch.empty(spec[1], dtype=spec[2], device=device)))
        else:
            args.append(spec[1])
    return args


def _run_one(fn, args, axis: str, group: RankGroup, device: torch.device, trace: bool):
    """Run ``fn(*args)`` with ``axis`` bound; returns (output, report): this
    rank's launches per route and, when traced, its ``shard_map`` spans."""
    from ..kernels import counters
    from ..obs import trace as obs

    before = dict(counters.launches_by_route)
    prev, t0 = obs._enabled_override, obs.now()
    if trace:
        obs.set_enabled(True)
    try:
        with bind_axis(axis, group):
            out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        obs.set_enabled(prev)
    report = {"rank": group.rank, "pid": os.getpid(),
              "launches": {k: v - before.get(k, 0) for k, v in counters.launches_by_route.items()}}
    if trace:
        report["spans"] = obs.spans_to_wire(
            s for s in list(obs.tracer()._spans) if s.component == "shard_map" and s.t_start >= t0)
    return out, report


def _rank_main(rank: int, size: int, port: int, device: str, conn) -> None:
    """A spawned rank: join the gloo group, then run what rank 0 sends."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # N ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    store = dist.TCPStore("127.0.0.1", port, size, False, timeout=TIMEOUT)
    group = RankGroup(rank, size, pg=dist.ProcessGroupGloo(store, rank, size, TIMEOUT))
    while True:
        msg = pickle.loads(conn.recv_bytes())
        if msg[0] == "stop":
            break
        _, fn, specs, axis, trace = msg
        try:
            args = _receive_args(group, specs, dev)
            _, report = _run_one(fn, args, axis, group, dev, trace)
            conn.send_bytes(pickle.dumps(("ok", report)))
        except Exception:  # reported to rank 0, which raises it
            conn.send_bytes(pickle.dumps(("err", f"rank {rank}:\n{traceback.format_exc()}")))
    conn.close()


class RankPool:
    """N ranks on this machine for the single-process use: the caller is
    rank 0 and N - 1 spawned processes are the others, all on ``device``
    (None: the card), joined in one gloo group.  Spawned once; ``close()``
    (or leaving a ``with`` block) stops them.  ``trace``: every call records
    the ranks' ``shard_map`` spans into ``last_reports``."""

    def __init__(self, size: int, device=None, trace: bool = False):
        import multiprocessing as mp

        from ..device import resolve_device

        if size < 1:
            raise ValueError(f"a pool needs at least one rank, got {size}")
        self.size, self.trace = size, trace
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the ranks load the kernel library; build it once, before them
            from ..kernels.build import load_library

            load_library()
        self._store = dist.TCPStore("127.0.0.1", 0, size, True, timeout=TIMEOUT,
                                     wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for rank in range(1, size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(target=_rank_main, daemon=True, name=f"cdmm-rank-{rank}",
                                   args=(rank, size, self._store.port, str(self.device), child))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self.group = RankGroup(0, size, pg=dist.ProcessGroupGloo(self._store, 0, size, TIMEOUT))
        except BaseException:
            self.close()
            raise
        self.last_reports: List[Dict] = []

    def run(self, fn: Callable, *args, axis: str = "workers"):
        """``fn(*args)`` on every rank with ``axis`` bound to the group; the
        tensor arguments are rank 0's, broadcast to the others, the rest
        travel pickled with ``fn``.  Returns rank 0's output; every rank's
        launches per route (and spans, with ``trace``) are in
        ``last_reports``.  Raises RuntimeError if a rank failed."""
        if self.group is None:
            raise RuntimeError("the rank pool is closed")
        trace = self.trace
        specs = [_tensor_spec(a) for a in args]
        msg = pickle.dumps(("run", fn, specs, axis, trace))
        for conn in self._conns:
            conn.send_bytes(msg)
        err = None
        out = report0 = None
        try:
            for a in args:
                if _broadcast_arg(a):
                    self.group.broadcast(a.contiguous())
            out, report0 = _run_one(fn, list(args), axis, self.group, self.device, trace)
        except Exception:
            err = f"rank 0:\n{traceback.format_exc()}"
        reports = [report0]
        for conn in self._conns:
            status, payload = pickle.loads(conn.recv_bytes())
            if status == "ok":
                reports.append(payload)
            else:
                err = err or payload
        if err is not None:
            raise RuntimeError(f"a rank failed: {err}")
        self.last_reports = reports
        return out

    def close(self) -> None:
        """Stop the ranks (idempotent)."""
        for conn in self._conns:
            with contextlib.suppress(OSError, ValueError):
                conn.send_bytes(pickle.dumps(("stop",)))
        for proc in self._procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        self.group = None
        self._store = None

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def cdmm_shard_map(fn: Callable, world: Union[None, RankPool, RankGroup], axis_name: str):
    """Wrap a per-rank CDMM body into a call over a group of ranks with
    replicated operands (the counterpart of ``shard_map`` with replicated
    in/out specs: CDMM's redundancy is in the computation).

    ``world``: None binds the default ``torch.distributed`` group (SPMD:
    every rank calls the result with the same operands); a
    :class:`RankGroup` binds that group (SPMD too); a :class:`RankPool`
    runs ``fn`` on its ranks from this process, which passes the operands
    (``fn`` must then pickle: a module-level function, a bound method, or
    an object such as :class:`DistributedEP`).
    """

    def mapped(*args):
        if isinstance(world, RankPool):
            return world.run(fn, *args, axis=axis_name)
        with bind_axis(axis_name, world if world is not None else RankGroup.world()):
            return fn(*args)

    return mapped


# ---------------------------------------------------------------------------
# SPMD bodies of the core codes
# ---------------------------------------------------------------------------


class DistributedEP:
    """SPMD execution of one :class:`EPCode` over an axis of N ranks."""

    def __init__(self, code: EPCode, axis_name: str, *, use_kernel: Optional[bool] = None,
                 master_encode: bool = False):
        if use_kernel is False and code.device.type == "cuda":
            raise ValueError("use_kernel=False on the card; the kernel is the only path of a "
                             "ring matmul there (run on the CPU for the plain version)")
        self.code = code
        self.axis = axis_name
        self.use_kernel = use_kernel
        self.master_encode = master_encode

    def worker_body(self, A: torch.Tensor, B: torch.Tensor, mask) -> torch.Tensor:
        """A (t, r, D), B (r, s, D), mask (N,) replicated -> C (t, s, D) on
        every rank: encode at this rank's point, its block product, the
        gather and the any-R decode."""
        code = self.code
        i = axis_index(self.axis)
        fa = code.encode_a_at(A, i)
        gb = code.encode_b_at(B, i)
        return self._finish(fa, gb, mask)

    def master_encode_body(self, A: torch.Tensor, B: torch.Tensor, mask) -> torch.Tensor:
        """The master-side Vandermonde encode of all N shares (one matmul
        per operand, replicated as in the reference), read at this rank's
        row; then as :meth:`worker_body`."""
        code = self.code
        i = axis_index(self.axis)
        return self._finish(code.encode_a(A)[i], code.encode_b(B)[i], mask)

    def _finish(self, fa, gb, mask) -> torch.Tensor:
        code = self.code
        h = code.worker_compute(fa[None], gb[None])[0]
        H = all_gather(h, self.axis)  # (N, tb, sb, D)
        idx = _live(mask, code.N, code.R, code.device)
        return code.decode(H.index_select(0, idx), idx)

    def __call__(self, A, B, mask=None):
        if self.master_encode:
            return self.master_encode_body(A, B, mask)
        return self.worker_body(A, B, mask)


def _live(mask, N: int, R: int, device) -> torch.Tensor:
    if mask is None:
        return torch.arange(R, device=device)
    return select_workers(torch.as_tensor(mask, dtype=torch.bool, device=device), R)


class DistributedBatchRMFE:
    """SPMD Batch-EP_RMFE: pack (replicated) -> DistributedEP -> unpack."""

    def __init__(self, scheme: BatchEPRMFE, axis_name: str, **kw):
        self.scheme = scheme
        self.dep = DistributedEP(scheme.code, axis_name, **kw)

    def __call__(self, As: torch.Tensor, Bs: torch.Tensor, mask=None) -> torch.Tensor:
        """As, Bs: (n, t, r, D0) / (n, r, s, D0) replicated -> (n, t, s, D0)."""
        C = self.dep(self.scheme.pack(As), self.scheme.pack(Bs), mask)
        return self.scheme.unpack(C)

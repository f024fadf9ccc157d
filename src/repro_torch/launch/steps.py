"""Cells and their step functions — counterpart of ``repro.launch.steps``.

A "cell" is (architecture, input shape); this module turns a cell into its
step function plus the ParamSpec trees of its arguments.  The train step
takes gradients of ``loss_fn`` with ``torch.autograd`` (:func:`value_and_grad`)
and writes the new parameters and optimizer state into the tensors it was
given, the port's counterpart of the reference's donated arguments.

Under a mesh, ``rules_for`` gives a cell's logical->physical overrides (the
reference's, as it is), ``cell_structs`` its arguments' fake DTensor
stand-ins, and ``lower_cell`` runs its step once on them under
``FakeTensorMode`` and records what the dry-run needs (FLOPs, collectives,
argument and peak bytes a rank): the counterpart of
``jit(...).lower(...).compile()`` with ``cost_analysis`` and
``memory_analysis``.  Nothing is allocated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ModelConfig, ShapeConfig
from ..models import ModelAPI, build_model
from ..optim import OptConfig, opt_state_specs, opt_update
from ..optim.optimizers import _div, _leaves, _zip_map
from ..runtime.sharding import axis_rules, shape_structs

__all__ = [
    "Cell", "LoweredCell", "build_cell", "cell_structs", "lower_cell", "opt_config_for",
    "recording", "rules_for", "value_and_grad",
]


def rules_for(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16) -> Dict[str, Any]:
    """Per-cell logical->physical overrides on top of DEFAULT_RULES — the
    reference's ``rules_for`` as it is (its perf-iteration notes are the
    reference's):

      * heads and kv heads divisible by tp  -> pure head-TP
      * heads divisible, kv not             -> head-TP with replicated KV
      * heads not divisible                 -> sequence-parallel attention:
        Q sharded over seq/model, K/V gathered
    """
    rules: Dict[str, Any] = {"fsdp": cfg.fsdp_axes if len(cfg.fsdp_axes) > 1 else cfg.fsdp_axes[0]}
    if shape.kind in ("train", "prefill") and shape.seq_len % tp == 0:
        # Megatron-SP residual layout; with the all-to-all EP island the SP
        # layout wins everywhere
        rules["residual_seq"] = "model"
    heads_ok = cfg.num_heads and cfg.num_heads % tp == 0
    kv_ok = cfg.num_kv_heads and cfg.num_kv_heads % tp == 0
    if cfg.num_heads:
        kv_dim = cfg.num_kv_heads * cfg.hd
        small_kv = kv_dim * 2 <= cfg.d_model // 2  # GQA: K/V much smaller than x
        if not heads_ok or (shape.kind != "decode" and small_kv):
            # context-parallel attention: Q stays seq-sharded, K/V gathered
            rules["heads"] = None
            rules["kv_heads"] = None
            if shape.kind != "decode":
                rules["q_seq"] = "model"
                rules["residual_seq"] = "model"
        elif not kv_ok:
            rules["kv_heads"] = None  # replicate K/V heads (small for GQA)
    if shape.kind == "decode":
        # split-K decode: KV-cache sequence sharded over model (and data for
        # the 500k single-request cell, where batch can't shard); weights
        # stay resident (model-sharded only) whenever they fit
        rules["cache_seq"] = ("data", "model") if shape.global_batch == 1 else "model"
        from .costmodel import _param_counts

        pbytes = _param_counts(cfg)["total"] * 2.0
        if pbytes / tp <= 12 * 2**30:
            rules["fsdp"] = None
    if shape.kind in ("train", "prefill") and shape.seq_len >= 262144:
        rules["seq"] = "data"  # context parallelism for very long sequences
    return rules


def opt_config_for(cfg: ModelConfig, total_steps: int = 10_000) -> OptConfig:
    return OptConfig(
        name=cfg.optimizer,
        state_dtype=cfg.opt_state_dtype,
        total_steps=total_steps,
    )


def value_and_grad(loss_fn: Callable, params: Dict, batch: Dict) -> Tuple[Tuple, Dict]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``:
    ``((loss, metrics), grads)`` with ``grads`` a tree like ``params``, each
    leaf in its parameter's dtype (and, for DTensors, placements).  The
    parameters are taken through detached aliases (no copy), so the
    caller's tensors keep their flags and no ``.grad`` is written; the loss
    and metrics come back detached."""
    leaves = _zip_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        flat = _leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    by_id = {id(p): _like_param(g, p) for p, g in zip(flat, grads)}
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return (loss.detach(), metrics), _zip_map(lambda p: by_id[id(p)].detach(), leaves)


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (partial sums
    reduced), as GSPMD shards a gradient like its parameter."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeConfig
    api: ModelAPI
    step_fn: Any            # the step: train_step, prefill_step or serve_step
    arg_specs: Tuple        # ParamSpec trees, one per argument
    donate: Tuple[int, ...]  # the arguments the step writes in place


def build_cell(cfg: ModelConfig, shape: ShapeConfig) -> Cell:
    api = build_model(cfg)
    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        A = max(1, cfg.grad_accum)

        def train_step(params, opt_state, batch):
            if A == 1:
                (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
            else:
                # A micro-batches summed in the parameters' dtype, as the
                # reference's scan does
                gsum = _zip_map(torch.zeros_like, params)
                lsum = torch.zeros((), dtype=torch.float32, device=_leaves(params)[0].device)
                for a in range(A):
                    mb = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])[a]
                          for k, v in batch.items()}
                    (l, _), g = value_and_grad(api.loss_fn, params, mb)
                    gsum = _zip_map(lambda acc, x: acc + x.to(acc.dtype), gsum, g)
                    lsum = lsum + l
                grads = _zip_map(lambda g: _div(g, A), gsum)
                loss = _div(lsum, A)
            new_params, new_state, om = opt_update(ocfg, grads, opt_state, params)
            return new_params, new_state, dict(loss=loss, **om)

        ostate = opt_state_specs(ocfg, api.param_specs)
        return Cell(
            cfg, shape, api, train_step,
            (api.param_specs, ostate, api.batch_specs(shape)),
            donate=(0, 1),
        )
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return api.prefill_fn(params, batch)

        return Cell(cfg, shape, api, prefill_step,
                    (api.param_specs, api.batch_specs(shape)), donate=())

    # decode: the cache is written in place
    def serve_step(params, cache, batch):
        return api.decode_fn(params, cache, batch)

    return Cell(
        cfg, shape, api, serve_step,
        (api.param_specs, api.cache_decl(shape), api.batch_specs(shape)),
        donate=(1,),
    )


# ---------------------------------------------------------------------------
# the dry-run's lowering: one fake execution of the step on the mesh
# ---------------------------------------------------------------------------


def cell_structs(cell: Cell, mesh, fake_mode=None):
    """Fake DTensor stand-ins (``shape_structs``) for every step argument,
    placed per the cell's ``rules_for``; no allocation."""
    rules = rules_for(cell.cfg, cell.shape)
    return tuple(shape_structs(t, mesh, rules, fake_mode=fake_mode) for t in cell.arg_specs)


@dataclasses.dataclass
class LoweredCell:
    """What one fake run of a cell's step records, a rank's view of it."""

    flops: float                       # local ops' FLOPs (FlopCounterMode's rules)
    bytes_accessed: float              # local ops' operand and result bytes (views not counted)
    collectives: Dict[str, Dict[str, float]]  # kind -> {"count", "bytes"} (result bytes)
    argument_bytes: int                # the arguments' local shards
    argument_bytes_by_arg: Tuple[int, ...]  # the same, argument by argument
    peak_bytes: int                    # high-water of live local bytes, arguments included
    seconds: float                     # the fake run's host seconds


_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _local_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local_leaves(v)]
    if torch.is_tensor(tree):
        return [tree._local_tensor if isinstance(tree, DTensor) else tree]
    return []


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class _Recorder(TorchDispatchMode):
    """A dispatch mode over the local ops of a run: it lets DTensor
    desugar first (``NotImplemented`` for DTensor types), skips DTensor's
    own shape propagation (global-shape ops, flagged by
    ``_marking_propagation``), and counts
    FLOPs (``torch.utils.flop_counter``'s registry), bytes accessed (the
    operands and results of every op that is not a view), collectives (the
    ``_c10d_functional`` ops: count and result bytes) and the high-water
    of live bytes (each new storage counted until its last tensor dies).

    On a real run with the card in use, every collective (its issue or its
    wait) starts after a ``torch.cuda.synchronize()``: ``sync_s`` is the
    host time those syncs take (device work queued before the collective)
    and ``comm_s`` the host time inside the collective calls after them
    (the transport, and the wait for the other ranks to arrive)."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.propagating = 0
        self.track_memory = True
        self.comm_s = 0.0
        self.sync_s = 0.0
        self.coll: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def hold(self, t: torch.Tensor) -> None:
        import weakref

        key = _storage_key(t)
        if key in self._seen:
            self._seen[key] += 1
        else:
            self._seen[key] = 1
            self.live += t.untyped_storage().nbytes()
            self.peak = max(self.peak, self.live)
        nbytes = t.untyped_storage().nbytes()
        weakref.finalize(t, self._drop, key, nbytes)

    def _drop(self, key, nbytes):
        n = self._seen.get(key, 0) - 1
        if n <= 0:
            self._seen.pop(key, None)
            self.live -= nbytes
        else:
            self._seen[key] = n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ns, name = func.namespace, func._overloadpacket.__name__
        ns = "_c10d_functional" if ns == "_c10d_functional_autograd" else ns
        comm = ns == "_c10d_functional"  # a collective's issue or its wait
        if comm and name == "wait_tensor" and self.fake_mode:
            return args[0]  # the fake wait makes a new tensor; a real one does not
        if comm and self.fake_mode is None and torch.cuda.is_initialized():
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            self.sync_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        if comm:
            self.comm_s += time.perf_counter() - t0
        if self.propagating or active_fake_mode() is not self.fake_mode:
            return out  # DTensor's global-shape propagation, not a rank's work
        if comm and name in _COLLECTIVE_KINDS:
            rec = self.coll.setdefault(_COLLECTIVE_KINDS[name], {"count": 0, "bytes": 0.0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size()
                                for t in tree_leaves(out) if torch.is_tensor(t))
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not func.is_view:  # XLA's "bytes accessed": operands and results
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if torch.is_tensor(t))
        if self.track_memory:
            for t in tree_leaves(out):
                if (torch.is_tensor(t) and not isinstance(t, DTensor)
                        and t.device.type != "meta"):
                    self.hold(t)
        return out


@contextlib.contextmanager
def _marking_propagation(rec):
    """Flag ``rec`` while DTensor derives an op's output metadata
    (``ShardingPropagator._propagate_tensor_meta_non_cached``): it runs the
    op on global-shape fake tensors under the caller's own fake mode, work
    no rank does."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:
        yield
        return
    exact = getattr(ShardingPropagator, "_propagate_tensor_meta_non_cached", None)
    if exact is None:
        yield
        return

    def marked(self, *args, **kwargs):
        rec.propagating += 1
        try:
            return exact(self, *args, **kwargs)
        finally:
            rec.propagating -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = exact


@contextlib.contextmanager
def recording(fake_mode=None, memory: bool = True):
    """Count a rank's local ops inside the block: yields the recorder,
    whose ``flops``, ``bytes``, ``coll`` (kind -> count and result bytes),
    ``sync_s`` and ``comm_s`` (host seconds in the device syncs before the
    collectives and inside the collectives after them) and,
    with ``memory``, ``peak`` (live bytes of the tensors made inside) are
    read after.  ``fake_mode`` is the dry-run's; None counts a real
    run."""
    rec = _Recorder(fake_mode)
    rec.track_memory = memory
    with _marking_propagation(rec), rec:
        yield rec


def lower_cell(cell: Cell, mesh) -> LoweredCell:
    """Run the cell's step once on ``cell_structs`` stand-ins under
    ``FakeTensorMode``, inside ``axis_rules(mesh, rules_for(...))``, and
    record a rank's FLOPs, collectives, argument bytes and peak live bytes
    (``_Recorder``): the counterpart of ``jit(...).lower(...).compile()``
    with ``cost_analysis``/``memory_analysis``.  Nothing is allocated: the
    mesh's process group is the caller's (the dry-run's ``"fake"`` one),
    and every loop iteration runs, so the counts are whole (no trip count
    to recover).  A decode step's cache holds ``seq_len - 1`` tokens."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rules = rules_for(cell.cfg, cell.shape)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    structs = list(cell_structs(cell, mesh, fake_mode=fake))
    if cell.shape.kind == "decode":
        structs[1] = {**structs[1], "len": cell.shape.seq_len - 1}
    rec = _Recorder(fake)
    by_arg = []
    for arg in structs:
        before = rec.live
        for t in _local_leaves(arg):
            rec.hold(t)
        by_arg.append(rec.live - before)
    arg_bytes = rec.live
    t0 = time.perf_counter()
    with fake, _marking_propagation(rec), axis_rules(mesh, rules), rec:
        if cell.shape.kind == "train":
            cell.step_fn(*structs)
        else:
            with torch.no_grad():
                cell.step_fn(*structs)
    return LoweredCell(flops=float(rec.flops), bytes_accessed=float(rec.bytes),
                       collectives=rec.coll, argument_bytes=int(arg_bytes),
                       argument_bytes_by_arg=tuple(int(b) for b in by_arg),
                       peak_bytes=int(rec.peak), seconds=time.perf_counter() - t0)

"""Logical-axis sharding for the LM plane — counterpart of
``repro.runtime.sharding``.

Model code annotates tensors with *logical* axis names; a rules table maps
them to the axes of a ``torch.distributed.device_mesh.DeviceMesh``.
``spec_for`` gives the reference's ``PartitionSpec`` entries as a tuple
(``None``, an axis name, or a tuple of names), dropping trailing mesh axes
until the dimension divides (the replication fallback), and
``placements_for`` turns such a tuple into DTensor placements.  Under an
``axis_rules(mesh, rules)`` block, parameters, optimizer state and batches
are DTensors (``distribute_tree``), the counterpart of GSPMD's
``NamedSharding``s: ``shard(x, *logical)`` redistributes a DTensor to its
logical layout (GSPMD's sharding constraint), plain tensors that meet
DTensors count as replicated, and outside a mesh ``shard`` is the identity.

Params are declared as ``ParamSpec`` trees (shape, logical axes, init):
nested dicts whose leaves are specs, walked in the reference's order, so
the same declaration yields real tensors (``materialize``), the placements
tree (``sharding_tree``) and fake DTensor stand-ins for the dry-run
(``shape_structs``, no allocation).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.galois import fold_in
from ..device import resolve_device

__all__ = [
    "DEFAULT_RULES", "PIECEWISE_BYTES", "ParamSpec", "axis_rules", "current_mesh",
    "distribute_tree", "entry_axes", "full_tree", "materialize", "mesh_sizes", "param_bytes",
    "param_count",
    "placements_for", "replicate_like", "shape_structs", "shard", "shard_map", "sharding_tree",
    "spec_for", "spec_of",
]

# a leaf whose float32 draw would take more bytes than this is drawn one
# leading slice at a time: qwen3-moe-30b-a3b's stacked experts are 38.7 GB
# each in float32 (48 slices of 805 MB), while every gemma2-2b leaf, the
# largest its 2.36 GB embedding, is drawn whole
PIECEWISE_BYTES = 4 << 30


# ---------------------------------------------------------------------------
# rules + context
# ---------------------------------------------------------------------------

# default logical->physical rules; None = replicated
DEFAULT_RULES: Dict[str, Union[None, str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,                # set to "model" for context-parallel shapes
    "q_seq": None,              # attention-internal query-seq layout
    "residual_seq": None,       # residual-stream seq layout (Megatron-SP)
    "kv_seq": None,             # attention-internal key/value-seq layout
    "cache_seq": None,          # decode KV-cache sequence axis
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",             # flattened head*dim projections
    "ffn": "model",
    "experts": "model",
    "expert_ffn": None,
    "vocab": "model",
    "fsdp": "data",             # weight "row" dim when FSDP is on
    "frontend": None,
    "conv": None,
    "state": None,              # SSM state dim
    "ssm_heads": "model",
}


class _Ctx:
    """The active mesh and rules.  Process-wide, not thread-local as the
    reference's: on the card autograd runs the backward (and a remat unit's
    recompute, which routes its MoE layers again) on a thread of its own,
    which must see the mesh the forward saw."""

    def __init__(self):
        self.mesh = None
        self.rules: Dict[str, Any] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, Any]] = None):
    """Activate sharding annotations inside the block (no-op mesh=None).

    Under a ``DeviceMesh`` the block also runs under DTensor's
    ``implicit_replication``: a plain tensor that meets a DTensor (a
    position ramp, a mask, a zero accumulator) counts as replicated, as an
    unannotated constant does under GSPMD; and on the card under
    ``collectives.host_staging``, gloo's transport for its all-gathers.
    It also installs ``_agreeing_pointwise`` (once, process-wide)."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.rules = merged
    try:
        if mesh is not None and hasattr(mesh, "mesh_dim_names"):
            from torch.distributed.tensor.experimental import implicit_replication

            from .collectives import host_staging

            _agreeing_pointwise()
            with implicit_replication(), host_staging(mesh):
                yield
        else:
            yield
    finally:
        _CTX.mesh, _CTX.rules = old


def _agreeing_pointwise() -> None:
    """Answer DTensor's sharding question for a pointwise op directly when
    its operands' splits agree, as torch 2.11's ``pointwise_strategy`` did.

    From torch 2.12 DTensor expands a pointwise op's one-mesh-dim rules to
    every combination over the mesh's dims and prices each, some 10^3
    candidates an op on a 3-axis mesh (~0.3 s an op the first time it meets
    a shape).  Where no operand holds a partial sum and each mesh dim
    splits at most one output dim (of the same size in every operand that
    splits it), the cheapest layout is that split, with an operand
    replicated on the dim (or broadcast along it) sliced locally; an
    in-place op must keep its own layout.  Those cases get that one
    strategy; every other case, and older torch, keeps DTensor's own."""
    try:
        import torch.distributed.tensor._sharding_prop as sp
        from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
        from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
        from torch.distributed.tensor.placement_types import Replicate, Shard
    except ImportError:
        return
    expand = getattr(sp, "_expand_single_dim_strategy_to_mesh", None)
    if expand is None or getattr(expand, "agreeing_pointwise", False):
        return

    def layout(op, mesh, args, kwargs, out_meta):
        if (torch.Tag.pointwise not in op.tags or not isinstance(out_meta, TensorMeta)
                or any(isinstance(a, OpStrategy) for a in kwargs.values())):
            return None
        ins = [a for a in args if isinstance(a, OpStrategy)]
        if not ins or any(len(a.strategies) != 1 for a in ins):
            return None
        specs = [a.strategies[0].output_spec for a in ins]
        shape = tuple(out_meta.shape)
        out_pl = []
        for m in range(mesh.ndim):
            split = None
            for sp_ in specs:
                q = sp_.placements[m]
                if type(q) is Shard:
                    d = q.dim + len(shape) - sp_.ndim  # the output's dim
                    if sp_.shape[q.dim] != shape[d] or split not in (None, d):
                        return None
                    split = d
                elif type(q) is not Replicate:
                    return None
            out_pl.append(Replicate() if split is None else Shard(split))
        inplace = op.name().split("::")[1].split(".")[0].endswith("_")
        if inplace and tuple(out_pl) != tuple(specs[0].placements):
            return None
        in_specs = []
        for sp_ in specs:
            lead = len(shape) - sp_.ndim
            pl = [Shard(q.dim - lead) if isinstance(q, Shard) and q.dim >= lead
                  and sp_.shape[q.dim - lead] == shape[q.dim] else Replicate() for q in out_pl]
            in_specs.append(DTensorSpec(mesh, tuple(pl), tensor_meta=sp_.tensor_meta))
        return OpStrategy([OpSpec(output_specs=DTensorSpec(mesh, tuple(out_pl),
                                                           tensor_meta=out_meta),
                                  input_specs=in_specs,
                                  redistribute_cost=[[0.0] for _ in in_specs])])

    def agreeing(mesh, op_schema, strategy_info, out_meta):
        strategy = layout(op_schema.op, mesh, op_schema.args_schema, op_schema.kwargs_schema,
                          out_meta)
        if strategy is None:
            return expand(mesh, op_schema, strategy_info, out_meta)
        return lambda *_: strategy

    agreeing.agreeing_pointwise = True
    sp._expand_single_dim_strategy_to_mesh = agreeing


def current_mesh():
    return _CTX.mesh


def current_rules() -> Dict[str, Any]:
    return _CTX.rules


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object whose
    ``.shape`` is already such a dict, as a JAX ``Mesh``'s is)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in shape)))


def _axes_of(name: Optional[str], rules) -> Tuple[str, ...]:
    if name is None:
        return ()
    rule = rules.get(name, None)
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def spec_for(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh=None,
    rules: Optional[Dict[str, Any]] = None,
) -> Tuple:
    """The reference's PartitionSpec for ``shape`` under logical names, as a
    tuple of entries, with its divisibility fallback (drop trailing mesh
    axes until the dim divides); a mesh axis is used by one dim at most."""
    mesh = mesh if mesh is not None else _CTX.mesh
    rules = rules if rules is not None else _CTX.rules
    if mesh is None:
        return (None,) * len(shape)
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical {tuple(logical)} differ in rank")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axes = [a for a in _axes_of(name, rules) if a in sizes and a not in used]
        # shrink until divisible
        while axes:
            total = int(np.prod([sizes[a] for a in axes]))
            if dim % total == 0:
                break
            axes = axes[:-1]
        if axes:
            used.update(axes)
            out.append(tuple(axes) if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    return tuple(out)


def placements_for(spec: Tuple, mesh) -> Tuple:
    """DTensor placements of a ``spec_for`` tuple: ``Shard(dim)`` on every
    mesh axis the dim's entry names, ``Replicate()`` on the others.  A dim
    split over several axes (``("pod", "data")``) is split in the mesh's
    axis order, pod outermost, as a PartitionSpec splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def spec_of(t) -> Optional[Tuple]:
    """A DTensor's layout as ``spec_for`` entries (each dim's mesh axes in
    the mesh's order), or None where it holds a partial sum."""
    from torch.distributed.tensor import Shard

    names = list(t.device_mesh.mesh_dim_names)
    axes: list = [[] for _ in range(t.ndim)]
    for m, q in enumerate(t.placements):
        if q.is_partial():
            return None
        if isinstance(q, Shard):
            axes[q.dim].append(names[m])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a) for a in axes)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one ``spec_for`` entry."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Tuple, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of ``shape`` under ``spec``."""
    sizes = mesh_sizes(mesh)
    return tuple(dim // int(np.prod([sizes[a] for a in entry_axes(entry)]))
                 for dim, entry in zip(shape, spec))


def contiguous_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    """A contiguous tensor's strides for ``shape``."""
    out, n = [], 1
    for dim in reversed(tuple(shape)):
        out.append(n)
        n *= max(int(dim), 1)
    return tuple(reversed(out))


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor every rank holds whole, as a replicated DTensor
    on ``ref``'s mesh when ``ref`` is a DTensor (so that ``shard`` can
    split it without a copy); else ``t`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                                  run_check=False)
    return t


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Sharding constraint by logical names: under an ``axis_rules`` mesh a
    DTensor is redistributed to the placements ``spec_for`` gives (a
    partial sum is reduced, a dim gathered or split); a plain tensor, or
    any tensor outside a mesh, is returned as it is."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements_for(spec_for(x.shape, logical, mesh, _CTX.rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical {self.logical} differ in rank")


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _map_leaves(fn: Callable[[Tuple[str, ...], Any], Any], tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _path_seed(seed: int, path: Tuple[str, ...]) -> int:
    """The leaf's generator seed: ``fold_in(seed, h)`` with the reference's
    md5 hash ``h`` of the ``/``-joined path."""
    h = int.from_bytes(hashlib.md5("/".join(path).encode()).digest()[:4], "little")
    return fold_in(seed, h)


def materialize(spec_tree, seed: int, device=None):
    """Instantiate real tensors on ``device`` (default: the card).

    Each ``normal``/``embed`` leaf draws from its own ``torch.Generator`` on
    ``device``, seeded from ``seed`` and the leaf's path.  The distribution
    is the reference's, with its std rule kept as it is: ``scale /
    sqrt(shape[0])``, which for a stacked (U, d, n) leaf is 1/sqrt(U), not
    1/sqrt(d).  The bits are not threefry's, and CPU and CUDA streams differ.

    A leaf whose float32 draw would exceed ``PIECEWISE_BYTES`` is drawn one
    leading slice at a time into the output (slice i from a generator
    seeded ``fold_in(leaf seed, i)``, again by slices if one is still too
    large), so no float32 temporary is larger than a slice.
    """
    device = resolve_device(device)

    def draw(shape, gseed: int, std: float, dtype, out=None):
        if 4 * int(np.prod(shape)) > PIECEWISE_BYTES and len(shape) > 1:
            if out is None:
                out = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                draw(shape[1:], fold_in(gseed, i), std, dtype, out[i])
            return out
        g = torch.Generator(device=device)
        g.manual_seed(gseed)
        x = torch.randn(shape, generator=g, dtype=torch.float32, device=device).mul_(std)
        return x.to(dtype) if out is None else out.copy_(x)

    def init_one(path, ps: ParamSpec):
        if ps.init == "zeros":
            return torch.zeros(ps.shape, dtype=ps.dtype, device=device)
        if ps.init == "ones":
            return torch.ones(ps.shape, dtype=ps.dtype, device=device)
        fan_in = ps.shape[0] if len(ps.shape) >= 1 else 1
        std = ps.scale / np.sqrt(max(fan_in, 1))
        if ps.init == "embed":
            std = ps.scale
        return draw(ps.shape, _path_seed(seed, path), float(std), ps.dtype)

    return _map_leaves(init_one, spec_tree)


def param_count(spec_tree) -> int:
    return sum(int(np.prod(ps.shape)) for _, ps in _leaf_paths(spec_tree))


def param_bytes(spec_tree) -> int:
    return sum(int(np.prod(ps.shape)) * ps.dtype.itemsize for _, ps in _leaf_paths(spec_tree))


def _as_dtensor(t, mesh):
    """A DTensor as it is; a plain tensor as the full value, replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor) or not torch.is_tensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _grad_placements(pl):
    """An island input's gradient placements: the input's, with every
    replicated mesh axis partial (each rank's gradient is its summand)."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if isinstance(q, Replicate) else q for q in pl)


def shard_map(mesh, body, out_specs, args, in_specs=None, replicated=False, split_axes=None):
    """The reference's ``shard_map(body, mesh, in_specs, out_specs)(*args)``
    as a ``local_map``: ``args`` may nest dicts, lists and tuples; tensor arguments
    (``spec_for`` tuples in ``in_specs``, None for replicated) are
    redistributed to their specs' placements (plain ones
    taken as replicated) and ``body`` runs on the local shards; each
    output is a DTensor with its spec's placements.  With ``replicated``
    every tensor argument is gathered whole and every rank computes the
    same result (input gradients then replicated too); else each input's
    gradient is partial over the axes it is replicated on."""
    from torch.distributed.tensor.experimental import local_map

    flat = []

    class Arg(int):  # a tensor argument's place in ``flat``
        pass

    def walk(t, spec):
        if isinstance(t, dict):
            return {k: walk(v, None if spec is None else spec[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, None if spec is None else spec[i]) for i, v in enumerate(t))
        if torch.is_tensor(t):
            flat.append((t, spec))
            return Arg(len(flat) - 1)
        return t

    skel = [walk(a, None if in_specs is None else in_specs[i]) for i, a in enumerate(args)]
    tensors = [_as_dtensor(t, mesh) for t, _ in flat]
    in_pl = tuple(placements_for((None,) * t.ndim if sp is None else sp, mesh)
                  for t, (_, sp) in zip(tensors, flat))
    names = list(mesh.mesh_dim_names)
    split = set(names if split_axes is None else split_axes)
    grad_pl = in_pl if replicated else tuple(
        tuple(_grad_placements([q])[0] if names[m] in split else q for m, q in enumerate(pl))
        for pl in in_pl)
    out_pl = tuple(placements_for(sp, mesh) if sp is not None else
                   placements_for((), mesh) for sp in out_specs)

    def rebuild(node, locs):
        if isinstance(node, dict):
            return {k: rebuild(v, locs) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, locs) for v in node)
        if isinstance(node, Arg):
            return locs[node]
        return node

    def local(*locs):
        return body(*[rebuild(n, locs) for n in skel])

    # one output's placements as a list: a tuple would read as one an output
    fn = local_map(local, out_placements=out_pl if len(out_pl) > 1 else list(out_pl[0]),
                   in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*tensors)


def _rules_or_default(rules):
    """``rules`` over DEFAULT_RULES (a cell's ``rules_for`` is overrides)."""
    return {**DEFAULT_RULES, **(rules or {})}


def sharding_tree(spec_tree, mesh, rules=None):
    """The DTensor placements of every leaf (the reference's NamedSharding
    pytree)."""
    rules = _rules_or_default(rules)
    return _map_leaves(
        lambda path, ps: placements_for(spec_for(ps.shape, ps.logical, mesh, rules), mesh),
        spec_tree)


def distribute_tree(tree, spec_tree, mesh, rules=None):
    """Place a tree of full tensors (every rank holding the same values) on
    ``mesh`` as DTensors with ``sharding_tree``'s placements.  Each rank
    keeps its own shard of its own copy: nothing is sent.  A leaf of
    ``tree`` that ``spec_tree`` lacks (a step counter) stays as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = sharding_tree(spec_tree, mesh, rules)

    def place(t, pl):
        if isinstance(t, dict):
            return {k: place(v, pl[k]) if isinstance(pl, dict) and k in pl else v
                    for k, v in t.items()}
        dt = distribute_tensor(t, mesh, pl, src_data_rank=None)
        loc = dt.to_local()
        if loc.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
            return dt
        # a shard that is a view of the full tensor would keep it alive
        return DTensor.from_local(loc.clone(), mesh, pl, run_check=False,
                                  shape=dt.shape, stride=dt.stride())

    return place(tree, placements)


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered to a full plain tensor (a
    collective: every rank calls it; on the card through
    ``collectives.host_staging``)."""
    from torch.distributed.tensor import DTensor

    from .collectives import host_staging

    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    with host_staging(tree.device_mesh):
        return tree.full_tensor()


def shape_structs(spec_tree, mesh, rules=None, fake_mode=None, device="cpu"):
    """Dry-run stand-ins, no allocation: under ``fake_mode`` (a
    ``FakeTensorMode``, made here when None) each leaf is a fake tensor of
    its declared shape and dtype, and on a mesh a DTensor of that global
    shape whose local shard is ``spec_for``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake_mode = fake_mode or FakeTensorMode()
    rules = _rules_or_default(rules)

    def one(path, ps: ParamSpec):
        with fake_mode:
            if mesh is None:
                return torch.empty(ps.shape, dtype=ps.dtype, device=device)
            from torch.distributed.tensor import DTensor

            spec = spec_for(ps.shape, ps.logical, mesh, rules)
            loc = torch.empty(local_shape(ps.shape, spec, mesh), dtype=ps.dtype, device=device)
            return DTensor.from_local(loc, mesh, placements_for(spec, mesh), run_check=False,
                                      shape=torch.Size(ps.shape),
                                      stride=contiguous_strides(ps.shape))

    return _map_leaves(one, spec_tree)

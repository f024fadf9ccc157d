"""Collectives over the axes of a ``DeviceMesh`` — the port's counterparts
of the ``lax`` collectives that the reference's ``shard_map`` bodies call,
for use inside ``local_map`` bodies:

    lax.psum        -> psum         (all_reduce "sum")
    lax.pmean       -> pmean        (psum, then divided by the axes' size)
    lax.pmax        -> pmax         (all_reduce "max")
    lax.all_to_all  -> all_to_all   (all_to_all_single, split and concat dim 0)
    lax.all_gather  -> all_gather   (all_gather_tensor, stacked on a new dim 0)
    lax.ppermute    -> ppermute     (permute_tensor)
    lax.axis_index  -> axis_index   (the rank's coordinate on the axis)

Each runs through ``torch.distributed._functional_collectives``, so that
``CommDebugMode`` and the dry-run's fake process group see it.  ``psum``,
``pmean`` and ``all_to_all`` are differentiable.  ``psum`` returns a value
replicated over its axes, so its backward is the identity: the cotangent
of a replicated value is the same on every rank, and each rank's summand
receives it whole (the sum over the axis happens where the island's inputs
are declared, by ``local_map``'s partial input gradients).  ``grad_scale``
is the island's tool for a value that every rank of an axis computes alike
(the shard_map MoE's aux loss): its forward is the identity and its
backward divides by the axis size, so the inputs' summed gradients count
the value once.

gloo and CUDA tensors.  A mesh on the card lives over a gloo group whose
ranks share one H100 (NCCL refuses two ranks on one device).  On the H100
(torch 2.11) gloo ran ``all_reduce``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``permute_tensor`` and ``broadcast`` on CUDA tensors,
and crashed the process (SIGSEGV) on ``all_gather_into_tensor``, which
DTensor's Shard -> Replicate also issues.  ``host_staged`` is the transport
for that one: under ``host_staging(mesh)`` (entered by ``axis_rules`` and by
the islands of this module's callers) every ``all_gather_into_tensor`` of a
CUDA tensor runs on a pinned host copy and its result is copied back.  It
is not a fallback: no other path exists for the collective.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "HOST_STAGED", "all_gather", "all_to_all", "axis_index", "axis_size", "flat_index",
    "grad_scale", "host_staged", "host_staging", "pmax", "pmean", "ppermute", "psum",
]

Axes = Union[str, Sequence[str]]

# the functional collectives that gloo runs only on CPU tensors (by op name)
HOST_STAGED = frozenset({"all_gather_into_tensor", "all_gather_into_tensor_coalesced"})


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group(mesh, axis: str):
    return (mesh, list(mesh.mesh_dim_names).index(axis))


def axis_size(mesh, axes: Axes) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.size(list(mesh.mesh_dim_names).index(a))
    return n


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def flat_index(mesh, axes: Axes) -> int:
    """This rank's index over several axes together, the first outermost
    (its shard's place in a dim split over ``axes``)."""
    index = 0
    for a in _axes(axes):
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
    return index


def host_staged(func, args, kwargs, device_type: str = "cuda"):
    """Run the functional collective ``func`` with every ``device_type``
    tensor of its arguments copied into pinned host memory, wait for it,
    and copy its result(s) back to the operands' device.  The collective
    moves the host copies; the caller gets device tensors, as the
    collective would give them."""
    dev = None

    def to_host(t):
        nonlocal dev
        if torch.is_tensor(t) and t.device.type == device_type:
            dev = t.device
            h = t.to("cpu")
            return h.pin_memory() if device_type == "cuda" else h
        if isinstance(t, (list, tuple)):
            return type(t)(to_host(u) for u in t)
        return t

    out = func(*[to_host(a) for a in args], **{k: to_host(v) for k, v in kwargs.items()})
    wait = torch.ops._c10d_functional.wait_tensor.default
    if isinstance(out, (list, tuple)):
        return type(out)(wait(o).to(dev) for o in out)
    return wait(out).to(dev)


class _HostStaging(TorchDispatchMode):
    """Sends the ``HOST_STAGED`` functional collectives of ``device_type``
    tensors through ``host_staged``; every other op runs as it is."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # let DTensor desugar first: its collectives then reach this mode
            return NotImplemented
        kwargs = kwargs or {}
        if func.__name__.split(".")[0] in HOST_STAGED and any(
                torch.is_tensor(t) and t.device.type == self.device_type
                for a in args for t in (a if isinstance(a, (list, tuple)) else (a,))):
            return host_staged(func, args, kwargs, self.device_type)
        return func(*args, **kwargs)


@contextlib.contextmanager
def host_staging(mesh, device_type: str = "cuda"):
    """Stage the ``HOST_STAGED`` collectives of a mesh on ``device_type``
    (a no-op for a mesh elsewhere, or no mesh)."""
    if mesh is None or getattr(mesh, "device_type", None) != device_type:
        yield
        return
    with _HostStaging(device_type):
        yield


def _wait(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed._functional_collectives import AsyncCollectiveTensor

    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _all_reduce(x: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc

    for a in axes:
        x = _wait(fc.all_reduce(x, "sum", _group(mesh, a)))
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum over ``axes`` (one all-reduce an axis), replicated over them."""
    axes = _axes(axes)
    return _PSum.apply(x, mesh, axes) if axes else x


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``lax.pmax`` (not differentiated: callers pass detached values)."""
    import torch.distributed._functional_collectives as fc

    for a in _axes(axes):
        x = _wait(fc.all_reduce(x.contiguous(), "max", _group(mesh, a)))
    return x


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """``lax.pmean``: the psum divided by the axes' size."""
    axes = _axes(axes)
    if not axes:
        return x
    n = torch.full((), axis_size(mesh, axes), dtype=x.dtype, device=x.device)
    return psum(x, mesh, axes) / n


class _GradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def grad_scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x`` whose gradient is multiplied by ``c``."""
    return _GradScale.apply(x, c)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0)``: block i of
    dim 0 goes to the axis's rank i, and the blocks received come back in
    rank order (differentiable)."""
    import torch.distributed._functional_collectives as fc

    return _wait(fc.all_to_all_single_autograd(x.contiguous(), None, None, _group(mesh, axis)))


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis)``: every rank's ``x`` stacked on a new dim 0
    in the axis's rank order."""
    import torch.distributed._functional_collectives as fc

    n = axis_size(mesh, axis)
    gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor  # renamed in 2.13
    out = _wait(gather(x.reshape(1, *x.shape).contiguous(), 0, _group(mesh, axis)))
    return out.reshape(n, *x.shape)


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: rank ``src`` sends to ``dst`` for each
    pair; a rank no pair sends to receives zeros.  ``permute_tensor`` moves
    a whole permutation, so the pairs are completed to one and what an
    unlisted source sends is replaced by zeros on arrival."""
    import torch.distributed._functional_collectives as fc

    n = axis_size(mesh, axis)
    dst_of = dict(perm)
    free = [d for d in range(n) if d not in dst_of.values()]
    src_dst, listed = [], set()
    for s in range(n):
        if s in dst_of:
            src_dst.append(dst_of[s])
            listed.add(dst_of[s])
        else:
            src_dst.append(free.pop(0))
    out = _wait(fc.permute_tensor(x.reshape(-1).contiguous(), src_dst,
                                  _group(mesh, axis))).reshape(x.shape)
    if axis_index(mesh, axis) in listed:
        return out
    return torch.zeros_like(out)

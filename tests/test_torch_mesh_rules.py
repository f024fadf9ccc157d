"""repro_torch's logical-axis rules on a mesh (``runtime.sharding.spec_for``,
``launch.steps.rules_for``), its cost model (``launch.costmodel``) and its
roofline terms (``launch.comm_analysis``), held exactly against repro's.

The reference's ``spec_for`` reads only ``mesh.shape`` (axis -> size), so
both packages get a stand-in object with that dict: no JAX devices are
needed.  Every leaf of every cell's argument trees (parameters, optimizer
state or cache, batch) of every architecture's full config is compared,
under the cell's ``rules_for``, on both production meshes and on (2, 2, 2).
"""
import types

import pytest

import repro.configs as RC
from repro.launch import costmodel as ref_cost
from repro.launch import hlo_analysis as ref_hlo
from repro.launch import steps as ref_steps
from repro.runtime import sharding as RS

import repro_torch.configs as TC
from repro_torch.launch import comm_analysis, costmodel, steps
from repro_torch.runtime import sharding as TS

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "debug": {"pod": 2, "data": 2, "model": 2},
}
CELLS = [(a, s) for a, s, _ in RC.cells(include_skipped=True)]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_cells_match():
    assert CELLS == [(a, s) for a, s, _ in TC.cells(include_skipped=True)]
    assert len(CELLS) == len(TC.ARCHS) * len(TC.SHAPES)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_spec_for_every_leaf_of_every_cell(arch, shape):
    ref_cell = ref_steps.build_cell(RC.ARCHS[arch], RC.SHAPES[shape])
    cell = steps.build_cell(TC.ARCHS[arch], TC.SHAPES[shape])
    ref_rules = {**RS.DEFAULT_RULES, **ref_steps.rules_for(RC.ARCHS[arch], RC.SHAPES[shape])}
    rules = {**TS.DEFAULT_RULES, **steps.rules_for(TC.ARCHS[arch], TC.SHAPES[shape])}
    assert rules == ref_rules
    n = 0
    for sizes in MESHES.values():
        mesh = types.SimpleNamespace(shape=dict(sizes))
        for ref_tree, tree in zip(ref_cell.arg_specs, cell.arg_specs):
            ref_leaves, leaves = list(_leaves(ref_tree)), list(_leaves(tree))
            assert [p for p, _ in ref_leaves] == [p for p, _ in leaves]
            for (path, rps), (_, ps) in zip(ref_leaves, leaves):
                assert tuple(rps.shape) == tuple(ps.shape)
                assert tuple(rps.logical) == tuple(ps.logical)
                want = tuple(RS.spec_for(rps.shape, rps.logical, mesh, ref_rules))
                got = TS.spec_for(ps.shape, ps.logical, mesh, rules)
                assert got == want, (path, sizes, got, want)
                n += 1
    assert n > 0


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_rules_for_every_cell(arch, shape):
    for tp in (16, 4, 2):
        assert steps.rules_for(TC.ARCHS[arch], TC.SHAPES[shape], tp) == \
            ref_steps.rules_for(RC.ARCHS[arch], RC.SHAPES[shape], tp)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_analytic_costs_every_cell(arch, shape):
    want = ref_cost.analytic_costs(RC.ARCHS[arch], RC.SHAPES[shape])
    got = costmodel.analytic_costs(TC.ARCHS[arch], TC.SHAPES[shape])
    assert got.__dict__ == want.__dict__  # exact floats, field by field
    assert costmodel._param_counts(TC.ARCHS[arch]) == ref_cost._param_counts(RC.ARCHS[arch])
    assert comm_analysis.model_flops(TC.ARCHS[arch], TC.SHAPES[shape], 0, 7) == \
        ref_hlo.model_flops(RC.ARCHS[arch], RC.SHAPES[shape], 0, 7)


def test_spec_for_fallback_and_placements():
    """The divisibility fallback, one axis a dim, a dim over two axes, and
    the spec's DTensor placements and local shape."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 4, "model": 8},
                                 mesh_dim_names=("pod", "data", "model"))
    rules = TS.DEFAULT_RULES
    assert TS.spec_for((24,), ("ffn",), mesh, rules) == ("model",)
    assert TS.spec_for((30,), ("ffn",), mesh, rules) == (None,)
    assert TS.spec_for((16, 8), ("batch", None), mesh, rules) == (("pod", "data"), None)
    assert TS.spec_for((6, 8), ("batch", None), mesh, rules) == ("pod", None)
    assert TS.spec_for((8, 64), ("ffn", "heads"), mesh, rules) == ("model", None)
    assert TS.spec_for((8,), ("ffn",), None, rules) == (None,)
    spec = (("pod", "data"), None, "model")
    assert TS.placements_for(spec, mesh) == (Shard(0), Shard(0), Shard(2))
    assert TS.placements_for((None, None), mesh) == (Replicate(),) * 3
    assert TS.local_shape((16, 3, 64), spec, mesh) == (2, 3, 8)
    assert TS.mesh_sizes(mesh) == {"pod": 2, "data": 4, "model": 8}


def test_link_rule_and_roofline_keys():
    """A 16-wide axis spans two 8-GPU nodes; the roofline record keeps the
    reference's keys (and adds the link it charged)."""
    assert comm_analysis.link_bandwidth({"data": 16, "model": 16}) == comm_analysis.INTERNODE_BW
    assert comm_analysis.link_bandwidth({"data": 2, "model": 4}) == comm_analysis.NVLINK_BW
    assert comm_analysis.link_bandwidth({"data": 1, "model": 16}) == comm_analysis.INTERNODE_BW
    assert comm_analysis.link_bandwidth({"data": 16, "model": 1}) == comm_analysis.INTERNODE_BW
    assert comm_analysis.PEAK_FLOPS == 989.4e12 and comm_analysis.HBM_BW == 3.35e12
    cfg, shape = TC.ARCHS["gemma2-2b"], TC.SHAPES["train_4k"]
    ac = costmodel.analytic_costs(cfg, shape)
    comm = {"all-reduce": {"count": 3, "bytes": 6e9}, "all-gather": {"count": 1, "bytes": 2e9}}
    got = comm_analysis.roofline_terms({"flops": 1e12, "bytes accessed": 2e12}, comm, 256,
                                       analytic=ac, sizes={"data": 16, "model": 16})
    want = ref_hlo.roofline_terms({"flops": 1e12, "bytes accessed": 2e12}, "", 256,
                                  analytic=ref_cost.analytic_costs(RC.ARCHS["gemma2-2b"],
                                                                   RC.SHAPES["train_4k"]))
    assert set(want) <= set(got)
    assert got["collective_ops"] == {"all-reduce": 6e9, "all-gather": 2e9, "count": 4}
    assert got["t_collective_s"] == 8e9 / comm_analysis.INTERNODE_BW
    assert got["t_compute_s"] == ac.total_flops / 256 / comm_analysis.PEAK_FLOPS
    assert got["t_memory_s"] == ac.hbm_bytes / 256 / comm_analysis.HBM_BW
    for k in ("flops_per_chip", "bytes_per_chip", "model_flops", "useful_ratio", "param_count",
              "active_param_count", "hlo_flops_per_chip_raw", "hlo_bytes_per_chip_raw"):
        assert got[k] == want[k], k

"""repro_torch's training path on a mesh (``launch.train.train(mesh=...)``)
and ``runtime.elastic.elastic_restore`` onto a mesh, on a (2, 2, 2) ("pod",
"data", "model") mesh of 8 spawned CPU gloo ranks.

* ``train(mesh=...)`` of qwen3-moe smoke (float32 activations, capacity
  factor 8: no route dropped, so the per-shard capacity of the mesh's a2a
  island and the dense dispatch's global one keep the same routes) must
  track the run without a mesh: the first loss within 1e-6 relative (one
  forward, the sums in another order), the later ones within ``LM_F32_TOL``
  = 1e-3 (the bf16 parameters' updates may round a last bit apart);
* its checkpoint, gathered and written by the mesh's first rank, restores
  without a mesh to the mesh run's final parameters, bit for bit;
* a checkpoint written without a mesh, restored onto the mesh
  (``elastic_restore(..., mesh=...)``) and gathered back, gives the same
  bits, and every leaf is a DTensor placed per ``sharding_tree``.
"""
import pickle
import socket

import pytest
import torch

STEPS = 3
OVERRIDES = dict(dtype="float32", capacity_factor=8.0)
LM_F32_TOL = 1e-3


def _rank(rank, world, port, tmp, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        from torch.distributed.tensor import DTensor

        from repro_torch.checkpoint import Checkpointer
        from repro_torch.configs import ARCHS, smoke_shape
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.steps import rules_for
        from repro_torch.launch.train import train
        from repro_torch.models import build_model
        from repro_torch.optim.optimizers import _leaves
        from repro_torch.runtime import elastic_restore
        from repro_torch.runtime.sharding import full_tree, materialize, sharding_tree

        mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        solo = train("qwen3-moe-30b-a3b", steps=STEPS, device="cpu", overrides=OVERRIDES,
                     log_every=0)
        run = train("qwen3-moe-30b-a3b", steps=STEPS, device="cpu", overrides=OVERRIDES,
                    log_every=0, mesh=mesh, ckpt_dir=f"{tmp}/mesh_ck", ckpt_every=STEPS)
        final = full_tree(run["state"]["params"])
        dist.barrier()
        # the mesh run's checkpoint, restored without a mesh
        back = Checkpointer(f"{tmp}/mesh_ck").restore(device="cpu")["params"]
        ck_equal = all(torch.equal(a, b) for a, b in zip(_leaves(final), _leaves(back)))
        # a checkpoint written without a mesh, onto the mesh and back
        cfg = ARCHS["qwen3-moe-30b-a3b"].smoke()
        api = build_model(cfg)
        params = materialize(api.param_specs, 5, "cpu")
        if rank == 0:
            Checkpointer(f"{tmp}/plain_ck").save(7, {"params": params})
        dist.barrier()
        rules = rules_for(cfg, smoke_shape("train"))
        tree = elastic_restore(Checkpointer(f"{tmp}/plain_ck"), api.param_specs, mesh=mesh,
                               rules=rules)
        placed = tree["params"]
        want_pl = sharding_tree(api.param_specs, mesh, rules)
        placements_ok = all(isinstance(t, DTensor) and tuple(t.placements) == tuple(pl)
                            for t, pl in zip(_leaves(placed), _leaves(want_pl)))
        regathered = full_tree(placed)
        el_equal = all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(regathered)))
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(dict(solo=solo["losses"], mesh=run["losses"], ck_equal=ck_equal,
                                 placements_ok=placements_ok, el_equal=el_equal,
                                 dtensor_state=isinstance(_leaves(run["state"]["params"])[0],
                                                          DTensor)), f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_train")
    out = tmp / "out.pkl"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(8, port, str(tmp), str(out)), nprocs=8)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_train_on_mesh_tracks_no_mesh(result):
    solo, mesh = result["solo"], result["mesh"]
    assert len(mesh) == len(solo) == STEPS
    assert abs(mesh[0] - solo[0]) <= 1e-6 * abs(solo[0])
    for a, b in zip(mesh, solo):
        assert abs(a - b) <= LM_F32_TOL * abs(b), (mesh, solo)
    assert result["dtensor_state"]


def test_mesh_checkpoint_restores_without_mesh(result):
    assert result["ck_equal"]


def test_elastic_restore_onto_mesh_and_back(result):
    assert result["placements_ok"]
    assert result["el_equal"]

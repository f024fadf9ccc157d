"""The port's training loop (``repro_torch.launch.train.train``) on the CPU:
it resumes from a checkpoint the reference wrote and matches the
reference's own straight run, resumes from its own checkpoints with the
losses of a straight run, and learns.

Tolerances: across the packages the resumed losses match the reference's
straight run to ``RESUME_RTOL`` = 2e-2, the reference's own tolerance for
its resume (tests/test_train_loop.py); within the port on the CPU a resumed
run repeats the straight run's losses exactly (the restored state is the
saved bits and the data replays by step).  The learning runs are in
tests/test_torch_train_learn.py.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RCheckpointer
from repro.launch.train import train as ref_train

from repro_torch.launch.train import train

RESUME_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_resumes_from_a_reference_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    ref_train("starcoder2-3b", smoke=True, steps=4, ckpt_dir=d, ckpt_every=4, log_every=0)
    out = train("starcoder2-3b", smoke=True, steps=8, ckpt_dir=d, ckpt_every=4, resume=True,
                log_every=0, device="cpu")
    assert len(out["losses"]) == 4 and int(out["state"]["step"]) == 8
    assert int(out["state"]["opt"]["step"]) == 8
    straight = ref_train("starcoder2-3b", smoke=True, steps=8, log_every=0)
    np.testing.assert_allclose(out["losses"], straight["losses"][4:], rtol=RESUME_RTOL)
    # and the port's checkpoint at step 8 restores in the reference
    back = RCheckpointer(d).restore()
    assert int(back["meta"]["step"]) == 8 and int(back["opt"]["step"]) == 8


def test_port_resume_repeats_its_straight_run(tmp_path):
    d = tmp_path / "ck"
    straight = train("starcoder2-3b", smoke=True, steps=12, ckpt_dir=str(d), ckpt_every=4,
                     log_every=0, device="cpu")
    # drop the last checkpoint: a resume to 12 starts from step 8 of the
    # same run, with the same schedule, so it repeats the last four losses
    for f in (d / "step_00000012").iterdir():
        f.unlink()
    (d / "step_00000012").rmdir()
    resumed = train("starcoder2-3b", smoke=True, steps=12, ckpt_dir=str(d), ckpt_every=4,
                    resume=True, log_every=0, device="cpu")
    assert resumed["losses"] == straight["losses"][8:]
    assert [h["loss"] for h in resumed["history"]] == resumed["losses"]
    assert all(h["ms"] > 0 and h["lr"] > 0 and np.isfinite(h["gnorm"]) for h in resumed["history"])
    # as the reference's test runs it: 8 steps (a schedule over 10), then a
    # resume to 12, against the straight run
    d2 = str(tmp_path / "ck2")
    train("starcoder2-3b", smoke=True, steps=8, ckpt_dir=d2, ckpt_every=4, log_every=0,
          device="cpu")
    resumed = train("starcoder2-3b", smoke=True, steps=12, ckpt_dir=d2, ckpt_every=4, resume=True,
                    log_every=0, device="cpu")
    np.testing.assert_allclose(resumed["losses"], straight["losses"][8:], rtol=RESUME_RTOL)

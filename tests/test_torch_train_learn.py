"""The port's training loop learns: what tests/test_train_loop.py asks of
the reference, asked of ``repro_torch.launch.train.train`` on the CPU —
smoke gemma2-2b, 60 steps, lr 1e-2, markov data at the reference test's
shape (64 tokens, batch 16), the loss down by >= 0.3, and by >= 0.2 with
int8-compressed gradients (error feedback), every loss finite.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.launch.train import train


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compress, drop", [(False, 0.3), (True, 0.2)])
def test_loss_decreases_on_learnable_data(compress, drop):
    out = train("gemma2-2b", smoke=True, steps=60, log_every=0, lr=1e-2, data_source="markov",
                shape=ShapeConfig("t", 64, 16, "train"), compress_grads=compress, device="cpu")
    losses = out["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - drop, losses[:3] + losses[-3:]

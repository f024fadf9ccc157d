"""Quickstart: the paper in ~50 lines, through the unified CDMM API —
counterpart of the reference's ``examples/quickstart.py``.

A batch of n=2 matrix products over Z_{2^32} (machine words) is described
as a ProblemSpec; the cost-model planner ranks every registered scheme
(Batch-EP_RMFE, GCSA, ...) x partition against the paper's Table-1 models
and ``coded_matmul`` executes the winner: 4 of 8 workers "die" and the
result is still bit-exact.

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.cdmm import ProblemSpec, coded_matmul, plan
from repro_torch.core import make_ring
from repro_torch.device import resolve_device
from repro_torch.kernels import gr_matmul


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    device = ap.parse_args(argv).device

    # the data ring: Z_{2^32}, native uint32 wraparound arithmetic
    Z32 = make_ring(2, 32, ())

    # two 64x64 products, 8 workers, must tolerate 4 stragglers
    spec = ProblemSpec(t=64, r=64, s=64, n=2, ring=Z32, N=8, straggler_budget=4)

    # rank every registered scheme x partition by predicted master upload
    # (under "download" every w=1 partition ties and the trivial R=1
    # replication point wins; upload rewards splitting the work)
    p = plan(spec, objective="upload")
    print(p.summary(limit=4))
    best = p.best
    print(f"\nplanner picked {best.scheme} (u,v,w)=({best.u},{best.v},{best.w}): "
          f"recovery threshold R={best.costs.R} of N={spec.N}")
    # Table 1 headline under the "download" objective: GCSA pays ~n x more
    pd = plan(spec, objective="download")
    gcsa = pd.by_scheme("gcsa")
    print(f"downloads (Table 1): gcsa needs "
          f"{gcsa.costs.download / pd.best.costs.download:.1f}x the best RMFE point")

    rng = np.random.default_rng(0)
    As = Z32.random(rng, (2, 64, 64), device=resolve_device(device))
    Bs = Z32.random(rng, (2, 64, 64), device=As.device)

    # stragglers: workers 1, 2, 5, 6 never respond
    mask = torch.tensor([True, False, False, True, True, False, False, True])

    # encode -> 8 simulated workers -> any-R decode, in one call
    Cs = coded_matmul(As, Bs, p, mask=mask, device=device)

    # exactness check against the direct products
    for i in range(2):
        if not torch.equal(Cs[i], gr_matmul(As[i], Bs[i], Z32)):
            raise SystemExit(f"product {i} differs from the direct product")
    print(f"recovered both products exactly from 4/8 workers on {As.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Coded quantized serving: the paper's technique as an inference feature —
counterpart of the reference's ``examples/coded_inference.py``.

An int8 FFN matmul is lifted to Z_{2^32} and executed as EP_RMFE-coded
tasks across 8 workers; up to 4 workers per request are killed and the
dequantized output must be BIT-IDENTICAL to the failure-free run
(integer-exact codes: no approximation under failures).

    python -m repro_torch.examples.coded_inference [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.cdmm import CodedQuantMatmul


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    device = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    cm = CodedQuantMatmul(N=8, axis_name=None, device=device)  # GR(2^32, 3), R=4
    print(f"coded int8 matmul: N=8 workers, R={cm.R}, ring {cm.scheme.ring}, on {cm.device}")

    # a "transformer FFN" shaped problem: tokens x d_model @ d_model x d_ff
    x = torch.from_numpy(rng.standard_normal((32, 256)).astype(np.float32)).to(cm.device)
    w = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32)).to(cm.device)
    y_ref = cm(x, w, mask=None)

    for fail in [1, 2, 3, 4]:
        mask = np.ones(8, dtype=bool)
        dead = rng.choice(8, size=fail, replace=False)
        mask[dead] = False
        y = cm(x, w, mask=torch.from_numpy(mask))
        ident = torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
        print(f"{fail} dead workers {sorted(map(int, dead))}: bit-identical={ident}")
        if not ident:
            raise SystemExit("the output changed when workers died")

    # quantization (not coding) is the only error source
    exact = x.cpu().double() @ w.cpu().double()
    err = float((y_ref.cpu().double() - exact).abs().max() / exact.abs().max())
    print(f"int8 quantization rel-err vs fp64: {err:.4f} (coding adds 0.0)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

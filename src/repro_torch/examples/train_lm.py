"""End-to-end training run: a ~100M-parameter llama-style LM, a few
hundred steps, with periodic async checkpointing and kill-resume support —
counterpart of the reference's ``examples/train_lm.py``.

    python -m repro_torch.examples.train_lm --steps 300 [--device cpu]
    # interrupt anywhere, then resume from the last checkpoint:
    python -m repro_torch.examples.train_lm --steps 300 --resume [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch.train import train

# ~100M params: 50k x 640 embed (32M) + 10 layers x ~6.3M
CFG_100M = dataclasses.replace(
    ARCHS["deepseek-67b"],  # llama-style family as the base
    name="llama-100m",
    num_layers=10,
    d_model=640,
    num_heads=10,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=50304,
    remat="none",
)
SHAPE = ShapeConfig("train_100m", seq_len=128, global_batch=4, kind="train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # register the custom config so that train() finds it by name
    ARCHS[CFG_100M.name] = CFG_100M
    out = train(
        CFG_100M.name,
        smoke=False,
        shape=SHAPE,
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        log_every=10,
        device=args.device,
    )
    losses = out["losses"]
    if losses:
        print(f"loss: first={losses[0]:.3f} min={min(losses):.3f} last={losses[-1]:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end training with LMB extras, on the PyTorch port.

The port's twin of ``examples/train_offload.py``: trains its
qwen2-family model (8 layers of width 512, "~100M-class" there, 39M
parameters by ``param_count``) for a few hundred steps on the synthetic
corpus with
  * checkpoint/restart (kill it mid-run and re-run: it resumes from the
    last checkpoint in ``--ckpt``),
  * the optimizer state parked in the LMB tier between steps (pinned host
    memory on a card, streamed in and out beside the staged step),
  * int8 error-feedback gradient compression.

Run:  PYTHONPATH=src python examples/train_offload_torch.py [--steps 300]
      [--device cpu] [--ckpt DIR]
"""

import argparse
import dataclasses
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.base import get_config, register
from repro_torch.launch.train import run

#: the reference example's qwen2-family config
SHAPE = dict(name="qwen2-100m", num_layers=8, d_model=512, num_heads=8,
             num_kv_heads=2, d_ff=2048, vocab_size=8192, head_dim=64,
             dtype="float32", remat=False)
GLOBAL_BATCH, SEQ_LEN = 8, 256
CKPT_EVERY = 50


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(
        ROOT, "build", "train_offload_ckpt"),
        help="checkpoint directory (default: build/train_offload_ckpt)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = register(dataclasses.replace(get_config("qwen2-1.5b"), **SHAPE))
    print(f"params ~= {cfg.param_count()/1e6:.0f}M")

    out = run(cfg.name, steps=args.steps, global_batch=GLOBAL_BATCH,
              seq_len=SEQ_LEN, ckpt_dir=args.ckpt,
              ckpt_every=CKPT_EVERY, reduced=False, offload_opt=True,
              compress_grads=True, lr=3e-4, device=args.device)
    if out["steps"]:
        print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
              f"({out['steps']} steps, {out['wall_s']:.0f}s)")
    else:
        print(f"nothing to do: the checkpoint is at step {args.steps} "
              "or later")
    return out


if __name__ == "__main__":
    main()

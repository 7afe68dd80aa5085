"""Training launcher: end-to-end driver with checkpointing, fault
tolerance, straggler detection and LMB optimizer-state offload (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 50                                   # reduced, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --offload-opt --compress-grads               # full width, one card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

It runs on the card unless given ``--device cpu``.  With ``--offload-opt``
the optimizer state (float32 ``m``, ``v``, master copies and, with
``--compress-grads``, the error-feedback residual) is parked in the LMB
tier between steps: on the card, one page-locked host slab the state is
copied into after every step and read back from before the next; on the
CPU the state stays where it is (modelling mode).  The LMB pool is sized
from the state, in whole 256 MiB blocks: the reference's fixed 4 GiB pool
cannot hold a full-width model's state.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import (BLOCK_BYTES, DeviceSpec, HostSpec, LMBSystem,
                              SystemSpec)
from repro_torch.core.offload import (DEVICE, PINNED_HOST, PinnedArena,
                                      backend_memory_kinds, nbytes_of,
                                      tier_of, tree_put_tier)
from repro_torch.data.pipeline import DataConfig, make_dataset
from repro_torch.devices import resolve_device
from repro_torch.models.flags import Flags
from repro_torch.models.layers import dtype_of
from repro_torch.models.zoo import build_model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault import FailureInjector, StragglerDetector
from repro_torch.train.loop import StepClock, make_train_step, opt_state_init

#: the device the trainer's LMB allocations are made for
TRAINER_DEVICE = "gpu0"


def state_system(state_bytes: int) -> LMBSystem:
    """An LMB stack whose one expander holds ``state_bytes`` of optimizer
    state: whole 256 MiB blocks, rounded up to the whole GiB the spec
    counts in."""
    blocks = max(1, -(-state_bytes // BLOCK_BYTES))
    gib = -(-blocks * BLOCK_BYTES // 2**30)
    return LMBSystem(SystemSpec(
        expanders=1, pool_gib=gib, hosts=(HostSpec("trainer"),),
        devices=(DeviceSpec(TRAINER_DEVICE),)))


def alloc_state_handles(system: LMBSystem, device_id: str,
                        state_bytes: int) -> list:
    """The pool's accounting for the parked state: regions live inside
    single 256 MiB blocks, so one handle per block."""
    handles = []
    remaining = max(state_bytes, 1)
    while remaining > 0:
        take = min(remaining, BLOCK_BYTES)
        handles.append(system.alloc(device_id, take))
        remaining -= take
    return handles


def _crossed(before, after) -> int:
    """Bytes of the leaves a tier move put in another tier."""
    return sum(nbytes_of(b) for b, a in zip(tree_leaves(before),
                                            tree_leaves(after))
               if tier_of(a) != tier_of(b))


def run(arch: str, steps: int = 50, global_batch: int = 8,
        seq_len: int = 128, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 25, grad_accum: int = 1,
        compress_grads: bool = False, offload_opt: bool = False,
        reduced: bool = True, fail_at: Optional[set] = None,
        lr: float = 1e-3, verbose: bool = True, device="cuda",
        init_params=None) -> dict:
    """Train ``arch`` for ``steps`` steps; returns the losses, the final
    params and optimizer state, and the wall time.

    Params are drawn from a ``torch.Generator`` seeded with 0, or taken
    from ``init_params`` (on ``device``).  ``out["step_log"]`` holds, per
    step, the time of each stage (``page_in``, ``fwd_bwd``, ``compress``,
    ``adamw``, ``page_out``, the card synchronized at each boundary), the
    bytes moved each way, and the tiers and device memory the parked
    state leaves."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    flags = Flags(remat=False, attn_chunk=seq_len)
    model = build_model(cfg, flags, device=device)

    if init_params is None:
        params = model.init(torch.Generator(device).manual_seed(0))
    else:
        params = init_params
    opt_state = opt_state_init(params, compress_grads)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          total_steps=steps)
    step_fn = make_train_step(model, opt_cfg, grad_accum, compress_grads)

    data = make_dataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch))

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        trees, start = restore_checkpoint(
            ckpt_dir, {"params": params, "opt_state": opt_state})
        params, opt_state = trees["params"], trees["opt_state"]
        if verbose:
            print(f"[train] resumed from step {start}")

    # --- LMB pool for optimizer-state offload (host tier) ----------------
    # sized from the state; allocations are MemoryHandle capabilities,
    # freed by close()
    state_bytes = nbytes_of(opt_state)
    system = state_system(state_bytes)
    park, arena = DEVICE, None
    if offload_opt:
        alloc_state_handles(system, TRAINER_DEVICE, state_bytes)
        if PINNED_HOST in backend_memory_kinds(device):
            park, arena = PINNED_HOST, PinnedArena(opt_state)
        opt_state = tree_put_tier(opt_state, park,
                                  out=arena and arena.tree)

    injector = FailureInjector(fail_at)
    straggler = StragglerDetector()
    losses, step_log = [], []
    t_train0 = time.monotonic()
    try:
        for step in range(start, steps):
            injector.maybe_fail(step)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in data.batch(step).items()}
            if cfg.encoder_decoder:
                batch["src_emb"] = torch.zeros(
                    (batch["tokens"].shape[0], seq_len, cfg.d_model),
                    dtype=dtype_of(cfg), device=device)
            clock = StepClock(device)
            moved = {"to_device": 0, "to_host": 0}
            t0 = time.monotonic()
            if offload_opt:
                clock.start()
                parked = opt_state
                opt_state = tree_put_tier(parked, DEVICE)        # page in
                moved["to_device"] = _crossed(parked, opt_state)
                clock.lap("page_in")
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 clock)
            if offload_opt:
                clock.start()
                live = opt_state
                opt_state = tree_put_tier(live, park,            # page out
                                          out=arena and arena.tree)
                moved["to_host"] = _crossed(live, opt_state)
                del parked, live
                clock.lap("page_out")
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.monotonic() - t0
            step_log.append({
                "step": step, "loss": loss, "s": dt, "times": clock.times,
                "moved": moved,
                "parked_tiers": sorted({tier_of(l) for l in
                                        tree_leaves(opt_state)}),
                "device_bytes": (torch.cuda.memory_allocated(device)
                                 if device.type == "cuda" else None)})
            if straggler.observe(dt) and verbose:
                print(f"[train] step {step}: straggler ({dt:.2f}s)")
            if verbose and (step % 10 == 0 or step == steps - 1):
                print(f"[train] step {step} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1,
                                {"params": params, "opt_state": opt_state})
    finally:
        system.close()             # frees every live offload handle
        if arena is not None:
            arena.close()
    return {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "losses": losses,
        "steps": len(losses),
        "wall_s": time.monotonic() - t_train0,
        "params": params, "opt_state": opt_state,
        "state_bytes": state_bytes, "pool_gib": system.spec.pool_gib,
        "step_log": step_log,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--offload-opt", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.arch, steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
              grad_accum=args.grad_accum,
              compress_grads=args.compress_grads,
              offload_opt=args.offload_opt, reduced=not args.full,
              device=args.device)
    print(f"[train] done: loss {out['first_loss']:.3f} -> "
          f"{out['final_loss']:.3f} in {out['steps']} steps "
          f"({out['wall_s']:.1f}s)")


if __name__ == "__main__":
    main()

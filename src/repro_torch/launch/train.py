"""Training launcher CLI (counterpart of ``src/repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --full-config --dmrg-start-rank 10 --rank 8 --steps-per-epoch 5

Trains an adapter (``--adapter`` metatt, lora, vera or lotr; MetaTT's
``--variant`` 4d, 5d, 4+1d or, on a MoE model, 4+ed) on the synthetic LM stream through the
port's ``Trainer``: on the CUDA device by default (``--device cpu`` for
the plain versions on the CPU), on the reduced smoke config unless
``--full-config``. ``--dmrg-start-rank`` above ``--rank`` adds a DMRG
schedule that lowers the ranks by 2 after each epoch. ``--ckpt-dir``
saves every ``--ckpt-every`` steps and resumes from the newest checkpoint
there. ``--grad-compression`` int8 or topk round-trips the adapter
gradients before AdamW (top-k with an error-feedback residual).
"""
from __future__ import annotations

import argparse

from repro_torch import configs as registry
from repro_torch.config.base import OptimizerConfig, RunConfig, SHAPES, \
    TrainConfig
from repro_torch.core.dmrg import RankSchedule
from repro_torch.data import LMStream
from repro_torch.train.trainer import Trainer


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ALL_IDS))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--adapter", default="metatt", choices=("metatt", "lora", "vera", "lotr", "none"))
    ap.add_argument("--variant", default="4d",
                    choices=("4d", "5d", "4+1d", "4+ed"))
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=4.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--dmrg-start-rank", type=int, default=0,
                    help="enable DMRG schedule from this rank down to --rank")
    ap.add_argument("--steps-per-epoch", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full config instead of the reduced smoke "
                         "config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    args = build_argparser().parse_args(argv)
    cfg = (registry.get_config(args.arch) if args.full_config
           else registry.get_smoke_config(args.arch))
    start_rank = args.dmrg_start_rank or args.rank
    run = RunConfig(
        model=cfg, shape=SHAPES[args.shape], adapter_kind=args.adapter,
        adapter_variant=args.variant, adapter_rank=start_rank,
        adapter_alpha=args.alpha,
        optimizer=OptimizerConfig(lr=args.lr),
        train=TrainConfig(seed=args.seed, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          grad_compression=args.grad_compression,
                          remat="none" if not args.full_config else "block"))
    sched = None
    if args.dmrg_start_rank and args.dmrg_start_rank > args.rank:
        sched = RankSchedule.linear(args.dmrg_start_rank, args.rank,
                                    start_epoch=1, every=1, step=2)
    data = LMStream(vocab_size=cfg.vocab_size, seq_len=32, batch=8,
                    seed=args.seed, branching=2)
    tr = Trainer(run=run, data=data, total_steps=args.steps,
                 steps_per_epoch=args.steps_per_epoch,
                 rank_schedule=sched, device=args.device,
                 on_metrics=lambda s, m: (
                     s % 10 == 0 and print(
                         f"step {s:5d} loss {m['loss']:.4f} "
                         f"lr {m['lr']:.2e} {m['step_time_s']*1e3:.0f}ms")))
    return tr.train()


if __name__ == "__main__":
    main()

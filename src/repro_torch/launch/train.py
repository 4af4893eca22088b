"""Training launcher: the fault-tolerant loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 200 \\
        --batch 8 --seq 128 --ckpt runs/qwen3                # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20

``--reduced`` trains the arch's small same-family config (``reduced_config``);
``--device cpu`` runs the plain PyTorch versions of the kernels.  ``--ckpt``
names the checkpoint directory a run resumes from; without it the run starts
fresh in a new directory under the temp dir.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint directory to resume from and save into "
                         "(default: a fresh one under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.tokens import TokenPipelineConfig
    from repro_torch.train.loop import Trainer, TrainLoopConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    loop = TrainLoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                           checkpoint_dir=args.ckpt, lr=args.lr, accum_steps=args.accum)
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, loop, data, device=args.device)
    out = trainer.run(seed=args.seed)
    if not out["history"]:
        print(f"[train] nothing to run: the checkpoint in {trainer.ckpt.directory} "
              f"is at step {trainer.ckpt.latest_step()} of {args.steps}")
        return out
    print(f"[train] {args.arch}{' (reduced)' if args.reduced else ''} on {trainer.device}: "
          f"final loss {out['final_loss']:.4f}, median step "
          f"{out['median_step_time_s'] * 1e3:.1f} ms, stragglers {out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()

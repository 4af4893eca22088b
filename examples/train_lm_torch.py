"""Training script on the PyTorch/CUDA port: train an LM on the synthetic
Markov stream for a few hundred steps with checkpoints and an optional
crash and restart (the twin of ``examples/train_lm.py``).  Runs on the card
unless ``--device cpu`` is given (the kernels' plain versions).

  PYTHONPATH=src python examples/train_lm_torch.py                 # ~6M params, 200 steps
  PYTHONPATH=src python examples/train_lm_torch.py --size 100m     # ~100M params
  PYTHONPATH=src python examples/train_lm_torch.py --crash-at 100 --ckpt runs/lm  # crash,
  PYTHONPATH=src python examples/train_lm_torch.py --ckpt runs/lm                  # resume
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 60 --batch 8

The loss must fall measurably (the stream has ~2 bits of conditional entropy
against 8 bits marginal).
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipelineConfig
from repro_torch.train.loop import Trainer, TrainLoopConfig


def size_cfg(size: str):
    base = get_config("qwen3-0.6b")
    if size == "small":  # ~6M params
        return base.replace(d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                            d_ff=512, vocab_size=256, num_superblocks=4,
                            vocab_round_to=16, param_dtype="float32", compute_dtype="float32")
    if size == "20m":
        return base.replace(d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
                            d_ff=1024, vocab_size=512, num_superblocks=8, vocab_round_to=16)
    if size == "100m":
        return base.replace(d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
                            d_ff=2048, vocab_size=4096, num_superblocks=16, vocab_round_to=64)
    raise ValueError(size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="small", choices=["small", "20m", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory to resume from and save into "
                         "(default: a fresh one under the temp dir)")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = size_cfg(args.size)
    loop = TrainLoopConfig(total_steps=args.steps, checkpoint_every=max(args.steps // 4, 10),
                           checkpoint_dir=args.ckpt, lr=args.lr, warmup_steps=20, log_every=20,
                           fail_at_step=args.crash_at)
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch, branching=4)
    trainer = Trainer(cfg, loop, data, device=args.device)
    out = trainer.run()
    h = out["history"]
    if not h:
        print(f"[train_lm] nothing to run: the checkpoint in {trainer.ckpt.directory} "
              f"is at step {trainer.ckpt.latest_step()} of {args.steps}")
        return
    print(f"[train_lm] loss {h[0]:.3f} -> {h[-1]:.3f} over {len(h)} steps on {trainer.device} "
          f"(median {out['median_step_time_s'] * 1e3:.0f} ms/step)")
    if not h[-1] < h[0] - 0.5:
        raise SystemExit("loss did not decrease enough")


if __name__ == "__main__":
    main()

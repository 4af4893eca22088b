"""Continuous-batching LM serving on the PyTorch/CUDA port (the twin of
``examples/serve_lm.py``): the slot-based engine with per-slot lengths
serves a few requests on a reduced arch.  Runs on the card unless
``--device cpu`` is given (the kernels' plain versions).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch gemma3-1b --requests 6
  PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b --device cpu
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models.transformer import LM
from repro_torch.serving import Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_config(args.arch))
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=args.slots, cache_len=128),
                      device=model.device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6 + i % 5),
                           max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve_lm] {len(done)} requests on {model.device}, {toks} tokens, "
          f"{toks / dt:.1f} tok/s")
    for r in done:
        print(f"  rid={r.rid} out={r.out_tokens}")
    return done


if __name__ == "__main__":
    main()

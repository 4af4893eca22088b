"""Quickstart on the PyTorch/CUDA port (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds a reduced qwen3-family model, routes its matmuls through the Octopus
router, trains a handful of steps, checkpoints, restores, prints the
placement report of a prefill and greedy-decodes.  Runs on the card unless
``--device cpu`` is given (the kernels' plain versions).
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw
from repro_torch.runtime import RoutePlan, RuntimeConfig
from repro_torch.train.steps import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    cfg = reduced_config(get_config("qwen3-0.6b"))
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(0))

    # -- data, optimizer, train step
    pipe = TokenPipeline(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                             global_batch=8))
    opt = adamw(3e-3)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    for step in range(20):
        batch = {k: torch.as_tensor(v).to(model.device) for k, v in pipe.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, step, batch)
        if step % 5 == 0:
            print(f"step {step:3d}  loss {float(metrics['loss']):.4f}")

    # -- checkpoint round trip
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(os.path.join(d, "ckpt"), async_writes=False)
        mgr.save({"params": params}, step=20, extra={"next_step": 20})
        restored, extra, at = mgr.restore({"params": params})
    print(f"checkpoint restored from step {at}")

    # -- the Octopus placement of a prefill (traced on meta tensors), then greedy decode
    prompt = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32, device=model.device)
    plan = RoutePlan.trace(lambda p, c: model.prefill(p, {"tokens": prompt.to(p["embed"].device)}, c),
                           restored["params"], model.init_cache(1, 32),
                           config=RuntimeConfig.from_arch(cfg))
    print(plan.explain())
    cache = model.init_cache(batch=1, cache_len=32)
    with torch.no_grad():
        logits, cache = model.prefill(restored["params"], {"tokens": prompt}, cache)
        toks = [int(logits[0, -1, :cfg.vocab_size].argmax())]
        for _ in range(8):
            nxt = torch.tensor([[toks[-1]]], dtype=torch.int32, device=model.device)
            logits, cache = model.decode_step(restored["params"], {"tokens": nxt}, cache)
            toks.append(int(logits[0, 0, :cfg.vocab_size].argmax()))
    print("decoded:", toks)


if __name__ == "__main__":
    main()

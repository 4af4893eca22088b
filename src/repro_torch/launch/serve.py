"""Serving launcher: the slot-based continuous-batching engine on a reduced
arch, serving a batch of synthetic requests end to end.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # plain PyTorch versions

Every registered arch with a token-only decode path serves, the recurrent
ones too (``--arch xlstm-1.3b``, ``--arch zamba2-2.7b``): their fixed-size
states ride in the same cache dict and merge per slot like the attention
caches (``serving.engine.merge_slot``).  An encoder-only arch
(``--arch hubert-xlarge``) exits as the reference's launcher does: it has no
decode path.  ``llama-3.2-vision-90b`` raises ``NotImplementedError`` in the
engine, whose requests cannot carry image embeddings.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving import Request, ServeConfig, ServeEngine

    cfg = reduced_config(get_config(args.arch))
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only; no decode path")
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    eng = ServeEngine(cfg, params, ServeConfig(batch_slots=args.slots, cache_len=args.cache_len),
                      device=model.device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, args.prompt_len),
                           max_new=args.max_new))
    done = eng.run_until_drained()
    st = eng.stats
    print(f"[serve] {len(done)}/{args.requests} requests on {model.device}, {st.tokens} tokens "
          f"in {st.prefill_s + st.decode_s:.2f}s -> {st.tok_per_s:.1f} tok/s "
          f"({st.prefills} prefills, {st.decode_steps} decode steps)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens[:10]}...")


if __name__ == "__main__":
    main()

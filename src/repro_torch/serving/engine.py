"""LM serving engine of the port (the reference's ``serving/engine.py``):
slot-based continuous batching over a fixed decode batch, per-slot lengths,
prefill at admission and lockstep decode.

The paper's task split at LM scale: decode (one token a step) is the latency
engine's work, prefill the throughput engine's; both share the KV cache.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.common.util import Device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import LM, store_rows


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int
    max_new: int = 16
    out_tokens: list = field(default_factory=list)
    done: bool = False


@dataclass
class ServeConfig:
    batch_slots: int = 4
    cache_len: int = 256
    greedy: bool = True
    eos_id: int = -1  # -1: never stop early


@dataclass
class ServeStats:
    """Counts and host wall time of the two phases.  Each phase ends by
    reading its argmax back to the host, which waits for the card, so the
    times are the card's too."""

    prefills: int = 0
    decode_steps: int = 0
    tokens: int = 0  # generated, prefill's first token included
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def tok_per_s(self) -> float:
        wall = self.prefill_s + self.decode_s
        return self.tokens / wall if wall else float("nan")


class ServeEngine:
    """Requests wait in ``queue``; ``step`` admits them into free slots (one
    prefill each) and then decodes one token for every slot in lockstep.

    A request is a token prompt and nothing else, as the reference's, so an
    encoder-only arch (no decode path) and an arch with a modality frontend
    (whose frames or image embeddings have no way in) raise
    ``NotImplementedError`` here.  The reference's engine takes both and
    fails inside its first prefill (``KeyError: 'frames'``, or ``rms_norm``
    of the missing image embeddings)."""

    def __init__(self, cfg: ArchConfig, params: dict, serve: ServeConfig, *,
                 device: Device = None):
        if not cfg.supports_decode:
            raise NotImplementedError(f"{cfg.name} is encoder-only: there is no decode path "
                                      "to serve")
        if cfg.frontend != "none":
            raise NotImplementedError(f"{cfg.name}: a request holds only tokens, so the "
                                      f"{cfg.frontend!r} frontend's embeddings have no way in")
        if not serve.greedy:
            raise NotImplementedError("only greedy decoding is ported (as the reference runs)")
        self.cfg = cfg
        self.model = LM(cfg, device=device)
        self.params = params
        self.sc = serve
        self.reset()

    def reset(self) -> None:
        self.cache = self.model.init_cache(self.sc.batch_slots, self.sc.cache_len)
        self.slots: list[Optional[Request]] = [None] * self.sc.batch_slots
        self.queue: list[Request] = []
        self.next_tok = np.zeros((self.sc.batch_slots, 1), np.int64)
        self.active = np.zeros((self.sc.batch_slots,), bool)
        self.stats = ServeStats()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _tokens(self, toks: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(toks).to(self.model.device)}

    def _admit(self) -> None:
        """Prefill queued requests into free slots, one at a time: a full
        ``batch_slots`` batch, zeros except the slot's row, into a fresh
        cache, of which only that slot's rows are kept."""
        for i in range(self.sc.batch_slots):
            if self.slots[i] is None and self.queue:
                t0 = time.perf_counter()
                req = self.queue.pop(0)
                toks = np.zeros((self.sc.batch_slots, len(req.prompt)), np.int64)
                toks[i] = req.prompt
                fresh = self.model.init_cache(self.sc.batch_slots, self.sc.cache_len)
                logits, fresh = self.model.prefill(self.params, self._tokens(toks), fresh)
                merge_slot(self.cache, fresh, i)
                self.cache["lengths"][i] = len(req.prompt)
                nt = int(torch.argmax(logits[i, -1, : self.cfg.vocab_size]))
                self.stats.prefill_s += time.perf_counter() - t0
                self.stats.prefills += 1
                self.stats.tokens += 1
                self.next_tok[i, 0] = nt
                req.out_tokens.append(nt)
                self.slots[i] = req
                self.active[i] = True

    def step(self) -> int:
        """One lockstep decode step across the slots.  Returns #finished."""
        self._admit()
        if not self.active.any():
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(self.params, self._tokens(self.next_tok),
                                                    self.cache)
        nxt = torch.argmax(logits[:, 0, : self.cfg.vocab_size], dim=-1).cpu().numpy()
        self.stats.decode_s += time.perf_counter() - t0
        self.stats.decode_steps += 1
        self.stats.tokens += int(self.active.sum())
        finished = 0
        for i, req in enumerate(self.slots):
            if req is None or not self.active[i]:
                continue
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self.next_tok[i, 0] = tok
            if len(req.out_tokens) >= req.max_new or tok == self.sc.eos_id:
                req.done = True
                self.slots[i] = None
                self.active[i] = False
                finished += 1
        return finished

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        all_reqs = list(self.queue)
        for _ in range(max_steps):
            self.step()
            if not self.queue and not self.active.any():
                break
        return [r for r in all_reqs if r.done]


def merge_slot(cache: dict, fresh: dict, slot: int) -> None:
    """Copy slot ``slot``'s rows of every layer cache from ``fresh`` into
    ``cache``, in place.  The batch axis comes from the cache's structure:
    axis 1 under ``blocks`` (stacked over the superblocks), axis 0 for the
    head and tail layers.  (The reference guesses it from ``shape[0] ==
    num_superblocks``, which picks the wrong axis of the unstacked layers when
    ``batch_slots == num_superblocks``.)  Any cache NamedTuple merges leaf by
    leaf: an ``AttnCache``, a recurrent state.  A leaf whose type differs
    from the fresh one's (mamba2's bf16 conv inputs, which a prefill in f32
    compute returns f32) first takes the fresh type, as a decode step would
    give it: the reference's ``.at[].set`` rounds the fresh rows into the
    bf16 buffer instead, for every admit before its engine's first decode
    step (ROADMAP Queue 3).  ``lengths`` is the caller's."""
    for key, layer in cache.items():
        if key == "blocks":
            for name, c in layer.items():
                layer[name] = store_rows(c, [n[:, slot] for n in fresh[key][name]],
                                         (slice(None), slot))
        elif key != "lengths":
            cache[key] = store_rows(layer, [n[slot] for n in fresh[key]], slot)

"""Int8 symmetric quantization for the engine datapath (the paper's fixed
point): the port's own copy of the reference's scale table, primitives and
calibration tap (``repro/runtime/quant.py``).

  * :class:`QuantScales` — the per-layer symmetric scale table, one entry per
    routed matmul name (``w0``..``w3``, ``conv1``..``linear``), holding the
    activation scale and the weight scale (one float, or one per output
    channel).  Frozen and hashable, so it lives on the frozen
    :class:`repro_torch.runtime.RuntimeConfig`; its ``fingerprint`` equals
    the reference's for the same entries.
  * :func:`quantize_i8` / :func:`dequant_row` — the int8 grid and the (N,)
    dequant row.  Division is IEEE f32 by a scale tensor on the operand's
    device (never a reciprocal multiply), rounding half to even, then the
    clip to [-127, 127]: the reference oracle's numerics.
  * :func:`record_scales` / :func:`maybe_record` — the recorder that
    ``router.matmul`` feeds max-abs statistics into during calibration.  The
    port runs eagerly, so every named routed matmul inside the block is
    recorded.

The reference's f32-lane encoding (``quantize_f32int``) and its
``quant_impl`` switch have no counterpart: the kernels and their plain twins
accumulate in int32, chosen by the tensor's device.
"""
from __future__ import annotations

import hashlib
import json
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

Q_MAX = 127  # symmetric int8 grid: codes in [-127, 127]

# Deepest contraction whose int32 sum cannot overflow: K * 127^2 < 2^31.
I32_MAX_K = (2**31 - 1) // (Q_MAX * Q_MAX)  # 133144

_EPS = 1e-8


def pick_scale(max_abs: float) -> float:
    """Symmetric per-tensor scale from a max-abs statistic (zero-guarded)."""
    return max(float(max_abs), _EPS) / Q_MAX


@dataclass(frozen=True)
class QuantScales:
    """Per-layer symmetric int8 scales: ``(name, scale_x, scale_w)`` entries.

    ``scale_x`` quantizes the activation (per tensor); ``scale_w`` the
    weight — one float, or a tuple with one scale per output channel.  The
    output is ``int32_accum * (scale_x * scale_w[n])``.  Lookup tries the
    scope-qualified name (``pkt/w0``), then the bare name, then the tail
    after the last ``/``."""

    entries: Tuple[Tuple[str, float, object], ...]

    def __post_init__(self):
        seen = set()
        for name, sx, sw in self.entries:
            if not name or not isinstance(name, str):
                raise ValueError(f"quant scale entry needs a layer name, got {name!r}")
            if name in seen:
                raise ValueError(f"duplicate quant scale entry for {name!r}")
            seen.add(name)
            sws = sw if isinstance(sw, tuple) else (sw,)
            if not (sx > 0.0 and sws and all(s > 0.0 for s in sws)):
                raise ValueError(
                    f"quant scales must be positive, got {name!r}: ({sx}, {sw})")
        object.__setattr__(self, "_map", {e[0]: (e[1], e[2]) for e in self.entries})

    def lookup(self, name: Optional[str], scope: str = "") -> Optional[Tuple[float, object]]:
        """``(scale_x, scale_w)`` for a routed matmul, or None (stay f32)."""
        if not name:
            return None
        table: Dict[str, Tuple[float, object]] = self._map  # type: ignore[attr-defined]
        if scope:
            hit = table.get(f"{scope}{name}")
            if hit is not None:
                return hit
        hit = table.get(name)
        if hit is None and "/" in name:
            hit = table.get(name.rsplit("/", 1)[-1])
        return hit

    def names(self) -> Tuple[str, ...]:
        return tuple(e[0] for e in self.entries)

    @property
    def fingerprint(self) -> str:
        """Short stable id for reports (``int8/<10 hex>``)."""
        blob = json.dumps(self.entries, sort_keys=True).encode()
        return "int8/" + hashlib.sha256(blob).hexdigest()[:10]

    def subset(self, names) -> "QuantScales":
        """The table restricted to ``names``; layers outside it stay f32."""
        keep = set(names)
        return QuantScales(tuple(e for e in self.entries if e[0] in keep))

    @classmethod
    def from_max_abs(cls, stats: Mapping[str, Tuple[float, object]]) -> "QuantScales":
        """Build from ``{name: (max_abs_x, max_abs_w)}``; the weight stat is a
        scalar (per tensor) or a per-output-channel sequence."""
        entries = []
        for name, (mx, mw) in sorted(stats.items()):
            sw = (tuple(pick_scale(v) for v in mw)
                  if isinstance(mw, (tuple, list)) else pick_scale(mw))
            entries.append((name, pick_scale(mx), sw))
        return cls(tuple(entries))

    def to_dict(self) -> dict:
        return {"entries": [[n, sx, list(sw) if isinstance(sw, tuple) else sw]
                            for n, sx, sw in self.entries]}

    @classmethod
    def from_dict(cls, d: Mapping) -> "QuantScales":
        entries = []
        for name, sx, sw in d["entries"]:
            sw = tuple(float(v) for v in sw) if isinstance(sw, (tuple, list)) else float(sw)
            entries.append((str(name), float(sx), sw))
        return cls(tuple(entries))


def quantize_i8(v: torch.Tensor, scale) -> torch.Tensor:
    """Clip-round to the symmetric int8 grid; ``scale`` is a float or a
    per-channel tuple (dividing the last axis of a (K, N) weight).  The
    divisor is an f32 tensor on ``v``'s device: on the card, torch divides by
    a CPU scalar as a reciprocal multiply, which differs from IEEE division
    in the last bit."""
    s = torch.tensor(scale, dtype=torch.float32, device=v.device)
    q = torch.round(v.float() / s)
    return torch.clamp(q, -Q_MAX, Q_MAX).to(torch.int8)


def dequant_row(scale_x, scale_w, n: int) -> np.ndarray:
    """The (n,) f32 dequant vector ``scale_x * scale_w`` (scalars broadcast),
    one f32 product per channel."""
    return np.broadcast_to(
        np.float32(scale_x) * np.asarray(scale_w, np.float32), (n,)).copy()


class ScaleRecorder:
    """Accumulates per-layer max-abs stats from ``router.matmul`` calls: a
    per-tensor activation max and a per-output-channel weight max."""

    def __init__(self) -> None:
        self.stats: Dict[str, Tuple[float, Tuple[float, ...]]] = {}

    def update(self, name: str, max_x: float, max_w) -> None:
        mw_new = tuple(max_w) if isinstance(max_w, (tuple, list)) else (float(max_w),)
        mx, mw = self.stats.get(name, (0.0, (0.0,) * len(mw_new)))
        if len(mw) != len(mw_new):
            raise ValueError(f"inconsistent weight width for {name!r}: "
                             f"{len(mw)} vs {len(mw_new)}")
        self.stats[name] = (max(mx, max_x),
                            tuple(max(a, b) for a, b in zip(mw, mw_new)))

    def scales(self) -> QuantScales:
        return QuantScales.from_max_abs(self.stats)


_scale_recorder: ContextVar[Optional[ScaleRecorder]] = ContextVar(
    "quant_scale_recorder", default=None)


@contextmanager
def record_scales() -> Iterator[ScaleRecorder]:
    """Collect max-abs stats from every named routed matmul in the block."""
    rec = ScaleRecorder()
    token = _scale_recorder.set(rec)
    try:
        yield rec
    finally:
        _scale_recorder.reset(token)


def maybe_record(name: Optional[str], x: torch.Tensor, w: torch.Tensor) -> None:
    """Feed one matmul's operands to the active recorder, if any (reads the
    maxima back to the host)."""
    rec = _scale_recorder.get()
    if rec is None or not name:
        return
    w_cols = w.abs().amax(dim=tuple(range(w.dim() - 1)))  # per N column
    rec.update(name, float(x.abs().max()), tuple(w_cols.cpu().tolist()))

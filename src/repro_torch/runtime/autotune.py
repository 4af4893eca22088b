"""Measured arype/vpe crossover calibration: the port's copy of
``repro/runtime/autotune.py``.

The router's placement rule (route to the VPE when systolic utilization is
below ``tau`` and the working set fits ``vpe_max_elems``) ships with the
paper's analytic constants.  This module measures the crossover on a device:

  1. :func:`measure_crossover` times both engine paths over a grid of
     (m, k, n) shapes: ``router.matmul`` with the policy forced to
     ``arype_only`` and then ``vpe_only``, which on the card launches the
     hand-written ``mm_fused`` and ``vpe_mm`` and on a CPU tensor runs their
     plain versions.
  2. :func:`fit_crossover` fits the timings into the two thresholds: ``tau``
     is the utilization boundary that best separates VPE-faster from
     AryPE-faster shapes (a 1-D decision stump over candidate midpoints),
     ``vpe_max_elems`` caps the VPE path at the largest working set it won.
  3. The result persists as a schema-versioned, backend-keyed JSON artifact
     (``~/.cache/octopus/calib-torch-<backend>.json`` by default) that
     :func:`load_calibration` and :meth:`RuntimeConfig.calibrated` apply.

The artifact's name differs from the reference's ``calib-<backend>.json``
in the same directory: a JAX-measured CPU artifact would pass a backend
check and apply thresholds JAX measured.  An artifact whose fingerprint
lacks the port's keys (``backend``, ``device_kind``, ``torch``) is refused
as malformed.  At M <= 8 both engines launch ``mm_fused``'s skinny kernel
(the same bits), so their times there tie and what the fit reads at those
shapes is noise.

``python -m repro_torch.launch.calibrate`` is the CLI front end.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.runtime import platform
from repro_torch.runtime.config import RuntimeConfig
from repro_torch.runtime.quant import QuantScales
from repro_torch.runtime.routing import mxu_utilization

SCHEMA_VERSION = 1
FINGERPRINT_KEYS = ("backend", "device_kind", "torch")

# The sweep grid (the reference's): the paper's small-network shapes (conv1's
# skinny matmuls that belong on the VPE) through blocks that fill the array.
_FULL_M = (8, 64, 512, 4096)
_FULL_K = (3, 16, 64, 256)
_FULL_N = (8, 32, 128, 512)
_SMOKE_M = (8, 512)
_SMOKE_K = (3, 64)
_SMOKE_N = (8, 128)


def default_grid(smoke: bool = False) -> List[Tuple[int, int, int]]:
    """The (m, k, n) sweep grid; ``smoke`` is the 8-point subset."""
    ms, ks, ns = (_SMOKE_M, _SMOKE_K, _SMOKE_N) if smoke else (_FULL_M, _FULL_K, _FULL_N)
    return [(m, k, n) for m in ms for k in ks for n in ns]


@dataclass(frozen=True)
class ShapeTiming:
    """One measured grid point: both engine paths timed for an (m,k,n) matmul."""

    m: int
    k: int
    n: int
    util: float
    us_arype: float
    us_vpe: float

    @property
    def elems(self) -> int:
        return self.m * self.k * self.n

    @property
    def vpe_wins(self) -> bool:
        return self.us_vpe < self.us_arype


@dataclass(frozen=True)
class Calibration:
    """A fitted, persistable crossover measurement for one backend.

    ``quant_scales`` optionally carries the per-layer int8 scales fitted from
    a traffic sample (``repro_torch.launch.calibrate --quant``); an artifact
    without them loads as None."""

    tau: float
    vpe_max_elems: int
    fingerprint: Dict[str, str]
    timings: Tuple[ShapeTiming, ...] = ()
    schema_version: int = SCHEMA_VERSION
    created_unix: float = field(default_factory=time.time)
    quant_scales: Optional[QuantScales] = None

    @property
    def backend(self) -> str:
        return self.fingerprint.get("backend", "unknown")

    @property
    def fingerprint_id(self) -> str:
        return platform.fingerprint_id(self.fingerprint)

    def apply(self, base: Optional[RuntimeConfig] = None) -> RuntimeConfig:
        """``base`` (the analytic default when None) with the measured
        thresholds and this calibration's fingerprint stamped on.  Scales
        travel with the artifact; running int8 stays an explicit opt-in
        (``quantize``)."""
        cfg = base if base is not None else RuntimeConfig()
        kw = dict(tau=self.tau, vpe_max_elems=self.vpe_max_elems,
                  calibration=self.fingerprint_id)
        if self.quant_scales is not None:
            kw["quant_scales"] = self.quant_scales
        return cfg.replace(**kw)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["quant_scales"] = self.quant_scales.to_dict() if self.quant_scales else None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        timings = tuple(ShapeTiming(**t) for t in d.get("timings", ()))
        qs = d.get("quant_scales")
        fp = d["fingerprint"]
        return cls(tau=float(d["tau"]), vpe_max_elems=int(d["vpe_max_elems"]),
                   fingerprint={k: str(fp[k]) for k in FINGERPRINT_KEYS}, timings=timings,
                   schema_version=int(d["schema_version"]),
                   created_unix=float(d.get("created_unix", 0.0)),
                   quant_scales=QuantScales.from_dict(qs) if qs else None)


# ---------------------------------------------------------------- measurement


def _time_call(fn, device: torch.device, *, warmup: int = 1, iters: int = 5) -> float:
    """Median wall seconds a call, each call waited for on the card (the
    first call builds the kernel library: ``warmup`` covers it)."""
    def call():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def measure_crossover(
    shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
    *,
    config: Optional[RuntimeConfig] = None,
    device: Device = None,
    warmup: int = 1,
    iters: int = 5,
) -> List[ShapeTiming]:
    """Time the AryPE and VPE paths of ``router.matmul`` for every shape of
    the grid on ``device`` (the card unless the caller names another),
    under ``config`` (the analytic default when None) with the policy
    forced.  Operands are standard normals from seeds 0 (x) and 1 (w)."""
    from repro_torch.core import router

    dev = resolve_device(device)
    base = config if config is not None else RuntimeConfig()
    shapes = list(shapes) if shapes is not None else default_grid()
    timings: List[ShapeTiming] = []
    for m, k, n in shapes:
        x = torch.randn(m, k, generator=torch.Generator().manual_seed(0)).to(dev)
        w = torch.randn(k, n, generator=torch.Generator().manual_seed(1)).to(dev)
        per_path = {}
        for policy in ("arype_only", "vpe_only"):
            cfg = base.replace(policy=policy)
            per_path[policy] = _time_call(lambda cfg=cfg: router.matmul(x, w, config=cfg), dev,
                                          warmup=warmup, iters=iters)
        util = mxu_utilization(m, k, n, tile=base.mxu_tile, fill=base.fill_depth)
        timings.append(ShapeTiming(m, k, n, util, us_arype=per_path["arype_only"] * 1e6,
                                   us_vpe=per_path["vpe_only"] * 1e6))
    return timings


# ---------------------------------------------------------------- fit


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length()


def fit_crossover(timings: Sequence[ShapeTiming], *,
                  base: Optional[RuntimeConfig] = None) -> Tuple[float, int]:
    """Fit measured timings into ``(tau, vpe_max_elems)``.

    ``tau`` is the utilization threshold whose rule "vpe iff util < tau"
    agrees with the most measurements (ties go to the smaller threshold:
    the throughput engine when the data is ambiguous).  ``vpe_max_elems``
    is the largest working set the VPE won, rounded up to a power of two;
    with no VPE win ``tau`` closes below the smallest utilization seen and
    ``vpe_max_elems`` stays ``base``'s (the analytic default when None)."""
    cfg = base if base is not None else RuntimeConfig()
    if not timings:
        return cfg.tau, cfg.vpe_max_elems
    pts = sorted(timings, key=lambda t: t.util)
    wins = [t.vpe_wins for t in pts]
    if not any(wins):
        return max(pts[0].util / 2, 1e-6), cfg.vpe_max_elems
    utils = [t.util for t in pts]
    candidates = [max(utils[0] / 2, 1e-6)]
    candidates += [(a + b) / 2 for a, b in zip(utils, utils[1:]) if a < b]
    candidates.append(1.0)
    best_tau, best_score = candidates[0], -1
    for tau in candidates:
        score = sum(1 for t, w in zip(pts, wins) if (t.util < tau) == w)
        if score > best_score:
            best_tau, best_score = tau, score
    vpe_max = max(t.elems for t in pts if t.vpe_wins)
    return best_tau, _next_pow2(vpe_max)


def calibrate(
    shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
    *,
    smoke: bool = False,
    config: Optional[RuntimeConfig] = None,
    device: Device = None,
    warmup: int = 1,
    iters: int = 5,
) -> Calibration:
    """Measure and fit on ``device``: the one-call form of the CLI and tests."""
    dev = resolve_device(device)
    base = config if config is not None else RuntimeConfig()
    shapes = list(shapes) if shapes is not None else default_grid(smoke=smoke)
    timings = measure_crossover(shapes, config=base, device=dev, warmup=warmup, iters=iters)
    tau, vpe_max_elems = fit_crossover(timings, base=base)
    return Calibration(tau=tau, vpe_max_elems=vpe_max_elems,
                       fingerprint=platform.fingerprint(dev), timings=tuple(timings))


# ---------------------------------------------------------------- persistence


def cache_dir() -> str:
    """``$OCTOPUS_CACHE_DIR`` or ``~/.cache/octopus``."""
    return os.environ.get("OCTOPUS_CACHE_DIR",
                          os.path.join(os.path.expanduser("~"), ".cache", "octopus"))


def cache_path(backend: Optional[str] = None, *, device: Device = None) -> str:
    """The backend-keyed default artifact path (``backend`` of ``device``
    when not given)."""
    return os.path.join(cache_dir(),
                        f"calib-torch-{backend or platform.backend(device)}.json")


def save_calibration(calib: Calibration, path: Optional[str] = None) -> str:
    """Write the artifact (default: the backend-keyed cache path); returns it."""
    path = path or cache_path(calib.backend)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(calib.to_dict(), f, indent=1, sort_keys=True)
    return path


def load_calibration(path: Optional[str] = None, backend: Optional[str] = None, *,
                     device: Device = None) -> Optional[Calibration]:
    """Load an artifact (default: the cache path of ``backend``, else of
    ``device``'s backend).

    Returns None, always with a warning naming the reason, when the file is
    missing, unreadable, of another schema version, malformed, or measured
    on another backend than ``backend`` (``device``'s when not given), so
    callers keep the analytic defaults instead of applying a stale or
    foreign measurement."""
    want = backend or platform.backend(device)
    path = path or cache_path(want)
    if not os.path.exists(path):
        warnings.warn(f"no calibration artifact at {path}; using analytic routing defaults "
                      "(run `python -m repro_torch.launch.calibrate`)", stacklevel=2)
        return None
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        warnings.warn(f"unreadable calibration artifact {path} ({e}); using analytic "
                      "routing defaults", stacklevel=2)
        return None
    version = raw.get("schema_version") if isinstance(raw, dict) else None
    if version != SCHEMA_VERSION:
        warnings.warn(f"calibration artifact {path} has schema_version={version!r}, expected "
                      f"{SCHEMA_VERSION}; re-run `python -m repro_torch.launch.calibrate` "
                      "(using analytic routing defaults)", stacklevel=2)
        return None
    try:
        calib = Calibration.from_dict(raw)
    except (KeyError, TypeError, ValueError) as e:
        warnings.warn(f"malformed calibration artifact {path} ({e}); using analytic "
                      "routing defaults", stacklevel=2)
        return None
    if calib.backend != want:
        warnings.warn(f"calibration artifact {path} was measured on backend="
                      f"{calib.backend!r} but this process runs {want!r}; using analytic "
                      "routing defaults", stacklevel=2)
        return None
    return calib

"""Synthetic packet trace for the in-network use-cases: one finite trace in
which every flow sends exactly ``pkts_per_flow`` packets, interleaved in
arrival order, with class-dependent statistics (packet sizes, inter-arrival
times, directions, flags, payload bytes) so the three use-case models have
something to learn.

Deterministic in ``seed``: the numpy draws are the JAX package's
``synth_packet_trace``'s, in the same order, so a config gives the same
trace there and here.  The packets come out as tensors on a chosen device
(the card unless another is named).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.common.util import Device, resolve_device
from repro_torch.core.flow_tracker import PacketBatch, hash_slot_scalar


@dataclass(frozen=True)
class PacketTraceConfig:
    num_flows: int = 256
    pkts_per_flow: int = 20
    num_classes: int = 8
    pay_bytes: int = 16
    seed: int = 0
    malicious_fraction: float = 0.25
    collision_free: bool = True  # tuple hashes chosen to avoid table collisions
    table_size: int = 8192


def synth_packet_trace(cfg: PacketTraceConfig, *, device: Device = None
                       ) -> tuple[PacketBatch, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (packets interleaved in arrival order, flow class (num_flows,),
    flow tuple hash (num_flows,), binary label (num_flows,), 0 malicious).

    Class c flows draw packet sizes ~ N(200+80c, 40) and inter-arrival times
    ~ Exp(50(c+1)) us; malicious flows (a ``malicious_fraction`` of them) use
    small, fast packets and mark their payload, which makes use-case 1's
    binary task and use-cases 2/3's class task learnable."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    F, N = cfg.num_flows, cfg.pkts_per_flow
    classes = rng.integers(0, cfg.num_classes, F)
    malicious = rng.random(F) < cfg.malicious_fraction

    if cfg.collision_free:
        # the first candidates whose table slots are distinct
        hashes, used = [], set()
        for h in rng.integers(1, 2**31 - 1, F * 8).tolist():
            s = hash_slot_scalar(h, cfg.table_size)
            if s not in used:
                used.add(s)
                hashes.append(h)
            if len(hashes) == F:
                break
        tuple_hash = np.asarray(hashes, np.int32)
    else:
        tuple_hash = rng.integers(1, 2**31 - 1, F).astype(np.int32)

    sizes = np.zeros((F, N), np.int32)
    intvs = np.zeros((F, N), np.int32)
    for f in range(F):
        c = classes[f]
        mu_s, mu_t = 200 + 80 * c, 50 * (c + 1)
        if malicious[f]:
            mu_s, mu_t = 64, 5
        sizes[f] = np.clip(rng.normal(mu_s, 40, N), 40, 1500).astype(np.int32)
        intvs[f] = np.clip(rng.exponential(mu_t, N), 1, 10**6).astype(np.int32)

    starts = rng.integers(0, 10**6, F)
    ts = starts[:, None] + np.cumsum(intvs, axis=1)
    dirs = (rng.random((F, N)) < 0.5).astype(np.int32)
    flags = rng.integers(0, 64, (F, N)).astype(np.int32)
    protos = np.repeat(rng.integers(0, 3, F)[:, None], N, axis=1).astype(np.int32)
    payload = rng.integers(0, 256, (F, N, cfg.pay_bytes)).astype(np.int32)
    # class signature in the payload, so use-case 3 is learnable
    payload[..., 0] = (classes[:, None] * 13 + 7) % 256
    payload[..., 1] = np.where(malicious[:, None], 251, payload[..., 1])

    order = np.argsort(ts.reshape(-1), kind="stable")  # interleave flows by arrival

    def take(a: np.ndarray) -> torch.Tensor:
        flat = a.reshape(F * N, *a.shape[2:])[order].astype(np.int32)
        return torch.from_numpy(flat).to(dev)

    packets = PacketBatch(ts=take(ts), size=take(sizes), dir=take(dirs), flags=take(flags),
                          proto=take(protos),
                          tuple_hash=take(np.repeat(tuple_hash[:, None], N, axis=1)),
                          payload=take(payload))
    labels = np.where(malicious, 0, 1)  # binary: malicious = 0
    return packets, classes.astype(np.int32), tuple_hash, labels.astype(np.int32)

"""The flow-feature ALU fold: the meta/history register layouts, the standard
micro-op program, the plain PyTorch fold and the wrapper of the CUDA kernel
``csrc/flow_update.cu``.

A micro-op program has one row per history lane j, ``[opcode, meta_src,
hist_src]``, and folds one packet's meta register ``a = meta[meta_src]`` into
the flow's history register ``b = hist[hist_src]``:

  0 nop : b        1 wr : a        2 add : b + a      3 sub : b - a
  4 max : max(b,a) 5 min : min(b,a) 6 inc : b + 1      other : b

All lanes read the history row as it was before the packet, and int32
arithmetic wraps.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common.util import Device, ceil_div, resolve_device, segment_ranks
from repro_torch.kernels.build import H100_SMS, CudaKernel, check_cuda, sm_count, stream_of

# Meta register layout (int32 lanes; paper Table 2).
META = {
    "pkt_size": 0,
    "arv_intv": 1,  # inter-arrival time (us); 0 for the first packet of a flow
    "dir": 2,  # 0/1
    "flags": 3,  # TCP/UDP/ICMP flags
    "ts": 4,  # arrival timestamp (us, truncated)
    "payload_len": 5,
    "one": 6,  # constant 1
    "zero": 7,  # constant 0
    "size_fwd": 8,  # pkt_size if dir==0 else 0
    "size_bwd": 9,  # pkt_size if dir==1 else 0
    "neg_pkt_size": 10,
    "neg_arv_intv": 11,
    "proto": 12,
}
META_WIDTH = 13

MICRO_OPS = {"nop": 0, "wr": 1, "add": 2, "sub": 3, "max": 4, "min": 5, "inc": 6}

# History-register (flow-state word) layout: 16 int32 lanes (paper Table 7).
HIST = {
    "flow_dur": 0,  # sum of arv_intv
    "pkt_count": 1,  # total number of packets
    "flow_size": 2,  # sum of pkt_size
    "max_size": 3,
    "min_size": 4,
    "max_intv": 5,
    "min_intv": 6,
    "last_ts": 7,  # timestamp of latest packet
    "size_fwd": 8,  # per-direction flow size
    "size_bwd": 9,
    "flags_acc": 10,  # accumulated flags
    "last_size": 11,
    "payload_bytes": 12,  # sum of payload_len
    "proto": 13,
    "spare14": 14,
    "spare15": 15,
}
N_LANES = 16


def default_program_np() -> np.ndarray:
    """The micro-op program deriving the standard flow features from the meta
    set, one row per output lane: [op, meta_src, hist_src]."""
    O, M, H = MICRO_OPS, META, HIST
    rows = [
        (O["add"], M["arv_intv"], H["flow_dur"]),
        (O["inc"], M["zero"], H["pkt_count"]),
        (O["add"], M["pkt_size"], H["flow_size"]),
        (O["max"], M["pkt_size"], H["max_size"]),
        (O["min"], M["pkt_size"], H["min_size"]),
        (O["max"], M["arv_intv"], H["max_intv"]),
        (O["min"], M["arv_intv"], H["min_intv"]),
        (O["wr"], M["ts"], H["last_ts"]),
        (O["add"], M["size_fwd"], H["size_fwd"]),
        (O["add"], M["size_bwd"], H["size_bwd"]),
        (O["add"], M["flags"], H["flags_acc"]),
        (O["wr"], M["pkt_size"], H["last_size"]),
        (O["add"], M["payload_len"], H["payload_bytes"]),
        (O["wr"], M["proto"], H["proto"]),
        (O["nop"], M["zero"], H["spare14"]),
        (O["nop"], M["zero"], H["spare15"]),
    ]
    return np.array(rows, dtype=np.int32)


def default_program(device: Device = None) -> torch.Tensor:
    return torch.as_tensor(default_program_np(), device=resolve_device(device))


def check_program(program: torch.Tensor) -> None:
    """Refuse a program the fold cannot run: it must be (16, 3) int32 with
    every source index inside its register."""
    if program.shape != (N_LANES, 3) or program.dtype != torch.int32:
        raise ValueError(f"program must be ({N_LANES}, 3) int32, got "
                         f"{tuple(program.shape)} {program.dtype}")
    p = program.cpu().numpy()
    if not ((0 <= p[:, 1]).all() and (p[:, 1] < META_WIDTH).all()
            and (0 <= p[:, 2]).all() and (p[:, 2] < N_LANES).all()):
        raise ValueError("program meta_src must lie in [0, 13) and hist_src in [0, 16)")


def apply_alu_program(program: torch.Tensor, meta: torch.Tensor,
                      hist: torch.Tensor) -> torch.Tensor:
    """The 16-lane ALU cluster, batched: meta (..., 13), hist (..., 16) ->
    new hist (..., 16) int32."""
    opcode = program[:, 0]
    a = meta[..., program[:, 1].long()]  # meta source per lane
    b = hist[..., program[:, 2].long()]  # history source per lane
    out = b  # nop, and the default of an undefined opcode
    out = torch.where(opcode == 1, a, out)
    out = torch.where(opcode == 2, b + a, out)
    out = torch.where(opcode == 3, b - a, out)
    out = torch.where(opcode == 4, torch.maximum(b, a), out)
    out = torch.where(opcode == 5, torch.minimum(b, a), out)
    out = torch.where(opcode == 6, b + 1, out)
    return out.to(torch.int32)


def flow_feature_update_plain(program: torch.Tensor, slots: torch.Tensor,
                              meta: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: fold packet i's meta into row ``slots[i]``,
    packets of one slot in batch order.  ``slots`` lie in [0, F]; slot F is a
    scratch row that is dropped (padding, ``keep == False``).

    Packets sort by slot (stable) and fold round by round: round r applies
    the r-th packet of every slot at once, so rounds never touch a row
    twice."""
    f = table.shape[0]
    if slots.numel() and not 0 <= int(slots.min()) <= int(slots.max()) <= f:
        raise ValueError(f"slots must lie in [0, {f}]")
    ext = torch.cat([table, table.new_zeros((1, N_LANES))])
    s_slot, order = torch.sort(slots.long(), stable=True)
    rank = segment_ranks(s_slot)
    s_meta = meta[order]
    rounds = int(rank.max()) + 1 if rank.numel() else 0
    for r in range(rounds):
        sel = rank == r
        rows = s_slot[sel]
        ext[rows] = apply_alu_program(program, s_meta[sel], ext[rows])
    return ext[:f]


FLOW_CAP = 4096  # packets a chunk: the keys a CTA sorts in shared memory at most
FLOW_ROWS = 32  # rows a CTA aims at where the table is small
FLOW_CTAS_PER_SM = 2  # the grid's most CTAs an SM before a CTA takes more rows


class FlowPlan(NamedTuple):
    """How ``flow_update`` folds P packets into an F-row table: ``variant``
    "single" (P <= ``cap``: one chunk, the rows read from the input table) or
    "chunked" (the batch in chunks of ``cap`` packets, later chunks reading the
    rows the CTA stored), over ``ctas`` CTAs that own ``rows`` rows each.  The
    launcher runs the variant it is given."""
    variant: str
    ctas: int
    rows: int
    cap: int

    @property
    def index_bits(self) -> int:
        """Low bits of a sort key: the packet's index in its chunk."""
        return self.cap.bit_length() - 1


def flow_plan(p: int, f: int, sms: int = H100_SMS) -> FlowPlan:
    """The one place that sizes ``flow_update`` for P packets and F >= 1 rows.

    CTA c owns rows [c * rows, (c + 1) * rows) and sorts the keys
    ``(row - c * rows) << index_bits | index`` of its packets a chunk, so a key
    is 32 bits at every P and F: :data:`FLOW_ROWS` rows a CTA, up to
    :data:`FLOW_CTAS_PER_SM` CTAs an SM (the pipeline's 8k table: 256 CTAs of
    32 rows; on an H100 128-512 CTAs measured within 0.17 us of each other
    there, 64 and 32 slower, PERF.md §6), then as many rows as the table
    needs, but never so many that a key
    reaches the sort's pad 0xFFFFFFFF (rows < 2^(32 - index_bits), which only
    a table past a billion rows would need more CTAs for).  The chunk is
    :data:`FLOW_CAP` packets (16 KB of keys): a batch up to it is one chunk,
    a larger one the "chunked" variant, which the plan picks from P alone."""
    max_rows = 2 ** (32 - (FLOW_CAP.bit_length() - 1)) - 1
    ctas = max(min(ceil_div(f, FLOW_ROWS), FLOW_CTAS_PER_SM * sms), ceil_div(f, max_rows))
    return FlowPlan("single" if p <= FLOW_CAP else "chunked", ctas, ceil_div(f, ctas), FLOW_CAP)


FLOW_UPDATE = CudaKernel("flow_update_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p])


def flow_feature_update(program: torch.Tensor, slots: torch.Tensor,
                        meta: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Fold a packet stream (``slots`` (P,) in any order, ``meta`` (P, 13))
    into a new (F, 16) int32 table; the input table is left as it is.  The
    packets of one slot fold in batch order; slots outside [0, F) are
    dropped.

    On a CPU table this is the plain fold; on a CUDA table one launch of the
    ``flow_update`` kernel, which copies the table and orders the packets
    itself (:func:`flow_plan`): the only other op is the output's
    allocation (and an empty table launches nothing)."""
    if table.device.type == "cpu":
        return flow_feature_update_plain(program, slots, meta, table)
    if table.device.type != "cuda":
        raise ValueError(f"flow_feature_update: no kernel for {table.device}")
    p, f = slots.shape[0], table.shape[0]
    if (program.shape != (N_LANES, 3) or slots.dim() != 1 or table.shape[1:] != (N_LANES,)
            or meta.shape != (p, META_WIDTH)):
        raise ValueError(f"flow_feature_update: shapes program {tuple(program.shape)}, "
                         f"slots {tuple(slots.shape)}, meta {tuple(meta.shape)}, "
                         f"table {tuple(table.shape)}")
    for t in (program, slots, meta, table):
        if t.dtype != torch.int32:
            raise ValueError(f"flow_feature_update: needs int32, got {t.dtype}")
    check_cuda("flow_feature_update", program, slots, meta, table)
    out = torch.empty_like(table)
    if f:
        plan = flow_plan(p, f, sm_count(table.device))
        FLOW_UPDATE(out.device, program.data_ptr(), slots.data_ptr(), meta.data_ptr(),
                    table.data_ptr(), out.data_ptr(), p, f, META_WIDTH, plan.ctas, plan.cap,
                    plan.variant == "chunked", stream_of(out))
    return out


def fold_features(program: torch.Tensor, slots: torch.Tensor, meta: torch.Tensor,
                  feats: torch.Tensor, *, keep: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """:func:`flow_feature_update` with an optional (P,) bool ``keep`` mask:
    packets with ``keep == False`` go to the dropped slot F and touch no
    flow's row (a zeroed meta is not a no-op for ``wr``/``min`` lanes)."""
    if keep is not None:
        slots = torch.where(keep, slots, feats.shape[0]).to(torch.int32)
    return flow_feature_update(program, slots, meta, feats)

"""The plan that sizes ``flow_update`` (``flow_plan``) and the kernel's way of
ordering a batch (``csrc/flow_update.cu``), on the CPU, without a card or
nvcc:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flow_plan.py

The emulation follows the kernel CTA by CTA: CTA c copies the rows it owns,
then walks the batch in chunks of the plan's cap; each chunk's packets of
owned rows are appended as 32-bit keys (local row << index bits | index in
the chunk) in an arbitrary order (the warps' atomics) and sorted as the
kernel sorts them: up to one key a thread, each to its rank; past that,
padded to a power of two with 0xFFFFFFFF and through the kernel's bitonic
network (its compare-exchange indices, stage by stage); segment heads are where the row
changes, and each segment folds in key order over the row read from the
input table (the first chunk) or from the output (a later chunk).  No bitmap
of touched rows is needed: a CTA copies all its rows before it folds any, so
a fold's store is the later one.  The result is held bit for bit to
``flow_feature_update_plain``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flow_features import ops as ff
from repro_torch.kernels.flow_features.ops import FLOW_CAP, FlowPlan, flow_plan

CAP = FLOW_CAP
THREADS = 256  # csrc/flow_update.cu kThreads: keys up to it are sorted by rank
PAD = np.uint32(0xFFFFFFFF)
INT_MIN, INT_MAX = np.iinfo(np.int32).min, np.iinfo(np.int32).max


def bitonic(keys: np.ndarray) -> np.ndarray:
    """The kernel's ``bitonic_sort`` on a power-of-two array: pair t of stage
    (k, j) compares lo = 2t - (t & (j - 1)) with lo + j, ascending where
    lo & k == 0."""
    keys = keys.copy()
    n2 = keys.shape[0]
    t = np.arange(n2 // 2)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            lo = 2 * t - (t & (j - 1))
            a, b = keys[lo], keys[lo + j]
            swap = (a > b) == ((lo & k) == 0)
            keys[lo[swap]], keys[lo[swap] + j] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return keys


def alu(program: np.ndarray, meta_row: np.ndarray, h: np.ndarray) -> np.ndarray:
    """One packet on the 16 lanes as the kernel's ``Step`` computes it: every
    op is min(max(b + d, lo), hi) with (d, lo, hi) from the op and the meta
    value a alone, b the lane ``hist_src`` of the pre-packet row, b + d
    wrapping in 32 bits."""
    op = program[:, 0]
    a = meta_row[program[:, 1]].astype(np.int64)
    b = h[program[:, 2]].astype(np.int64)
    d = np.select([op == 2, op == 3, op == 6], [a, -a, 1], 0)
    lo = np.where((op == 1) | (op == 4), a, INT_MIN)
    hi = np.where((op == 1) | (op == 5), a, INT_MAX)
    wrapped = (b + d).astype(np.uint32).astype(np.int32).astype(np.int64)
    return np.minimum(np.maximum(wrapped, lo), hi).astype(np.int32)


def emulate(program, slots, meta, table, plan: FlowPlan, rng) -> np.ndarray:
    p, f = slots.shape[0], table.shape[0]
    ib = plan.index_bits
    out = np.empty_like(table)
    for c in range(plan.ctas):
        f0 = min(f, c * plan.rows)
        nrows = min(f, f0 + plan.rows) - f0
        out[f0:f0 + nrows] = table[f0:f0 + nrows]
        for base in range(0, max(p, 1), plan.cap):
            chunk = slots[base:base + plan.cap]
            row = chunk.astype(np.uint32) - np.uint32(f0)  # a slot below f0 wraps
            own = row < nrows
            keys = (row[own] << np.uint32(ib)) | np.flatnonzero(own).astype(np.uint32)
            assert (keys < PAD).all()
            keys = rng.permutation(keys)  # the appends land in any order
            n = keys.shape[0]
            if n <= THREADS:  # each key to its rank
                ranked = np.empty_like(keys)
                ranked[(keys[None, :] < keys[:, None]).sum(axis=1)] = keys
                keys = ranked
            else:
                n2 = 1 << (n - 1).bit_length()
                padded = np.full(n2, PAD, np.uint32)
                padded[:n] = keys
                keys = bitonic(padded)[:n]
            np.testing.assert_array_equal(keys, np.sort(keys))
            src = out if base > 0 else table
            rows_of = keys >> np.uint32(ib)
            for s in np.flatnonzero(np.r_[True, rows_of[1:] != rows_of[:-1]][:n]):
                r = f0 + int(rows_of[s])
                h = src[r].copy()
                e = s
                while e < n and rows_of[e] == rows_of[s]:
                    h = alu(program, meta[base + int(keys[e] & np.uint32(plan.cap - 1))], h)
                    e += 1
                out[r] = h
    return out


def wrapping_ints(rng, shape) -> np.ndarray:
    edge = rng.choice([INT_MIN, INT_MIN + 1, -1, 0, 1, INT_MAX - 1, INT_MAX], size=shape)
    mid = rng.integers(INT_MIN, INT_MAX, size=shape, endpoint=True)
    return np.where(rng.random(shape) < 0.5, edge, mid).astype(np.int32)


def cross_lane_program(rng) -> np.ndarray:
    return np.stack([rng.permutation(np.arange(16) % 7), rng.integers(0, 13, 16),
                     rng.integers(0, 16, 16)], axis=1).astype(np.int32)


# (P, F, slots, program): slots "spread" over [0, F] (F dropped), "colliding"
# on 3 slots, "one" slot for every packet, "dropped" all F
CASES = {
    "p1": (1, 1000, "spread", "default"),
    "p31": (31, 1000, "spread", "cross"),
    "cap-1": (CAP - 1, 8192, "spread", "default"),
    "cap": (CAP, 8192, "spread", "cross"),
    "cap+1": (CAP + 1, 8192, "spread", "cross"),
    "3cap": (3 * CAP, 65536, "spread", "default"),
    "f1": (300, 1, "spread", "cross"),
    "f1000": (1024, 1000, "spread", "cross"),
    "f65536": (1024, 65536, "spread", "default"),
    "pipeline": (1024, 8192, "spread", "default"),
    "colliding": (1024, 8192, "colliding", "cross"),
    "dropped": (1024, 8192, "dropped", "cross"),
    "one-slot": (1024, 8192, "one", "cross"),
    "one-slot-chunked": (CAP + 1, 8192, "one", "default"),
    # the sharded pipeline's bank: 4 lanes of the 8k table as 32768 rows
    "lanes": (1024, 4 * 8192, "spread", "default"),
    "lanes-chunked": (2 * CAP, 4 * 8192, "spread", "cross"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_equals_the_plain_fold(case):
    p, f, kind, prog = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    program = ff.default_program_np() if prog == "default" else cross_lane_program(rng)
    slots = {"spread": lambda: rng.integers(0, f + 1, p),
             "colliding": lambda: rng.integers(0, 3, p),
             "one": lambda: np.full(p, f // 2),
             "dropped": lambda: np.full(p, f)}[kind]().astype(np.int32)
    meta = wrapping_ints(rng, (p, ff.META_WIDTH))
    table = wrapping_ints(rng, (f, 16))
    plan = flow_plan(p, f)
    got = emulate(program, slots, meta, table, plan, rng)
    want = ff.flow_feature_update_plain(*map(torch.as_tensor, (program, slots, meta, table)))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("p,variant", [(0, "single"), (1, "single"), (CAP - 1, "single"),
                                       (CAP, "single"), (CAP + 1, "chunked"),
                                       (3 * CAP, "chunked")])
def test_plan_variant_is_picked_by_p(p, variant):
    for f in (1, 8192, 65536):
        assert flow_plan(p, f).variant == variant


def test_plan_at_the_pipeline_shape():
    """The smoke's 8k table at batch 1024: one chunk over 256 CTAs of 32
    rows, about 4 packets a CTA for spread slots."""
    assert flow_plan(1024, 8192) == FlowPlan("single", 256, 32, CAP)


@pytest.mark.parametrize("f", [1, 63, 64, 65, 1000, 8192, 65536, 2**20, 2**27, 2**31 - 1])
@pytest.mark.parametrize("sms", [114, 132])
def test_plan_owns_every_row_once_with_32_bit_keys(f, sms):
    """CTA c owns rows [c * rows, (c + 1) * rows): every row has one owner, a
    CTA no more than FLOW_ROWS rows until the grid has FLOW_CTAS_PER_SM CTAs
    an SM, and no more CTAs than that unless the keys need them."""
    plan = flow_plan(1024, f, sms)
    most = ff.FLOW_CTAS_PER_SM * sms
    assert plan.ctas * plan.rows >= f
    assert plan.rows <= max(ff.FLOW_ROWS, -(-f // most))
    assert plan.ctas <= max(most, -(-f // (2**(32 - plan.index_bits) - 1)))
    # the largest key stays below the sort's pad
    assert ((plan.rows - 1) << plan.index_bits) | (plan.cap - 1) < 0xFFFFFFFF
    assert plan.cap & (plan.cap - 1) == 0 and plan.cap * 4 <= 48 * 1024


@pytest.mark.parametrize("seed", range(4))
def test_step_form_equals_the_alu(seed):
    """The kernel's three-op step equals the 16-lane ALU on every opcode (7
    and -1 undefined) and on values at both ends of int32."""
    rng = np.random.default_rng(seed)
    for _ in range(64):
        program = cross_lane_program(rng)
        program[rng.integers(0, 16, 2), 0] = [7, -1]
        meta = wrapping_ints(rng, (ff.META_WIDTH,))
        h = wrapping_ints(rng, (16,))
        want = ff.apply_alu_program(torch.as_tensor(program), torch.as_tensor(meta),
                                    torch.as_tensor(h))
        np.testing.assert_array_equal(alu(program, meta, h), want.numpy())


def test_bitonic_network_sorts_every_power_of_two():
    rng = np.random.default_rng(0)
    for n2 in (1, 2, 4, 32, 64, 1024, CAP):
        keys = rng.permutation(rng.choice(2**32 - 1, n2, replace=False).astype(np.uint32))
        np.testing.assert_array_equal(bitonic(keys), np.sort(keys))

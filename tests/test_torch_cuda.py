"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; on a host without them each
one skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only the
port is installed."""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import flow_tracker as ft
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.kernels.arype_matmul.ops import arype_matmul, mm_fused
from repro_torch.kernels.flow_features import ops as ff
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_mm
from repro_torch.models.paper_models import init_paper_model
from repro_torch.serving import OctopusPipeline, PipelineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("engine,plain", [(vpe_matmul, vpe_mm), (arype_matmul, mm_fused)])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 5, 7), (1024, 6, 12), (5120, 3, 32),
                                   (2560, 96, 32), (129, 300, 65), (256, 128, 162)])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_matmul_kernels_match_plain(cuda, engine, plain, m, k, n, act):
    gen = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    before = kernels.launches()
    out = engine(x, w, activation=act)
    ref = plain(x, w, activation=act)
    assert sum(kernels.launches().values()) == sum(before.values()) + 1
    # only the order of the f32 sums differs
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("segments", ["spread", "colliding"])
@pytest.mark.parametrize("cross_lane", [False, True])
def test_flow_update_kernel_is_bit_exact(cuda, segments, cross_lane):
    gen = torch.Generator().manual_seed(int(cross_lane))
    F, P = 8192, 1024
    program = ff.default_program("cpu")
    if cross_lane:
        program = torch.stack([torch.arange(16) % 7, torch.randint(0, 13, (16,), generator=gen),
                               torch.randint(0, 16, (16,), generator=gen)], 1).to(torch.int32)
    hi = F + 1 if segments == "spread" else 3
    slots = torch.randint(0, hi, (P,), generator=gen).to(torch.int32)
    rand32 = lambda *s: torch.randint(-2**31, 2**31, s, generator=gen,
                                      dtype=torch.int64).to(torch.int32)
    args = [a.to(cuda) for a in (program, slots, rand32(P, 13), rand32(F, 16))]
    assert torch.equal(ff.flow_feature_update(*args), ff.flow_feature_update_plain(*args))


def test_pipeline_on_card_matches_cpu(cuda):
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024)
    gpu = OctopusPipeline(mlp, cnn, cfg)
    cpu = OctopusPipeline(mlp, cnn, cfg, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    kernels.reset_launches()
    for _ in range(12):
        batch = gen.next_batch()
        out_g = gpu.step(ft.PacketBatch(*(a.to(cuda) for a in batch)))
        out_c = cpu.step(batch)
        for a, b in zip(gpu.state, cpu.state):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
    assert all(n > 0 for n in kernels.launches().values())
    assert np.isfinite(gpu.stats.step_us)

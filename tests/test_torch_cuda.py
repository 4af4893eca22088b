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
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.kernels.arype_matmul.ops import arype_matmul, arype_matmul_q, mm_fused, mm_fused_q
from repro_torch.kernels.flow_features import ops as ff
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul, vpe_matmul_q, vpe_mm, vpe_mm_q
from repro_torch.launch.calibrate import calibrate_quant_scales
from repro_torch.models.paper_models import init_paper_model
from repro_torch.runtime import RuntimeConfig
from repro_torch.runtime.quant import pick_scale
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


@pytest.mark.parametrize("engine,plain", [(vpe_matmul_q, vpe_mm_q), (arype_matmul_q, mm_fused_q)])
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 5, 7), (1024, 6, 12), (1024, 12, 6),
                                   (1024, 6, 3), (1024, 3, 2), (5120, 3, 32), (2560, 96, 32),
                                   (1280, 96, 32), (256, 96, 128), (256, 128, 162)])
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
def test_int8_kernels_match_plain(cuda, engine, plain, m, k, n, per_channel, act):
    gen = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=gen) * 3).to(cuda)
    w = torch.randn(k, n, generator=gen).to(cuda)
    sx = pick_scale(x.abs().max().item())
    sw = (tuple(pick_scale(v) for v in w.abs().amax(0).tolist()) if per_channel
          else pick_scale(w.abs().max().item()))
    before = kernels.launches()
    out = engine(x, w, scale_x=sx, scale_w=sw, activation=act)
    ref = plain(x, w, scale_x=sx, scale_w=sw, activation=act)
    assert sum(kernels.launches().values()) == sum(before.values()) + 1
    if act in ("none", "relu"):  # integer sums and one f32 product: bit for bit
        assert torch.equal(out, ref)
    else:  # the activation's exp/tanh differ between the kernel and torch
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
    counts = kernels.launches()
    assert all(counts[name] > 0 for name in ("flow_update", "vpe_mm", "mm_fused"))
    assert counts["vpe_mm_q"] == counts["mm_fused_q"] == 0  # the f32 path
    assert np.isfinite(gpu.stats.step_us)


def test_int8_pipeline_on_card_matches_cpu(cuda):
    mlp = init_paper_model("mlp", torch.Generator().manual_seed(1), device="cpu")
    cnn = init_paper_model("cnn", torch.Generator().manual_seed(2), device="cpu")
    table = calibrate_quant_scales(mlp, cnn, max_flip_rate=None, device="cpu")
    runtime = RuntimeConfig(quantize=True, quant_scales=table)
    cfg = PipelineConfig(batch_size=256, max_ready=64, table_size=1024)
    gpu = OctopusPipeline(mlp, cnn, cfg, config=runtime)
    cpu = OctopusPipeline(mlp, cnn, cfg, config=runtime, device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=256, active_flows=64, table_size=1024,
                                         elephant_fraction=0.5), device="cpu")
    steps, counts = 12, dict.fromkeys(kernels.launches(), 0)
    for _ in range(steps):
        batch = gen.next_batch()
        batch_g = ft.PacketBatch(*(a.to(cuda) for a in batch))
        kernels.reset_launches()
        out_g = gpu.step(batch_g)
        counts = {name: counts[name] + n for name, n in kernels.launches().items()}
        out_c = cpu.step(batch)
        for a, b in zip(gpu.state, cpu.state):
            assert torch.equal(a.cpu(), b)
        for a, b in zip(out_g.drained, out_c.drained):
            assert torch.equal(a.cpu(), b)
        # integer-valued packet features: the int8 packet logits agree bit for bit
        logits_g = gpu.packet_engine.fn(gpu.packet_engine.params, packet_meta_features(batch_g))
        logits_c = cpu.packet_engine.fn(cpu.packet_engine.params, packet_meta_features(batch))
        assert torch.equal(logits_g.cpu(), logits_c)
        # both engines given the CPU's flow-model input: int8 flow logits bit for bit
        flow_x = cpu.flow_engine.prep(out_c.drained.series, None)
        flow_g = gpu.flow_engine.fn(gpu.flow_engine.params, flow_x.to(cuda))
        assert torch.equal(flow_g.cpu(), cpu.flow_engine.fn(cpu.flow_engine.params, flow_x))
    # the pipeline's own launches per step: w0..w3 and conv1..conv3 on the VPE
    # (conv2/conv3 fit its working-set limit at max_ready 64), fc and linear
    # on the AryPE; every engine layer int8
    want = dict.fromkeys(counts, 0)
    want.update(flow_update=steps, vpe_mm_q=7 * steps, mm_fused_q=2 * steps)
    assert counts == want

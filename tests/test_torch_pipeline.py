"""The port's streaming pipeline (``repro_torch.serving``) against the JAX
package's ``OctopusPipeline`` on the same traffic and parameters, plus the
port's package rules: its generator emits the reference's packets, it never
falls back to the CPU silently, and neither it nor chip_smoke.py imports JAX
or the JAX package.

The JAX pipeline runs without ``use_pallas`` (its Pallas flow kernel does
not run on the installed JAX); the port's CPU pipeline runs the plain
versions of its kernels."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro_torch import convert
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.runtime import RuntimeConfig, record_routes
from repro_torch.serving import OctopusPipeline, PathStats, PipelineConfig

ROOT = Path(__file__).resolve().parent.parent


def params(kind: str, seed: int):
    jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


def assert_tuple_equal(want, got, what: str):
    for name, a, b in zip(want._fields, want, convert.to_numpy(got)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("tracker,traffic_kw,runtime_kw", [
    ("segmented", {}, {}),
    ("scan", {}, {}),
    ("segmented", dict(adversarial="collision_attack", collision_free=False, adv_slots=8), {}),
    # conv2/conv3 leave vpe for mm_fused at test size, in both packages
    ("segmented", {}, dict(vpe_max_elems=1 << 16)),
], ids=["segmented", "scan", "collision_attack", "arype_convs"])
def test_pipeline_matches_reference(tracker, traffic_kw, runtime_kw):
    jmlp, mlp = params("mlp", 1)
    jcnn, cnn = params("cnn", 2)
    shape = dict(batch_size=64, max_ready=48, table_size=256, tracker=tracker)
    jpipe = JOctopusPipeline(jmlp, jcnn, JPipelineConfig(**shape),
                             config=JRuntimeConfig(use_pallas=False, **runtime_kw))
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**shape),
                           config=RuntimeConfig(**runtime_kw), device="cpu")
    tcfg = dict(batch_size=64, active_flows=16, elephant_fraction=0.5, table_size=256, seed=4,
                **traffic_kw)
    jgen = JTrafficGenerator(JTrafficConfig(**tcfg))
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    drained = 0
    for step in range(10):
        jout = jpipe.step(jgen.next_batch())
        out = pipe.step(gen.next_batch())
        assert_tuple_equal(jpipe.state, pipe.state, f"step {step} TrackerState")
        assert_tuple_equal(jout.drained, out.drained, f"step {step} DrainResult")
        np.testing.assert_array_equal(np.asarray(jout.pkt_actions), out.pkt_actions.numpy())
        np.testing.assert_array_equal(np.asarray(jout.flow_cls), out.flow_cls.numpy())
        assert (int(jout.new_flows), int(jout.evicted)) == (int(out.new_flows), int(out.evicted))
        drained += int(out.drained.mask.sum())
    assert drained > 0
    assert pipe.rules.rules == jpipe.rules.rules
    assert pipe.rules.generation == jpipe.rules.generation
    assert (pipe.stats.packets, pipe.stats.flows) == (jpipe.stats.packets, jpipe.stats.flows)


@pytest.mark.parametrize("kw", [{}, dict(adversarial="collision_attack", collision_free=False,
                                         adv_slots=3, active_flows=20)])
def test_traffic_generator_matches_reference(kw):
    cfg = dict(batch_size=48, active_flows=60, table_size=128, seed=9)
    cfg.update(kw)
    jgen = JTrafficGenerator(JTrafficConfig(**cfg))
    gen = TrafficGenerator(TrafficConfig(**cfg), device="cpu")
    for i in range(6):
        assert_tuple_equal(jgen.next_batch(), gen.next_batch(), f"batch {i}")
    assert (gen.flows_started, gen.flows_completed) == (jgen.flows_started, jgen.flows_completed)


def test_run_reset_and_stats():
    _, mlp = params("mlp", 1)
    _, cnn = params("cnn", 2)
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(batch_size=32, max_ready=8, table_size=64),
                           device="cpu")
    pipe.warmup()
    assert pipe.stats.steps == 0 and not pipe.rules.rules
    gen = TrafficGenerator(TrafficConfig(batch_size=32, active_flows=16, table_size=64),
                           device="cpu")
    stats = pipe.run(gen, steps=5)
    assert stats.steps == 5 and stats.packets == 160 and stats.pkt_per_s > 0
    assert stats.total_s == pytest.approx(stats.host_s + stats.device_s)
    assert np.isfinite(stats.p99_us)
    pipe.reset()
    assert pipe.stats.steps == 0 and int(pipe.state.count.sum()) == 0
    with pytest.raises(ValueError, match="batch_size"):
        pipe.step(gen.batches(1).__next__()._replace(ts=torch.zeros(3, dtype=torch.int32)))


def test_step_records_scoped_placement_and_path_stats_drop_empty_calls():
    _, mlp = params("mlp", 1)
    _, cnn = params("cnn", 2)
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(batch_size=16, max_ready=4, table_size=32),
                           device="cpu")
    gen = TrafficGenerator(TrafficConfig(batch_size=16, active_flows=8, table_size=32),
                           device="cpu")
    with record_routes() as routes:
        pipe.step(gen.next_batch())
    assert [r.name for r in routes] == ["pkt/w0", "pkt/w1", "pkt/w2", "pkt/w3", "flow/conv1",
                                        "flow/conv2", "flow/conv3", "flow/fc", "flow/linear"]
    stats = PathStats()
    assert np.isnan(stats.latency_us) and stats.throughput == 0.0
    stats.record(1.0, 0)
    stats.record(0.5, 10, host_s=0.2, device_s=0.3)
    assert (stats.calls, stats.items, stats.latency_us) == (1, 10, 5e5)


@pytest.mark.parametrize("kw", [
    dict(scan_len=0), dict(cold_size=-1), dict(cold_size=8, cold_policy="fifo"),
    dict(tracker="pallas"), dict(scan_len=2, overlap=True),
    dict(scan_len=4, overlap=True, cold_size=1 << 20, cold_policy="lru"),
], ids=["scan_len_0", "cold_size_negative", "bad_policy", "tracker_pallas", "overlap_chunks",
        "two_level"])
def test_pipeline_config_accepts_and_refuses_what_the_reference_does(kw):
    try:
        want = JPipelineConfig(**kw)
    except ValueError as theirs:
        with pytest.raises(ValueError) as ours:
            PipelineConfig(**kw)
        assert str(ours.value) == str(theirs)
        return
    got = PipelineConfig(**kw)
    for name in ("scan_len", "overlap", "cold_size", "cold_policy", "tracker", "top_k",
                 "pay_bytes"):
        assert getattr(got, name) == getattr(want, name), name


def test_pipeline_config_takes_the_transformer_with_the_reference_checks():
    cfg = PipelineConfig(flow_model="transformer")
    assert (cfg.flow_model, cfg.top_k, cfg.pay_bytes) == ("transformer", 15, 16)
    # the transformer reads payload rows, so the series depth top_n is free
    assert PipelineConfig(flow_model="transformer", top_n=6).top_n == 6
    for kw in (dict(top_n=6), dict(flow_model="transformer", top_k=8),
               dict(flow_model="transformer", pay_bytes=32), dict(flow_model="lstm")):
        with pytest.raises(ValueError) as ours:
            PipelineConfig(**kw)
        with pytest.raises(ValueError) as theirs:
            JPipelineConfig(**kw)
        assert str(ours.value) == str(theirs.value)


def test_pipeline_without_device_refuses_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OctopusPipeline({}, {}, PipelineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrafficGenerator(TrafficConfig())


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.runtime.plan, repro_torch.core.collaborative\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port was imported


def test_chip_smoke_fails_without_card_and_outside_checkout(tmp_path):
    """No card, or no checkout around it: a non-zero exit and no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # a lone copy, told there is a card, still refuses: the port is not there
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    fake_card = ("import runpy, sys, torch\n"
                 "torch.cuda.is_available = lambda: True\n"
                 f"runpy.run_path({str(lone)!r}, run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", fake_card], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "src/repro_torch missing" in out.stderr

"""The port's int8 engine datapath against the JAX package.

The int8 engine wrappers run their plain versions on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_quantized.py
does) and its NumPy int32 oracle.  Integer accumulation leaves no room for
summation order, so int8 outputs (activation none/relu) must be equal bit for
bit.  The int8 pipeline is held to the JAX pipeline (``use_pallas=False``,
``quantize=True``) on tracker state, drained rows, decisions and packet
logits; the port's calibration to the JAX calibration on layer names, scales
(rtol 1e-6: the inner layers' max-abs statistics come from f32 intermediates,
whose last bits differ) and the pruned set."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.core.feature_extractor import packet_meta_features as j_packet_meta_features
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.kernels.arype_matmul import arype_matmul_q as j_arype_matmul_q
from repro.kernels.arype_matmul import ref_quantized_matmul
from repro.kernels.vpe_smallmm import vpe_matmul_q as j_vpe_matmul_q
from repro.launch.calibrate import calibrate_quant_scales as j_calibrate_quant_scales
from repro.models import paper_models as jpm
from repro.runtime import QuantScales as JQuantScales
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import quant as jquant
from repro.runtime import routing as jrouting
from repro.runtime.autotune import Calibration
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro_torch import convert
from repro_torch.core import router
from repro_torch.core.feature_extractor import packet_meta_features
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.kernels.arype_matmul.ops import arype_matmul_q
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul_q
from repro_torch.launch.calibrate import calibrate_quant_scales, quant_divergence_report
from repro_torch.models import paper_models
from repro_torch.runtime import (
    QuantScales,
    RuntimeConfig,
    name_scope,
    record_routes,
    record_scales,
)
from repro_torch.runtime import quant
from repro_torch.serving import OctopusPipeline, PipelineConfig

SHAPES = [(7, 13, 5), (32, 64, 162), (130, 200, 96),
          # every engine matmul of one step at the smoke configuration
          (1024, 6, 12), (1024, 12, 6), (1024, 6, 3), (1024, 3, 2), (5120, 3, 32),
          (2560, 96, 32), (1280, 96, 32), (256, 96, 128), (256, 128, 162)]
ENGINES = {"vpe": (vpe_matmul_q, j_vpe_matmul_q), "arype": (arype_matmul_q, j_arype_matmul_q)}


def jax_params(kind: str, seed: int):
    jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


def operands(m, k, n, seed, per_channel):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32) * 3
    w = rng.normal(size=(k, n)).astype(np.float32)
    sx = jquant.pick_scale(float(np.abs(x).max()))
    sw = (tuple(jquant.pick_scale(float(v)) for v in np.abs(w).max(0)) if per_channel
          else jquant.pick_scale(float(np.abs(w).max())))
    return x, w, sx, sw


@pytest.fixture(scope="module")
def jax_tables():
    """The reference's calibration (its own PRNGKey(0)/(1) params), full and
    pruned, run once for the module."""
    full = j_calibrate_quant_scales(steps=16, flow_models=("cnn",), max_flip_rate=None)
    pruned = j_calibrate_quant_scales(steps=16, flow_models=("cnn",))
    return full, pruned


@pytest.mark.parametrize("engine", ["vpe", "arype"])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("per_channel", [False, True], ids=["tensor", "channel"])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_int8_engines_match_reference_bit_for_bit(engine, m, k, n, per_channel, act):
    ours, theirs = ENGINES[engine]
    x, w, sx, sw = operands(m, k, n, m * 7 + k * 3 + n, per_channel)
    got = ours(torch.as_tensor(x), torch.as_tensor(w), scale_x=sx, scale_w=sw,
               activation=act).numpy()
    kernel = theirs(jnp.asarray(x), jnp.asarray(w), scale_x=sx, scale_w=sw, activation=act,
                    interpret=True)
    oracle = ref_quantized_matmul(x, w, scale_x=sx, scale_w=sw, activation=act)
    np.testing.assert_array_equal(got, np.asarray(oracle))
    np.testing.assert_array_equal(got, np.asarray(kernel))


@pytest.mark.parametrize("engine", ["vpe", "arype"])
def test_int8_rounding_is_half_to_even_and_clipped(engine):
    """Exact ties (a power-of-two scale divides exactly): 0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, -2.5 -> -2; and values past the grid clip to +-127."""
    ours, theirs = ENGINES[engine]
    x = np.array([[0.5, 1.5, 2.5, -2.5, -0.5, 300.0, -300.0, 126.5]], np.float32) * 0.125
    w = np.eye(8, dtype=np.float32)
    got = ours(torch.as_tensor(x), torch.as_tensor(w), scale_x=0.125, scale_w=1 / 127)
    codes = np.round(got.numpy() / 0.125).astype(np.int64)  # each w code is 127
    np.testing.assert_array_equal(codes, [[0, 2, 2, -2, 0, 127, -127, 126]])
    want = theirs(jnp.asarray(x), jnp.asarray(w), scale_x=0.125, scale_w=1 / 127,
                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_i8_and_dequant_row_match_reference():
    rng = np.random.default_rng(3)
    v = (rng.normal(size=(64, 9)) * 40).astype(np.float32)
    for scale in (0.37, tuple(float(s) for s in rng.uniform(0.1, 1.0, 9))):
        got = quant.quantize_i8(torch.as_tensor(v), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.quantize_i8(
            jnp.asarray(v), scale)))
        np.testing.assert_array_equal(quant.dequant_row(0.01, scale, 9),
                                      jquant.dequant_row(0.01, scale, 9))


def test_int8_engines_refuse_what_they_do_not_take():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    for engine in (vpe_matmul_q, arype_matmul_q):
        with pytest.raises(ValueError, match="activation"):
            engine(x, w, scale_x=0.1, scale_w=0.1, activation="tanh")
        with pytest.raises(ValueError, match="channel scales"):
            engine(x, w, scale_x=0.1, scale_w=(0.1, 0.2, 0.3))
        with pytest.raises(ValueError, match="no kernel"):
            engine(x.to("meta"), w.to("meta"), scale_x=0.1, scale_w=0.1)
        deep = quant.I32_MAX_K + 1
        with pytest.raises(ValueError, match="overflows"):
            engine(torch.zeros(1, deep), torch.zeros(deep, 1), scale_x=0.1, scale_w=0.1)
    assert 127 * 127 * quant.I32_MAX_K < 2**31 <= 127 * 127 * (quant.I32_MAX_K + 1)
    assert vpe_matmul_q(torch.zeros(0, 3), w, scale_x=0.1, scale_w=0.1).shape == (0, 2)


def test_quant_scales_match_reference_table():
    entries = (("pkt/w0", 0.1, 0.2), ("w1", 0.3, (0.4, 0.5)), ("fc", 0.25, 0.125))
    ours, theirs = QuantScales(entries), JQuantScales(entries)
    assert ours.fingerprint == theirs.fingerprint
    assert ours.names() == theirs.names()
    for name, scope in [("w0", "pkt/"), ("w0", ""), ("flow/w1", ""), ("w1", "flow/"),
                        ("fc", "flow/"), ("nope", ""), (None, ""), ("", "pkt/")]:
        assert ours.lookup(name, scope) == theirs.lookup(name, scope), (name, scope)
    sub = ours.subset(("w1", "fc"))
    assert sub.names() == theirs.subset(("w1", "fc")).names() == ("w1", "fc")
    assert sub.fingerprint == theirs.subset(("w1", "fc")).fingerprint
    blob = json.loads(json.dumps(ours.to_dict()))
    assert blob == json.loads(json.dumps(theirs.to_dict()))
    assert QuantScales.from_dict(blob) == ours
    assert isinstance(QuantScales.from_dict(blob).lookup("w1")[1], tuple)
    stats = {"w0": (3.0, (1.0, 2.0)), "fc": (0.0, 0.5)}
    assert QuantScales.from_max_abs(stats).entries == JQuantScales.from_max_abs(stats).entries
    for bad, match in [((("a", 0.1, 0.1), ("a", 0.2, 0.2)), "duplicate"),
                       ((("a", 0.0, 0.1),), "positive"),
                       ((("a", 0.1, (0.1, -0.5)),), "positive"),
                       ((("", 0.1, 0.1),), "layer name")]:
        with pytest.raises(ValueError, match=match) as ours_err:
            QuantScales(bad)
        with pytest.raises(ValueError) as theirs_err:
            JQuantScales(bad)
        assert str(ours_err.value) == str(theirs_err.value)


def test_quant_scales_from_dict_takes_reference_table_and_artifact(jax_tables):
    full, pruned = jax_tables
    table = convert.quant_scales_from_dict(full.to_dict())
    assert table.entries == full.entries and table.fingerprint == full.fingerprint
    artifact = json.loads(json.dumps(Calibration(
        tau=0.5, vpe_max_elems=1 << 20, fingerprint={"backend": "cpu"},
        quant_scales=pruned).to_dict()))
    for block in (artifact["quant_scales"], artifact):
        assert convert.quant_scales_from_dict(block).fingerprint == pruned.fingerprint
    with pytest.raises(ValueError, match="no quant_scales"):
        convert.quant_scales_from_dict({**artifact, "quant_scales": None})


def test_router_stays_f32_without_table_or_entry():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(40, 6)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(6, 12)).astype(np.float32))
    f32 = router.matmul(x, w, name="w0", activation="relu")
    table = QuantScales((("w0", 0.05, 0.02),))
    for cfg, name in [(RuntimeConfig(quantize=True), "w0"),
                      (RuntimeConfig(quantize=True, quant_scales=table), "w9"),
                      (RuntimeConfig(quantize=False, quant_scales=table), "w0")]:
        got = router.matmul(x, w, name=name, activation="relu", config=cfg)
        want = f32 if name == "w0" else router.matmul(x, w, name=name, activation="relu")
        assert torch.equal(got, want)
    q = router.matmul(x, w, name="w0", activation="relu",
                      config=RuntimeConfig(quantize=True, quant_scales=table))
    assert not torch.equal(q, f32)
    want = ref_quantized_matmul(x.numpy(), w.numpy(), scale_x=0.05, scale_w=0.02,
                                activation="relu")
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_record_routes_marks_quantized_layers_as_reference(kind):
    jp, tp = jax_params(kind, 3)
    entries = (("w1", 0.1, 0.2), ("pkt/w3", 0.1, 0.2), ("conv2", 0.1, 0.2), ("flow/fc", 0.1, 0.2))
    x = np.abs(np.random.default_rng(1).normal(size=(12, 6 if kind == "mlp" else 20)))
    x = x.astype(np.float32)
    japply = jpm.mlp_apply if kind == "mlp" else jpm.cnn_apply
    apply = paper_models.mlp_apply if kind == "mlp" else paper_models.cnn_apply
    scope = "pkt" if kind == "mlp" else "flow"
    jcfg = JRuntimeConfig(use_pallas=False, quantize=True, quant_scales=JQuantScales(entries))
    cfg = RuntimeConfig(quantize=True, quant_scales=QuantScales(entries))
    with jrouting.record_routes() as jroutes, jrouting.name_scope(scope):
        japply(jp, jnp.asarray(x), config=jcfg)
    with record_routes() as routes, name_scope(scope):
        apply(tp, torch.as_tensor(x), config=cfg)
    got = [(r.name, r.route.path, r.quantized) for r in routes]
    assert got == [(r.name, r.route.path, r.quantized) for r in jroutes]
    assert any(q for _, _, q in got) and not all(q for _, _, q in got)


def test_recorder_matches_reference_stats():
    rng = np.random.default_rng(11)
    ops = [("a", rng.normal(size=(4, 5, 6)), rng.normal(size=(6, 3))),
           ("a", rng.normal(size=(7, 6)) * 4, rng.normal(size=(6, 3)) * 2),
           ("b", rng.normal(size=(9, 2)), rng.normal(size=(2, 8)))]
    with record_scales() as rec:
        for name, x, w in ops:
            router.matmul(torch.as_tensor(x.astype(np.float32)),
                          torch.as_tensor(w.astype(np.float32)), name=name)
        router.matmul(torch.ones(2, 6), torch.ones(6, 3))  # unnamed: not recorded
    with jquant.record_scales() as jrec:
        for name, x, w in ops:
            jrouter.matmul(jnp.asarray(x.astype(np.float32)), jnp.asarray(w.astype(np.float32)),
                           name=name)
    assert rec.stats == jrec.stats
    assert rec.scales().entries == jrec.scales().entries
    with pytest.raises(ValueError, match="inconsistent weight width"):
        rec.update("b", 1.0, (1.0, 2.0))


@pytest.mark.parametrize("runtime_kw", [{}, dict(vpe_max_elems=1 << 16)],
                         ids=["vpe_convs", "arype_convs"])
def test_int8_pipeline_matches_reference(jax_tables, runtime_kw):
    full, _ = jax_tables
    table = convert.quant_scales_from_dict(full.to_dict())
    jmlp, mlp = jax_params("mlp", 1)
    jcnn, cnn = jax_params("cnn", 2)
    shape = dict(batch_size=64, max_ready=48, table_size=256)
    jcfg = JRuntimeConfig(use_pallas=False, quantize=True, quant_scales=full, **runtime_kw)
    cfg = RuntimeConfig(quantize=True, quant_scales=table, **runtime_kw)
    jpipe = JOctopusPipeline(jmlp, jcnn, JPipelineConfig(**shape), config=jcfg)
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**shape), config=cfg, device="cpu")
    tcfg = dict(batch_size=64, active_flows=16, elephant_fraction=0.5, table_size=256, seed=4)
    jgen = JTrafficGenerator(JTrafficConfig(**tcfg))
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    with record_routes() as routes:
        pipe.step(gen.next_batch())
    jpipe.step(jgen.next_batch())
    assert all(r.quantized for r in routes) and len(routes) == 9
    arype = {r.name for r in routes if r.route.path == "arype"}
    assert ("flow/conv2" in arype) == bool(runtime_kw)
    drained = 0
    for step in range(1, 10):
        jbatch, batch = jgen.next_batch(), gen.next_batch()
        jout, out = jpipe.step(jbatch), pipe.step(batch)
        for name, a, b in zip(jpipe.state._fields, jpipe.state, convert.to_numpy(pipe.state)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"step {step} state.{name}")
        for name, a, b in zip(jout.drained._fields, jout.drained, convert.to_numpy(out.drained)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"step {step} drained.{name}")
        np.testing.assert_array_equal(np.asarray(jout.pkt_actions), out.pkt_actions.numpy())
        np.testing.assert_array_equal(np.asarray(jout.flow_cls), out.flow_cls.numpy())
        # packet features are integer-valued, so the int8 packet logits agree bit for bit
        jlogits = jpm.mlp_apply(jmlp, j_packet_meta_features(jbatch), config=jcfg)
        logits = paper_models.mlp_apply(mlp, packet_meta_features(batch), config=cfg)
        np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits))
        drained += int(out.drained.mask.sum())
    assert drained > 0
    assert pipe.rules.rules == jpipe.rules.rules


def test_calibration_matches_reference(jax_tables):
    jfull, jpruned = jax_tables
    _, mlp = jax_params("mlp", 0)
    _, cnn = jax_params("cnn", 1)
    full = calibrate_quant_scales(mlp, cnn, max_flip_rate=None, device="cpu")
    pruned = calibrate_quant_scales(mlp, cnn, device="cpu")
    assert full.names() == jfull.names()
    for (name, sx, sw), (_, jsx, jsw) in zip(full.entries, jfull.entries):
        np.testing.assert_allclose(sx, jsx, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(sw, jsw, rtol=1e-6, err_msg=name)
    assert pruned.names() == jpruned.names()
    with pytest.raises(NotImplementedError, match="cnn"):
        calibrate_quant_scales(mlp, cnn, flow_model="transformer", device="cpu")


def test_divergence_report_keeps_tracker_exact_and_flips_bounded(jax_tables):
    _, jpruned = jax_tables
    _, mlp = jax_params("mlp", 0)
    _, cnn = jax_params("cnn", 1)
    table = convert.quant_scales_from_dict(jpruned.to_dict())
    text, metrics = quant_divergence_report(table, mlp, cnn, device="cpu")
    assert metrics["tracker_bit_exact"] and "bit-exact: yes" in text
    assert metrics["pkt_total"] == 320 and metrics["flow_total"] > 0
    assert metrics["pkt_flip_rate"] <= 0.01 and metrics["flow_flip_rate"] <= 0.01
    assert table.fingerprint in text

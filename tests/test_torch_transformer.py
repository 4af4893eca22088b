"""The port's use-case 3 payload transformer against the JAX package: the
payload prep, ``transformer_apply`` in f32 and int8, and the streaming loop
with ``flow_model="transformer"``.

Tolerances.  f32 logits: rtol 1e-5, atol 1e-5 * max|ref| (the order of the
f32 sums and torch's exp in the softmax differ from XLA's).  int8: each
routed layer is bit-exact given the same f32 input (an exact int32 sum and
one f32 product); the whole model is held within 2e-2 * max|logit|, because
the attention output between the int8 layers is f32 again and a last-bit
difference there can move an int8 code by one where it sits at a half, which
moves a logit by about one quantum of the later layers; its decisions must be
identical on the seeded inputs.  The loop is bit-identical on tracker state,
drained rows (payload included), decisions and rule tables."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import router as jrouter
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import quant as jquant
from repro.runtime import routing as jrouting
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro.serving.packet_path import FlowEngine as JFlowEngine
from repro_torch import convert
from repro_torch.core import router
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.models import paper_models
from repro_torch.runtime import RuntimeConfig, record_routes
from repro_torch.serving import OctopusPipeline, PipelineConfig
from repro_torch.serving.packet_path import FlowEngine

INT8_LOGIT_TOL = 2e-2  # share of max|logit|; see the module docstring
LAYERS = ("wq", "wk", "wv", "mlp1", "mlp2", "cls")


def jax_params(kind: str, seed: int):
    jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


def payloads(flows: int, seed: int) -> np.ndarray:
    """Normalized byte matrices as the pipeline's prep makes them."""
    raw = np.random.default_rng(seed).integers(0, 256, size=(flows, 15, 16), dtype=np.int32)
    return (raw.astype(np.float32) * np.float32(1 / np.float32(255))).astype(np.float32)


def assert_close(got: torch.Tensor, want, rtol: float = 1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def reference_table(jmlp, jtf):
    """A full int8 table from the reference's own recorder on a seeded
    sample: both engines' layers, per-channel weight scales."""
    feats = np.abs(np.random.default_rng(5).normal(size=(64, 6)) * 50).astype(np.float32)
    with jquant.record_scales() as rec:
        jpm.mlp_apply(jmlp, jnp.asarray(feats), config=JRuntimeConfig(use_pallas=False))
        jpm.transformer_apply(jtf, jnp.asarray(payloads(32, 6)),
                              config=JRuntimeConfig(use_pallas=False))
    full = rec.scales()
    assert set(full.names()) == {"w0", "w1", "w2", "w3", *LAYERS}
    return full, convert.quant_scales_from_dict(full.to_dict())


def test_params_and_scale_tables_convert_through_numpy():
    jtf, tf = jax_params("transformer", 2)
    assert {k: tuple(v.shape) for k, v in tf.items()} == {
        k: tuple(v.shape) for k, v in jtf.items()}
    mine = paper_models.init_paper_model("transformer", torch.Generator().manual_seed(0),
                                         device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in jtf.items()}
    assert all(not mine[k].any() for k in ("mlp1_b", "mlp2_b", "cls_b"))
    full, table = reference_table(jax_params("mlp", 1)[0], jtf)
    assert table.entries == full.entries and table.fingerprint == full.fingerprint
    with pytest.raises(ValueError, match="transformer"):
        paper_models.init_paper_model("lstm", torch.Generator(), device="cpu")


def test_payload_prep_matches_the_jitted_reference_bit_for_bit():
    raw = np.arange(256, dtype=np.int32).reshape(16, 16)
    payload = np.broadcast_to(raw[:, None, :], (16, 15, 16)).copy()
    jeng = JFlowEngine({}, "transformer", config=JRuntimeConfig(use_pallas=False))
    jitted = np.asarray(jax.jit(jeng.prep)(jnp.zeros((16, 20), jnp.int32), jnp.asarray(payload)))
    ours = FlowEngine({}, "transformer", config=RuntimeConfig()).prep(
        torch.zeros(16, 20, dtype=torch.int32), torch.as_tensor(payload))
    np.testing.assert_array_equal(ours.numpy(), jitted)
    # the eager reference divides, which differs in the last bit on some bytes
    eager = np.asarray(jeng.prep(jnp.zeros((16, 20), jnp.int32), jnp.asarray(payload)))
    assert (eager != jitted).any()


@pytest.mark.parametrize("flows", [8, 40])
@pytest.mark.parametrize("runtime_kw", [{}, dict(vpe_max_elems=1 << 12), dict(policy="vpe_only"),
                                        dict(policy="arype_only")],
                         ids=["default", "arype_mlp", "vpe_only", "arype_only"])
def test_transformer_apply_matches_reference(flows, runtime_kw):
    jp, tp = jax_params("transformer", 3)
    x = payloads(flows, flows)
    with jrouting.record_routes() as jroutes:
        want = jpm.transformer_apply(jp, jnp.asarray(x),
                                     config=JRuntimeConfig(use_pallas=False, **runtime_kw))
    with record_routes() as routes:
        got = paper_models.transformer_apply(tp, torch.as_tensor(x),
                                             config=RuntimeConfig(**runtime_kw))
    assert got.shape == (flows, 162)
    assert_close(got, want)
    assert ([(r.name, r.m, r.k, r.n, r.route.path) for r in routes]
            == [(r.name, r.m, r.k, r.n, r.route.path) for r in jroutes])
    assert [r.name for r in routes] == list(LAYERS)


def reference_layer_inputs(jp, x, jcfg) -> dict:
    """The f32 input of every routed transformer layer, computed by the
    reference's own router and ops (transformer_apply's steps)."""
    mm = lambda h, name: jrouter.matmul(h, jp[name if name != "cls" else "cls_w"], name=name,
                                        config=jcfg)
    ins = {name: x for name in ("wq", "wk", "wv")}
    q, k, v = (mm(x, n) for n in ("wq", "wk", "wv"))
    a = jax.nn.softmax(jnp.einsum("fqd,fkd->fqk", q, k) / np.sqrt(jpm.TF_DK), axis=-1)
    ins["mlp1"] = jnp.einsum("fqk,fkd->fqd", a, v)
    h = jnp.maximum(mm(ins["mlp1"], "mlp1") + jp["mlp1_b"], 0.0)
    ins["mlp2"] = h
    ins["cls"] = (mm(h, "mlp2") + jp["mlp2_b"]).mean(axis=1)
    return {name: np.array(v) for name, v in ins.items()}


@pytest.mark.parametrize("runtime_kw", [{}, dict(vpe_max_elems=1 << 12)],
                         ids=["default", "arype_mlp"])
def test_int8_transformer_layers_bit_exact_and_model_within_tolerance(runtime_kw):
    jmlp, _ = jax_params("mlp", 1)
    jp, tp = jax_params("transformer", 2)
    full, table = reference_table(jmlp, jp)
    jcfg = JRuntimeConfig(use_pallas=False, quantize=True, quant_scales=full, **runtime_kw)
    cfg = RuntimeConfig(quantize=True, quant_scales=table, **runtime_kw)
    x = payloads(24, 7)
    for name, h in reference_layer_inputs(jp, jnp.asarray(x), jcfg).items():
        w = "cls_w" if name == "cls" else name
        want = jrouter.matmul(jnp.asarray(h), jp[w], name=name, config=jcfg)
        got = router.matmul(torch.as_tensor(h), tp[w], name=name, config=cfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    want = np.asarray(jpm.transformer_apply(jp, jnp.asarray(x), config=jcfg))
    got = paper_models.transformer_apply(tp, torch.as_tensor(x), config=cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_LOGIT_TOL * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    f32 = paper_models.transformer_apply(tp, torch.as_tensor(x), config=RuntimeConfig())
    assert not torch.equal(torch.as_tensor(got), f32)  # the int8 path really ran


@pytest.mark.parametrize("tracker", ["segmented", "scan"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_transformer_pipeline_matches_reference(tracker, int8):
    jmlp, mlp = jax_params("mlp", 0)
    jtf, tf = jax_params("transformer", 2)
    runtime_kw, jruntime_kw = {}, {}
    if int8:
        full, table = reference_table(jmlp, jtf)
        runtime_kw, jruntime_kw = (dict(quantize=True, quant_scales=table),
                                   dict(quantize=True, quant_scales=full))
    # tests/test_pipeline.py's geometry: the transformer leaves top_n free
    shape = dict(batch_size=24, max_ready=4, flow_model="transformer", table_size=64, top_n=6,
                 top_k=15, pay_bytes=16, tracker=tracker)
    jpipe = JOctopusPipeline(jmlp, jtf, JPipelineConfig(**shape),
                             config=JRuntimeConfig(use_pallas=False, **jruntime_kw))
    pipe = OctopusPipeline(mlp, tf, PipelineConfig(**shape), config=RuntimeConfig(**runtime_kw),
                           device="cpu")
    assert pipe.explain() == jpipe.explain()
    tcfg = dict(batch_size=24, active_flows=16, elephant_fraction=0.5, table_size=64, seed=11,
                burst_prob=0.3)
    jgen = JTrafficGenerator(JTrafficConfig(**tcfg))
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
    jprep = jax.jit(jpipe.flow_engine.prep)
    jfn = jax.jit(lambda x: jpipe.flow_engine.fn(jpipe.flow_engine.params, x))
    drained = 0
    for step in range(25):
        jout, out = jpipe.step(jgen.next_batch()), pipe.step(gen.next_batch())
        for name, a, b in zip(jpipe.state._fields, jpipe.state, convert.to_numpy(pipe.state)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"step {step} state.{name}")
        for name, a, b in zip(jout.drained._fields, jout.drained, convert.to_numpy(out.drained)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"step {step} drained.{name}")
        np.testing.assert_array_equal(np.asarray(jout.pkt_actions), out.pkt_actions.numpy())
        np.testing.assert_array_equal(np.asarray(jout.flow_cls), out.flow_cls.numpy())
        np.testing.assert_array_equal(np.asarray(jout.flow_actions), out.flow_actions.numpy())
        jx = jprep(jout.drained.series, jout.drained.payload)
        x = pipe.flow_engine.prep(out.drained.series, out.drained.payload)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        want = np.asarray(jfn(jx))
        got = pipe.flow_engine.fn(pipe.flow_engine.params, x)
        if int8:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=INT8_LOGIT_TOL * np.abs(want).max())
        else:
            assert_close(got, want)
        drained += int(out.drained.mask.sum())
    assert drained > 0
    assert pipe.rules.rules == jpipe.rules.rules
    assert pipe.rules.generation == jpipe.rules.generation
    assert (pipe.stats.packets, pipe.stats.flows) == (jpipe.stats.packets, jpipe.stats.flows)

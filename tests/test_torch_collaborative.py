"""The port's collaborative layer against the JAX package: the unfused
ablation's kernel wrappers (``mm_unfused_partials``,
``arype_matmul_unfused``), ``collaborative_forward`` and ``plan_stack``,
``RoutePlan`` (built from layers and traced on ``meta`` tensors), the FPGA
cycle model, ``cnn_apply`` under ``fused_aggregation=False`` and the unfused
CNN loop.

The wrappers run their plain versions on CPU tensors; the JAX side runs its
Pallas kernels in interpret mode, or its plain path.  Only the order of the
f32 sums differs (the port adds the partials in block order, XLA's
``sum(axis=0)`` in its own), so products agree within rtol 1e-5,
atol 1e-5 * max|ref|.  Plans, placement reports and cycle-model reports are
exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.collaborative as jcollab
from repro.data.traffic import TrafficConfig as JTrafficConfig
from repro.data.traffic import TrafficGenerator as JTrafficGenerator
from repro.kernels.arype_matmul import arype_matmul_unfused as j_arype_matmul_unfused
from repro.kernels.arype_matmul.arype_matmul import mm_unfused_partials as j_mm_unfused_partials
from repro.models import paper_models as jpm
from repro.runtime import QuantScales as JQuantScales
from repro.runtime import RoutePlan as JRoutePlan
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import routing as jrouting
from repro.serving import OctopusPipeline as JOctopusPipeline
from repro.serving import PipelineConfig as JPipelineConfig
from repro.serving.packet_path import FlowEngine as JFlowEngine
from repro.serving.packet_path import PacketEngine as JPacketEngine
from repro_torch import convert, kernels
from repro_torch.core import collaborative
from repro_torch.data.traffic import TrafficConfig, TrafficGenerator
from repro_torch.kernels.arype_matmul.ops import arype_matmul_unfused, mm_unfused_partials
from repro_torch.models import paper_models
from repro_torch.runtime import (
    QuantScales,
    RoutePlan,
    RuntimeConfig,
    record_routes,
    record_scales,
)
from repro_torch.serving import OctopusPipeline, PipelineConfig
from repro_torch.serving.packet_path import FlowEngine, PacketEngine

ACTS = ["none", "relu", "silu", "gelu"]
POLICIES = ["collaborative", "arype_only"]


def assert_close(got: torch.Tensor, want, rtol: float = 1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def operands(*shapes, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def jax_params(kind: str, seed: int):
    jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")


def steps_of(plan) -> list:
    return [(s.name, s.m, s.k, s.n, s.engine, s.route.util, s.route.reason, s.quantized)
            for s in plan.steps]


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [(128, 256, 128, 128, 128, 128),
                                            (256, 96, 32, 128, 32, 32),
                                            (64, 128, 64, 64, 64, 32)])
def test_unfused_partials_match_reference(m, k, n, bm, bn, bk):
    x, w = operands((m, k), (k, n), seed=m + k + n)
    want = np.asarray(j_mm_unfused_partials(jnp.asarray(x), jnp.asarray(w), bm=bm, bn=bn,
                                            bk=bk, interpret=True))
    got = mm_unfused_partials(torch.as_tensor(x), torch.as_tensor(w), bk=bk)
    assert got.shape == want.shape == (k // bk, m, n)
    for block in range(k // bk):
        assert_close(got[block], want[block])


@pytest.mark.parametrize("m,k,n", [(40, 96, 32), (8, 128, 162), (33, 200, 17)])
@pytest.mark.parametrize("act", ACTS)
def test_arype_matmul_unfused_matches_reference(m, k, n, act):
    x, w = operands((m, k), (k, n), seed=m * 7 + k + n)
    want = j_arype_matmul_unfused(jnp.asarray(x), jnp.asarray(w), activation=act,
                                  interpret=True)
    assert_close(arype_matmul_unfused(torch.as_tensor(x), torch.as_tensor(w), activation=act),
                 want)


@pytest.mark.parametrize("shape,n", [((40, 96), 32), ((6, 20, 96), 32), ((9, 128), 162),
                                     ((5, 3), 32)])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_unfused_bk32_matches_unfused_jnp(shape, n, act):
    x, w = operands(shape, (shape[-1], n), seed=sum(shape) + n)
    want = jcollab._unfused_jnp(jnp.asarray(x), jnp.asarray(w), act)
    got = collaborative._unfused(torch.as_tensor(x), torch.as_tensor(w), act)
    assert got.shape == want.shape
    assert_close(got, want)


def test_unfused_partials_use_the_papers_blocking_and_refuse_bad_args():
    x, w = torch.ones(4, 96), torch.ones(96, 8)
    assert mm_unfused_partials(x, w, bk=32).shape == (3, 4, 8)
    assert mm_unfused_partials(x, w).shape == (1, 4, 8)  # the reference's 128: one partial
    assert mm_unfused_partials(torch.ones(4, 200), torch.ones(200, 8), bk=32).shape == (7, 4, 8)
    with pytest.raises(ValueError, match="activation"):
        arype_matmul_unfused(x, w, activation="tanh")
    with pytest.raises(ValueError, match="bk"):
        arype_matmul_unfused(x, w, bk=0)
    with pytest.raises(ValueError, match="shapes"):
        mm_unfused_partials(x, torch.ones(95, 8))
    with pytest.raises(ValueError, match="no kernel"):
        mm_unfused_partials(x.to("meta"), w.to("meta"))
    # a RoutePlan trace: the unfused matmul on meta tensors gives an empty
    # meta result and launches nothing
    before = kernels.launches()
    out = arype_matmul_unfused(x.to("meta"), w.to("meta"), bk=32)
    assert out.device.type == "meta" and out.shape == (4, 8) and kernels.launches() == before


def test_runtime_config_with_unfused_aggregation_builds():
    cfg = RuntimeConfig(fused_aggregation=False)
    assert not cfg.fused_aggregation
    assert RuntimeConfig(fused_aggregation=False, quantize=True).quantize


# ----------------------------------------------------- collaborative layer


def stack(seed: int):
    x, *ws = operands((256, 300), (300, 64), (64, 96), (96, 8), seed=seed)
    return x, ws, ["relu", "gelu", None]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_collaborative_forward_matches_reference(policy, fused):
    x, ws, acts = stack(3)
    jws, tws = [jnp.asarray(w) for w in ws], [torch.as_tensor(w) for w in ws]
    cfg = RuntimeConfig(policy=policy, fused_aggregation=fused)
    plan = collaborative.plan_stack(torch.as_tensor(x), tws, config=cfg)
    engines = {s.engine for s in plan.steps}
    assert "arype" in engines and (policy == "arype_only") == (engines == {"arype"})
    got = collaborative.collaborative_forward(torch.as_tensor(x), tws, acts, config=cfg)
    for use_pallas in ([False] if fused else [False, True]):
        jcfg = JRuntimeConfig(policy=policy, fused_aggregation=fused, use_pallas=use_pallas,
                              interpret=True)
        jplan = jcollab.plan_stack(jnp.asarray(x), jws, config=jcfg)
        assert steps_of(plan) == steps_of(jplan)
        want = jcollab.collaborative_forward(jnp.asarray(x), jws, acts, config=jcfg)
        assert_close(got, want)
    names = ["a", "b", "c"]
    assert [s.name for s in collaborative.plan_stack(torch.as_tensor(x), tws,
                                                     names=names).steps] == names


def test_collaborative_forward_refuses_short_or_stale_plans_as_reference():
    x, ws, acts = stack(4)
    jws, tws = [jnp.asarray(w) for w in ws], [torch.as_tensor(w) for w in ws]
    plan = collaborative.plan_stack(torch.as_tensor(x), tws)
    jplan = jcollab.plan_stack(jnp.asarray(x), jws)
    cases = [
        (lambda: collaborative.collaborative_forward(torch.as_tensor(x), tws[:2], acts[:2],
                                                     plan=plan),
         lambda: jcollab.collaborative_forward(jnp.asarray(x), jws[:2], acts[:2], plan=jplan)),
        (lambda: collaborative.collaborative_forward(torch.as_tensor(x[:100]), tws, acts,
                                                     plan=plan),
         lambda: jcollab.collaborative_forward(jnp.asarray(x[:100]), jws, acts, plan=jplan)),
    ]
    for ours, theirs in cases:
        with pytest.raises(ValueError) as ours_err:
            ours()
        with pytest.raises(ValueError) as theirs_err:
            theirs()
        assert str(ours_err.value) == str(theirs_err.value)


def test_collaborative_forward_inherits_plan_config(monkeypatch):
    """A supplied plan's config governs execution: a plan built for the
    unfused ablation takes the unfused path without config= repeated, as in
    tests/test_runtime.py for the reference."""
    calls = []
    orig = collaborative._unfused
    monkeypatch.setattr(collaborative, "_unfused",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    x, w = operands((32, 300), (300, 64), seed=5)
    plan = collaborative.plan_stack(torch.as_tensor(x), [torch.as_tensor(w)],
                                    config=RuntimeConfig(policy="arype_only",
                                                         fused_aggregation=False))
    out = collaborative.collaborative_forward(torch.as_tensor(x), [torch.as_tensor(w)], [None],
                                              plan=plan)
    assert calls == [1], "the plan's fused_aggregation=False was ignored"
    want = jcollab.collaborative_forward(
        jnp.asarray(x), [jnp.asarray(w)], [None],
        plan=jcollab.plan_stack(jnp.asarray(x), [jnp.asarray(w)], config=JRuntimeConfig(
            policy="arype_only", fused_aggregation=False)))
    assert_close(out, want)
    # a config= passed alongside overrides the plan's
    collaborative.collaborative_forward(torch.as_tensor(x), [torch.as_tensor(w)], [None],
                                        plan=plan, config=RuntimeConfig(policy="arype_only"))
    assert calls == [1]


def test_unfused_layers_stay_f32_under_quantize():
    """The reference never quantizes the unfused path: with a scale entry for
    the layer and quantize on, the unfused product equals the f32 one."""
    x, w = operands((64, 96), (96, 32), seed=6)
    table = QuantScales((("layer0", 0.05, 0.02),))
    tx, tw = torch.as_tensor(x), [torch.as_tensor(w)]
    cfg = RuntimeConfig(policy="arype_only", fused_aggregation=False, quantize=True,
                        quant_scales=table)
    plan = collaborative.plan_stack(tx, tw, config=cfg)
    assert plan.steps[0].quantized  # the plan names a table entry ...
    got = collaborative.collaborative_forward(tx, tw, ["relu"], plan=plan)
    f32 = collaborative.collaborative_forward(
        tx, tw, ["relu"], config=RuntimeConfig(policy="arype_only", fused_aggregation=False))
    assert torch.equal(got, f32)  # ... but the unfused matmul runs in f32
    jcfg = JRuntimeConfig(policy="arype_only", fused_aggregation=False, quantize=True,
                          quant_scales=JQuantScales((("layer0", 0.05, 0.02),)))
    assert_close(got, jcollab.collaborative_forward(jnp.asarray(x), [jnp.asarray(w)],
                                                    ["relu"], config=jcfg))


# --------------------------------------------------------------- RoutePlan


def table_entries(names):
    return tuple((n, 0.05 + 0.01 * i, 0.02) for i, n in enumerate(names))


CONFIGS = {
    "default": {},
    "arype_only": dict(policy="arype_only"),
    "vpe_only": dict(policy="vpe_only"),
    "tuned": dict(tau=0.5, vpe_max_elems=1 << 24),
    "int8": dict(quantize=True, quant=("conv2", "fc", "wq", "mlp1", "cls")),
}


def configs(name: str):
    kw = dict(CONFIGS[name])
    names = kw.pop("quant", None)
    if names:
        return (RuntimeConfig(quant_scales=QuantScales(table_entries(names)), **kw),
                JRuntimeConfig(quant_scales=JQuantScales(table_entries(names)), **kw))
    return RuntimeConfig(**kw), JRuntimeConfig(**kw)


@pytest.mark.parametrize("usecase", [2, 3])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_routeplan_from_layers_matches_reference(usecase, config):
    cfg, jcfg = configs(config)
    ours = getattr(collaborative, f"usecase{usecase}_plan")(1000, config=cfg)
    theirs = getattr(jcollab, f"usecase{usecase}_plan")(1000, config=jcfg)
    assert steps_of(ours) == steps_of(theirs)
    assert ours.explain() == theirs.explain()
    assert ours.layers() == theirs.layers() and ours.engines() == theirs.engines()
    assert ours.macs() == theirs.macs() and ours.macs("vpe") == theirs.macs("vpe")
    assert len(ours) == len(theirs) and [s.shape for s in ours] == [s.shape for s in theirs]


def test_routeplan_empty_and_scoped_match_reference():
    assert RoutePlan.from_layers([]).explain() == JRoutePlan.from_layers(
        [], config=JRuntimeConfig()).explain()
    layers = [("pkt/w0", 8, 6, 12), ("flow/conv1", 20, 3, 32), ("flow/fc", 1000, 96, 128)]
    ours, theirs = RoutePlan.from_layers(layers), JRoutePlan.from_layers(
        layers, config=JRuntimeConfig())
    for prefix in ("flow", "flow/", "pkt", "none"):
        for strip in (False, True):
            assert (steps_of(ours.scoped(prefix, strip=strip))
                    == steps_of(theirs.scoped(prefix, strip=strip)))
            assert (ours.scoped(prefix, strip=strip).explain()
                    == theirs.scoped(prefix, strip=strip).explain())


@pytest.mark.parametrize("model", ["cnn", "transformer"])
@pytest.mark.parametrize("config", ["default", "arype_only", "int8"])
@pytest.mark.parametrize("flows", [4, 256, 1000])
def test_engine_route_plans_match_reference(model, config, flows):
    cfg, jcfg = configs(config)
    jp, tp = jax_params(model, 1)
    ours = FlowEngine(tp, model, config=cfg).route_plan(flows)
    theirs = JFlowEngine(jp, model, config=jcfg).route_plan(flows)
    assert steps_of(ours) == steps_of(theirs)
    assert ours.explain() == theirs.explain()
    jmlp, mlp = jax_params("mlp", 0)
    assert (steps_of(PacketEngine(mlp, config=cfg).route_plan(flows))
            == steps_of(JPacketEngine(jmlp, config=jcfg).route_plan(flows)))


@pytest.mark.parametrize("model", ["cnn", "transformer"])
@pytest.mark.parametrize("config", ["default", "int8"])
def test_pipeline_plans_match_reference_at_the_smoke_geometry(model, config):
    """``OctopusPipeline.plan()``/``explain()`` at chip_smoke.py's geometry
    (8k table, batch 1024, 256 drained rows), where the placement it checks
    on the card comes from."""
    cfg, jcfg = configs(config)
    jmlp, mlp = jax_params("mlp", 0)
    jflow, flow = jax_params(model, 1)
    shape = dict(table_size=8192, batch_size=1024, max_ready=256, flow_model=model)
    ours = OctopusPipeline(mlp, flow, PipelineConfig(**shape), config=cfg, device="cpu")
    theirs = JOctopusPipeline(jmlp, jflow, JPipelineConfig(**shape), config=jcfg)
    assert steps_of(ours.plan()) == steps_of(theirs.plan())
    assert ours.explain() == theirs.explain()


def test_trace_on_meta_launches_nothing_and_records_no_scales():
    jp, tp = jax_params("cnn", 2)
    cfg = RuntimeConfig(fused_aggregation=False, policy="arype_only")
    before = kernels.launches()
    with record_scales() as rec:
        plan = RoutePlan.trace(lambda p, x: paper_models.cnn_apply(p, x, config=cfg), tp,
                               torch.empty(1000, 20), config=cfg)
        out = paper_models.transformer_apply({k: v.to("meta") for k, v in jax_params(
            "transformer", 2)[1].items()}, torch.empty(7, 15, 16, device="meta"))
    assert kernels.launches() == before and not rec.stats
    assert out.device.type == "meta" and out.shape == (7, 162)
    assert [s.name for s in plan.steps] == ["conv1", "conv2", "conv3", "fc", "linear"]
    assert plan.layers() == collaborative.usecase2_layers(1000)
    assert steps_of(plan) == steps_of(JRoutePlan.trace(
        lambda x: jpm.cnn_apply(jp, x), jax.ShapeDtypeStruct((1000, 20), jnp.float32),
        config=JRuntimeConfig(fused_aggregation=False, policy="arype_only")))
    # the traced tensors never held data: the inputs were moved to meta
    assert all(t.device.type == "cpu" for t in tp.values())


# ---------------------------------------------------------- the cycle model


@pytest.mark.parametrize("usecase", [2, 3])
@pytest.mark.parametrize("collab", [True, False])
@pytest.mark.parametrize("config", ["default", "arype_only", "tuned"])
def test_cycle_model_reports_match_reference(usecase, collab, config):
    cfg, jcfg = configs(config)
    model, jmodel = collaborative.OctopusCycleModel(), jcollab.OctopusCycleModel()
    plan = getattr(collaborative, f"usecase{usecase}_plan")(1000, config=cfg)
    jplan = getattr(jcollab, f"usecase{usecase}_plan")(1000, config=jcfg)
    assert model.stack_report(plan, collaborative=collab) == jmodel.stack_report(
        jplan, collaborative=collab)
    layers = getattr(collaborative, f"usecase{usecase}_layers")(1000)
    assert layers == getattr(jcollab, f"usecase{usecase}_layers")(1000)
    assert model.stack_report(layers, collaborative=collab) == jmodel.stack_report(
        layers, collaborative=collab)
    assert model.stack_report(layers, collaborative=collab, config=cfg) == jmodel.stack_report(
        layers, collaborative=collab, config=jcfg)
    for _, m, k, n in layers:
        for engine in ("vpe", "arype"):
            assert (vars(model.matmul_cost(m, k, n, engine, collab))
                    == vars(jmodel.matmul_cost(m, k, n, engine, collab)))


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("runtime_kw", [{}, dict(vpe_max_elems=1 << 12)],
                         ids=["vpe_convs", "arype_convs"])
def test_cnn_apply_unfused_matches_reference(policy, runtime_kw, monkeypatch):
    calls = []
    orig = collaborative._unfused
    monkeypatch.setattr(collaborative, "_unfused",
                        lambda *a, **k: (calls.append(a[1].shape), orig(*a, **k))[1])
    monkeypatch.setattr(paper_models, "_unfused", collaborative._unfused)
    jp, tp = jax_params("cnn", 4)
    x = np.abs(np.random.default_rng(2).normal(size=(24, 20))).astype(np.float32)
    cfg = RuntimeConfig(policy=policy, fused_aggregation=False, **runtime_kw)
    jcfg = JRuntimeConfig(policy=policy, fused_aggregation=False, use_pallas=False,
                          **runtime_kw)
    with record_routes() as routes:
        got = paper_models.cnn_apply(tp, torch.as_tensor(x), config=cfg)
    with jrouting.record_routes() as jroutes:
        want = jpm.cnn_apply(jp, jnp.asarray(x), config=jcfg)
    assert_close(got, want)
    record = lambda rs: [(r.name, r.m, r.k, r.n, r.route.path, r.route.util, r.route.reason)
                         for r in rs]
    assert record(routes) == record(jroutes)
    arype_convs = [r for r in routes if r.name.startswith("conv") and r.route.path == "arype"]
    assert len(calls) == len(arype_convs)
    assert bool(arype_convs) == (policy == "arype_only" or bool(runtime_kw))
    fused = paper_models.cnn_apply(tp, torch.as_tensor(x), config=RuntimeConfig(
        policy=policy, **runtime_kw))
    assert_close(got, fused.numpy())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_recorded_routes_say_which_kernels_run(fused):
    """A recorded matmul is ``unfused`` where it runs the ablation's two
    passes: an AryPE conv of ``cnn_apply`` (fc and linear stay fused, as in
    the reference) and every AryPE step of a plan for
    ``collaborative_forward``; ``kernels.matmul_launches`` maps the records
    to kernel launches."""
    _, tp = jax_params("cnn", 2)
    cfg = RuntimeConfig(fused_aggregation=fused)
    with record_routes() as routes:
        paper_models.cnn_apply(tp, torch.zeros(1000, 20), config=cfg)
    paths = {r.name: r.route.path for r in routes}
    assert paths == {"conv1": "vpe", "conv2": "arype", "conv3": "arype", "fc": "arype",
                     "linear": "arype"}
    unfused = [] if fused else ["conv2", "conv3"]
    assert [r.name for r in routes if r.unfused] == unfused
    assert kernels.matmul_launches(routes, 3) == dict(
        dict.fromkeys(kernels.KERNELS, 0), vpe_mm=3, mm_fused=3 * (4 - len(unfused)),
        mm_unfused_partials=3 * len(unfused), mm_partials_sum=3 * len(unfused))
    x, ws, _ = stack(3)
    with record_routes() as routes:
        plan = collaborative.plan_stack(torch.as_tensor(x), [torch.as_tensor(w) for w in ws],
                                        config=RuntimeConfig(policy="arype_only",
                                                             fused_aggregation=fused))
    assert [r.unfused for r in routes] == [not fused] * len(plan.steps)


def test_unfused_cnn_under_quantize_runs_and_records_its_convs_as_f32():
    """Under the ablation the reference runs every conv in f32 (the unfused
    matmul, or an unnamed routed one) but records a conv with a table entry
    as int8; the port records what runs (ROADMAP Queue 3)."""
    jp, tp = jax_params("cnn", 4)
    x = np.abs(np.random.default_rng(3).normal(size=(24, 20))).astype(np.float32)
    entries = table_entries(("conv1", "conv2", "conv3", "fc", "linear"))
    kw = dict(fused_aggregation=False, vpe_max_elems=1 << 12, quantize=True)
    cfg = RuntimeConfig(quant_scales=QuantScales(entries), **kw)
    jcfg = JRuntimeConfig(quant_scales=JQuantScales(entries), use_pallas=False, **kw)
    with record_routes() as routes:
        got = paper_models.cnn_apply(tp, torch.as_tensor(x), config=cfg)
    with jrouting.record_routes() as jroutes:
        want = jpm.cnn_apply(jp, jnp.asarray(x), config=jcfg)
    assert_close(got, want)
    assert [(r.name, r.quantized) for r in routes] == [
        ("conv1", False), ("conv2", False), ("conv3", False), ("fc", True), ("linear", True)]
    assert all(r.quantized for r in jroutes)
    # the convs ran in f32: a table for fc and linear alone gives the same logits
    heads_only = QuantScales(tuple(e for e in entries if e[0] in ("fc", "linear")))
    same = paper_models.cnn_apply(tp, torch.as_tensor(x),
                                  config=RuntimeConfig(quant_scales=heads_only, **kw))
    assert torch.equal(got, same)


# -------------------------------------------------------------------- loop


def test_unfused_cnn_pipeline_matches_reference():
    jmlp, mlp = jax_params("mlp", 1)
    jcnn, cnn = jax_params("cnn", 2)
    kw = dict(fused_aggregation=False, vpe_max_elems=1 << 12)
    shape = dict(batch_size=24, max_ready=4, table_size=64)
    jpipe = JOctopusPipeline(jmlp, jcnn, JPipelineConfig(**shape),
                             config=JRuntimeConfig(use_pallas=False, **kw))
    pipe = OctopusPipeline(mlp, cnn, PipelineConfig(**shape), config=RuntimeConfig(**kw),
                           device="cpu")
    assert pipe.explain() == jpipe.explain()
    tcfg = dict(batch_size=24, active_flows=16, elephant_fraction=0.5, table_size=64, seed=11,
                burst_prob=0.3)
    jgen = JTrafficGenerator(JTrafficConfig(**tcfg))
    gen = TrafficGenerator(TrafficConfig(**tcfg), device="cpu")
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
        # both models on the port's log1p input (torch's and XLA's log1p differ)
        x = pipe.flow_engine.prep(out.drained.series, out.drained.payload)
        assert_close(pipe.flow_engine.fn(pipe.flow_engine.params, x), jfn(jnp.asarray(x.numpy())))
        drained += int(out.drained.mask.sum())
    assert drained > 0
    assert pipe.rules.rules == jpipe.rules.rules
    assert pipe.rules.generation == jpipe.rules.generation

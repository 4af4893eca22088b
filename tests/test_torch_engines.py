"""The port's engines (``repro_torch.kernels.vpe_smallmm``/``arype_matmul``),
router and paper models against the JAX package.

The engine wrappers run their plain versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_kernels.py does.
Only the order of the f32 sums differs, so outputs agree within
rtol 1e-5, atol 1e-5 * max|ref|; decisions (argmax) agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.arype_matmul import arype_matmul as j_arype_matmul
from repro.kernels.vpe_smallmm import vpe_matmul as j_vpe_matmul
from repro.models import paper_models as jpm
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import routing as jrouting
from repro_torch import convert
from repro_torch.core import router
from repro_torch.kernels.arype_matmul.ops import arype_matmul
from repro_torch.kernels.vpe_smallmm.ops import vpe_matmul
from repro_torch.models import paper_models
from repro_torch.runtime import RuntimeConfig, record_routes, route_matmul, systolic_utilization

ACTS = ["none", "relu", "silu", "gelu"]


def assert_close(got: torch.Tensor, want, rtol: float = 1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("m,k,n", [(1000, 3, 32), (7, 16, 8), (33, 1, 2), (257, 12, 6)])
@pytest.mark.parametrize("act", ACTS)
def test_vpe_matmul_matches_reference(m, k, n, act):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = j_vpe_matmul(jnp.asarray(x), jnp.asarray(w), activation=act, interpret=True)
    assert_close(vpe_matmul(torch.as_tensor(x), torch.as_tensor(w), activation=act), want)


@pytest.mark.parametrize("m,k,n", [(100, 200, 300), (257, 129, 65), (16, 16, 16), (300, 96, 32)])
@pytest.mark.parametrize("act", ACTS)
def test_arype_matmul_matches_reference(m, k, n, act):
    rng = np.random.default_rng(m * 31 + k * 7 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = j_arype_matmul(jnp.asarray(x), jnp.asarray(w), activation=act, interpret=True)
    assert_close(arype_matmul(torch.as_tensor(x), torch.as_tensor(w), activation=act), want)


def test_engines_refuse_unknown_activation_and_device():
    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    for engine in (vpe_matmul, arype_matmul):
        with pytest.raises(ValueError, match="activation"):
            engine(x, w, activation="tanh")
        with pytest.raises(ValueError, match="no kernel"):
            engine(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("cfg", [{}, {"tau": 0.6}, {"vpe_max_elems": 1 << 12},
                                 {"policy": "vpe_only"}, {"mxu_tile": 32, "fill_depth": 4}])
def test_route_matmul_matches_reference_router(cfg):
    dims = [1, 3, 7, 8, 20, 96, 128, 130, 256, 1024, 5120]
    jcfg = JRuntimeConfig(**cfg)
    tcfg = RuntimeConfig(**cfg)
    for m in dims:
        for k in dims[:8]:
            for n in dims[:9]:
                want = jrouting.route_matmul(m, k, n, config=jcfg)
                got = route_matmul(m, k, n, config=tcfg)
                assert (got.path, got.util) == (want.path, want.util), (m, k, n)


def _inputs(kind: str, rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "mlp":  # packet_meta_features-like magnitudes
        return np.stack([rng.integers(40, 1500, rows), rng.integers(0, 2, rows),
                         rng.integers(0, 64, rows), rng.integers(0, 3, rows),
                         rng.integers(0, 17, rows), np.zeros(rows)], 1).astype(np.float32)
    return np.log1p(rng.exponential(200.0, (rows, paper_models.CNN_SEQ))).astype(np.float32)


@pytest.mark.parametrize("kind,rows,cfg", [
    ("mlp", 96, {}),
    ("cnn", 8, {}),  # conv1-3 on vpe, fc/linear on arype
    ("cnn", 40, {"vpe_max_elems": 1 << 14}),  # conv2/conv3 on arype too
])
def test_paper_models_match_reference(kind, rows, cfg):
    jparams = jpm.init_paper_model(kind, jax.random.PRNGKey(7))
    params = convert.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                       device="cpu")
    x = _inputs(kind, rows, seed=rows)
    japply = jpm.mlp_apply if kind == "mlp" else jpm.cnn_apply
    apply = paper_models.mlp_apply if kind == "mlp" else paper_models.cnn_apply
    want = np.asarray(japply(jparams, jnp.asarray(x), config=JRuntimeConfig(**cfg)))
    with record_routes() as routes:
        got = apply(params, torch.as_tensor(x), config=RuntimeConfig(**cfg))
    with jrouting.record_routes() as jroutes:
        japply(jparams, jnp.asarray(x), config=JRuntimeConfig(**cfg))
    assert [(r.name, r.m, r.k, r.n, r.route.path) for r in routes] == [
        (r.name, r.m, r.k, r.n, r.route.path) for r in jroutes]
    assert_close(got, want, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))


def test_systolic_utilization_matches_reference():
    assert systolic_utilization(10, 3, 32, 32) == pytest.approx(0.09375)  # paper: 9.3%
    for m, k, n, t in [(10, 3, 32, 32), (5120, 96, 32, 128), (7, 200, 300, 64)]:
        assert systolic_utilization(m, k, n, t) == jrouting.systolic_utilization(m, k, n, t)


def test_router_flattens_batch_dims_for_placement():
    x, w = torch.ones(4, 5, 3), torch.ones(3, 2)
    with record_routes() as routes:
        out = router.matmul(x, w, name="t")
    assert out.shape == (4, 5, 2) and torch.all(out == 3.0)
    assert (routes[0].m, routes[0].k, routes[0].n) == (20, 3, 2)


def test_init_paper_model_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    params = paper_models.init_paper_model("cnn", gen, device="cpu")
    jshapes = {k: v.shape for k, v in jpm.init_paper_model("cnn", jax.random.PRNGKey(0)).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == jshapes
    assert torch.all(params["fc_b"] == 0)
    assert abs(params["fc_w"].std().item() - 96 ** -0.5) < 0.02

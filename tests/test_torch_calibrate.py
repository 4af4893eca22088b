"""The port's measured-crossover calibration against the JAX package on the
CPU: ``runtime/platform.py``, ``runtime/autotune.py`` (the grid, the fit,
the measured utilizations, the artifact and its five refusals),
``RuntimeConfig.calibrated``, the ``[calibrated: ...]`` tag of
``RoutePlan.explain`` and the cycle report, and ``launch/calibrate.py``
(``divergence_report``, the merged int8 table and ``main``).

Everything the fit reads is compared exactly: utilizations, thresholds,
placements and report text.  Timings are the CPU's, of the engines' plain
versions; no time here is a device number.  Int8 scales are compared as
``test_torch_quant.py`` compares them (names equal, values within rtol
1e-6: the sample rows come through f32 prep on each side).  Artifacts go to
``tmp_path`` (and ``OCTOPUS_CACHE_DIR`` points there), never under ``~``."""
import json
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core.collaborative import OctopusCycleModel as JOctopusCycleModel
from repro.core.collaborative import usecase2_layers as jusecase2_layers
from repro.launch import calibrate as jcalibrate
from repro.models import paper_models as jpm
from repro.runtime import RoutePlan as JRoutePlan
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import autotune as jautotune
from repro.runtime import platform as jplatform
from repro_torch import convert
from repro_torch.core import router
from repro_torch.core.collaborative import OctopusCycleModel, usecase2_layers
from repro_torch.launch import calibrate
from repro_torch.runtime import (
    Calibration,
    RoutePlan,
    RuntimeConfig,
    ShapeTiming,
    autotune,
    fit_crossover,
    load_calibration,
    platform,
    save_calibration,
)


def _calib(tau=0.6, vpe_max_elems=1 << 21, backend="cpu", **kw):
    fp = dict(platform.fingerprint("cpu"), backend=backend)
    return Calibration(tau=tau, vpe_max_elems=vpe_max_elems, fingerprint=fp, **kw)


def _both(m, k, n, us_a, us_v):
    """The same grid point as a port and a reference ShapeTiming."""
    util = router.route_matmul(m, k, n).util
    return (ShapeTiming(m, k, n, util, us_a, us_v),
            jautotune.ShapeTiming(m, k, n, util, us_a, us_v))


# ---------------------------------------------------------------- platform


def test_platform_probes_the_named_device_and_never_falls_back():
    fp = platform.fingerprint("cpu")
    assert fp == {"backend": "cpu", "device_kind": "cpu", "torch": torch.__version__}
    assert platform.fingerprint_id(fp) == f"cpu/cpu/torch-{torch.__version__}"
    assert platform.fingerprint_id(device="cpu") == platform.fingerprint_id(fp)
    assert (platform.backend("cpu"), platform.device_count("cpu")) == ("cpu", 1)
    assert not platform.is_accelerator("cpu")
    # the reference's keys and id format, with the torch version for JAX's
    assert set(jplatform.fingerprint()) - {"jax"} == set(fp) - {"torch"}
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for probe in (platform.backend, platform.device_kind, platform.fingerprint):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probe()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe("cuda")


# ---------------------------------------------------------------- grid and fit


def test_default_grid_matches_the_reference():
    for smoke in (False, True):
        assert autotune.default_grid(smoke) == jautotune.default_grid(smoke)
    assert len(autotune.default_grid()) == 64 and len(autotune.default_grid(True)) == 8


GRID = autotune.default_grid()


@settings(max_examples=60, deadline=None)
@given(points=st.lists(st.tuples(st.sampled_from(GRID),
                                 st.sampled_from([1.0, 2.0, 3.0]),
                                 st.sampled_from([1.0, 2.0, 3.0])), max_size=12))
def test_fit_crossover_matches_the_reference(points):
    """Drawn timings: empty lists, no VPE win (us_vpe >= us_arype), ties
    between arms, repeated shapes and equal utilizations (the grid has many)."""
    pairs = [_both(m, k, n, a, v) for (m, k, n), a, v in points]
    ours = fit_crossover([p for p, _ in pairs])
    theirs = jautotune.fit_crossover([q for _, q in pairs], base=JRuntimeConfig())
    assert ours == theirs


def test_fit_crossover_edge_cases_match_the_reference():
    none_win = [_both(512, 128, 128, 1.0, 2.0), _both(64, 3, 8, 1.0, 1.0)]
    tied_utils = [_both(8, 64, 128, 2.0, 1.0), _both(8, 64, 128, 1.0, 2.0),
                  _both(16, 64, 128, 2.0, 1.0)]
    for case in ([], none_win, tied_utils):
        ours = fit_crossover([p for p, _ in case])
        assert ours == jautotune.fit_crossover([q for _, q in case], base=JRuntimeConfig())
    assert fit_crossover([]) == (0.35, 1 << 21)
    tau, vpe_max = fit_crossover([p for p, _ in none_win])
    assert tau < min(p.util for p, _ in none_win) and vpe_max == 1 << 21


def test_measured_utilizations_match_the_reference():
    grid = autotune.default_grid(smoke=True)
    timings = autotune.measure_crossover(grid, iters=1, device="cpu")
    base = JRuntimeConfig()
    for t, (m, k, n) in zip(timings, grid):
        assert (t.m, t.k, t.n) == (m, k, n)
        assert t.util == jautotune.mxu_utilization(m, k, n, tile=base.mxu_tile,
                                                   fill=base.fill_depth)
        assert t.us_arype > 0 and t.us_vpe > 0
    calib = autotune.calibrate(grid, iters=1, device="cpu")
    assert calib.backend == "cpu" and len(calib.timings) == 8
    assert (calib.tau, calib.vpe_max_elems) == fit_crossover(calib.timings)


# ---------------------------------------------------------------- the artifact


def test_artifact_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("OCTOPUS_CACHE_DIR", str(tmp_path))
    timing, _ = _both(10, 3, 32, 2.0, 1.0)
    table = convert.quant_scales_from_dict({"entries": [["w0", 0.5, [0.25, 0.125]],
                                                        ["conv1", 0.1, 0.2]]})
    calib = _calib(tau=0.42, vpe_max_elems=1 << 16, timings=(timing,), quant_scales=table)
    assert autotune.cache_path(device="cpu") == str(tmp_path / "calib-torch-cpu.json")
    path = save_calibration(calib)
    assert path == str(tmp_path / "calib-torch-cpu.json")
    loaded = load_calibration(device="cpu")
    assert loaded == calib
    cfg = loaded.apply()
    assert (cfg.tau, cfg.vpe_max_elems, cfg.quant_scales) == (0.42, 1 << 16, table)
    assert cfg.calibration == calib.fingerprint_id == platform.fingerprint_id(device="cpu")
    # the reference reads the port's artifact (its jax key aside) to the same thresholds
    raw = json.loads(open(path).read())
    raw["fingerprint"]["jax"] = raw["fingerprint"].pop("torch")
    ref = jautotune.Calibration.from_dict(raw)
    assert (ref.tau, ref.vpe_max_elems, ref.timings[0].util) == (0.42, 1 << 16, timing.util)
    assert ref.quant_scales.to_dict() == table.to_dict()


def _write(path, body):
    with open(path, "w") as f:
        f.write(body if isinstance(body, str) else json.dumps(body))


CASES = {
    "missing": ("no calibration artifact", None),
    "unreadable": ("unreadable", "{not json"),
    "schema": ("schema_version", dict(schema_version=2)),
    "malformed": ("malformed", dict(schema_version=1, fingerprint={"backend": "cpu"})),
    "backend": ("backend", "tpu"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_calibration_warns_and_refuses_as_the_reference(tmp_path, case):
    match, body = CASES[case]
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    if case == "backend":
        save_calibration(_calib(backend=body), ours)
        jautotune.save_calibration(jautotune.Calibration(
            tau=0.6, vpe_max_elems=1 << 21, fingerprint=dict(jplatform.fingerprint(),
                                                             backend=body)), theirs)
    elif body is not None:
        _write(ours, body)
        _write(theirs, body)
    with pytest.warns(UserWarning, match=match):
        assert load_calibration(ours, device="cpu") is None
    with pytest.warns(UserWarning, match=match):
        assert jautotune.load_calibration(theirs) is None
    with pytest.warns(UserWarning, match=match):
        cfg = RuntimeConfig.calibrated(ours, device="cpu")
    assert cfg == RuntimeConfig() and cfg.calibration is None


def test_a_jax_written_artifact_is_refused(tmp_path, monkeypatch):
    """The reference's CPU artifact has backend "cpu": it would pass the
    backend check, so the port names its own file and refuses a fingerprint
    without the torch version."""
    monkeypatch.setenv("OCTOPUS_CACHE_DIR", str(tmp_path))
    jpath = jautotune.save_calibration(jautotune.Calibration(
        tau=0.6, vpe_max_elems=1 << 21, fingerprint=jplatform.fingerprint()))
    assert jpath == str(tmp_path / "calib-cpu.json") != autotune.cache_path("cpu")
    with pytest.warns(UserWarning, match="no calibration artifact"):
        assert load_calibration(device="cpu") is None
    with pytest.warns(UserWarning, match="malformed"):
        assert load_calibration(jpath, device="cpu") is None


def test_calibrated_moves_a_route_and_quantize_needs_scales(tmp_path):
    """(128,64)x(64,96): util 0.375, arype under the analytic tau 0.35, vpe
    under a saved tau of 0.6, as in the reference's test."""
    path = str(tmp_path / "calib.json")
    save_calibration(_calib(tau=0.6), path)
    jpath = str(tmp_path / "ref.json")
    jautotune.save_calibration(jautotune.Calibration(
        tau=0.6, vpe_max_elems=1 << 21, fingerprint=jplatform.fingerprint()), jpath)
    cfg = RuntimeConfig.calibrated(path, device="cpu", policy="collaborative")
    jcfg = JRuntimeConfig.calibrated(jpath)
    assert [router.route_matmul(128, 64, 96, config=c).path
            for c in (RuntimeConfig(), cfg)] == ["arype", "vpe"]
    assert (cfg.tau, cfg.vpe_max_elems) == (jcfg.tau, jcfg.vpe_max_elems)
    assert cfg.calibration == platform.fingerprint_id(device="cpu")
    with pytest.warns(UserWarning, match="no quant_scales"):
        q = RuntimeConfig.calibrated(path, device="cpu", quantize=True)
    with pytest.warns(UserWarning, match="no quant_scales"):
        jq = JRuntimeConfig.calibrated(jpath, quantize=True)
    assert not q.quantize and not jq.quantize and q.tau == 0.6
    table = convert.quant_scales_from_dict({"entries": [["w0", 0.5, 0.25]]})
    save_calibration(_calib(tau=0.6, quant_scales=table), path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        q = RuntimeConfig.calibrated(path, device="cpu", quantize=True)
    assert q.quantize and q.quant_scales == table
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RuntimeConfig.calibrated(path)


@pytest.mark.parametrize("calibration", [None, "cpu/cpu/torch-test"])
def test_explain_header_and_cycle_report_carry_the_calibration(calibration):
    ours = RoutePlan.from_layers(usecase2_layers(1000),
                                 config=RuntimeConfig(tau=0.6, calibration=calibration))
    theirs = JRoutePlan.from_layers(jusecase2_layers(1000),
                                    config=JRuntimeConfig(tau=0.6, calibration=calibration))
    assert ours.explain() == theirs.explain()
    assert (f"[calibrated: {calibration}]" in ours.explain()) == (calibration is not None)
    for collaborative in (True, False):
        rep = OctopusCycleModel().stack_report(ours, collaborative=collaborative)
        jrep = JOctopusCycleModel().stack_report(theirs, collaborative=collaborative)
        assert rep["calibration"] == jrep["calibration"] == calibration
        assert rep == jrep


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("tau,vpe_max_elems", [(0.35, 1 << 21), (0.6, 1 << 21),
                                               (0.9, 1 << 26), (0.05, 1 << 10),
                                               (1.0, 1 << 30)])
@pytest.mark.parametrize("flows", [1000, 64])
def test_divergence_report_matches_the_reference(tau, vpe_max_elems, flows):
    cfg = RuntimeConfig(tau=tau, vpe_max_elems=vpe_max_elems, calibration="x")
    jcfg = JRuntimeConfig(tau=tau, vpe_max_elems=vpe_max_elems, calibration="x")
    for verbose in (False, True):
        assert calibrate.divergence_report(cfg, flows=flows, verbose=verbose) == \
            jcalibrate.divergence_report(jcfg, flows=flows, analytic=JRuntimeConfig(),
                                         verbose=verbose)


def test_merged_int8_table_matches_the_references_two_model_table():
    """The table ``main`` writes without ``--smoke``: the MLP, the CNN and
    the transformer, one port calibration a flow model, merged; the
    reference fits it in one call over both flow models."""
    ref = jcalibrate.calibrate_quant_scales(steps=16, flow_models=("cnn", "transformer"))

    def params(kind, seed):
        jp = jpm.init_paper_model(kind, jax.random.PRNGKey(seed))
        return convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                                         device="cpu")

    ours = calibrate.calibrate_quant_tables(
        params("mlp", 0), {"cnn": params("cnn", 1), "transformer": params("transformer", 1)},
        steps=16, device="cpu")
    assert ours.names() == ref.names()
    assert {"conv2", "fc", "wq", "mlp1", "w0"} <= set(ours.names())
    for (name, sx, sw), (_, jsx, jsw) in zip(ours.entries, ref.entries):
        np.testing.assert_allclose(sx, jsx, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(sw, jsw, rtol=1e-6, err_msg=name)


def test_main_on_the_cpu_writes_a_loadable_artifact(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OCTOPUS_CACHE_DIR", str(tmp_path / "cache"))
    out = str(tmp_path / "calib.json")
    assert calibrate.main(["--device", "cpu", "--smoke", "--iters", "1", "--no-quant",
                           "--out", out]) == 0
    text = capsys.readouterr().out
    calib = load_calibration(out, device="cpu")
    assert calib is not None and len(calib.timings) == 8 and calib.quant_scales is None
    assert f"[calibrate] platform: {platform.fingerprint_id(device='cpu')}" in text
    assert f"measured: tau={calib.tau:.4f} vpe_max_elems={calib.vpe_max_elems}" in text
    assert calibrate.divergence_report(calib.apply()) in text
    assert not (tmp_path / "cache").exists()
    assert f"vpe won {sum(t.vpe_wins for t in calib.timings)}/8 shapes" in text


def test_main_without_a_card_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate.main(["--smoke", "--no-quant", "--out", str(tmp_path / "c.json")])
    assert not (tmp_path / "c.json").exists()

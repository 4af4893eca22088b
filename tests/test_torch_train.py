"""The port's training path against the JAX package on the CPU: the engine
matmul's and the attention's backward, the loss and every gradient of
reduced LMs, the train step, and the trainer with its checkpoints.  The
reference runs its training arms (``use_pallas=False``, its default): jnp
engines and the naive or blockwise attention, differentiated by ``jax.grad``.

Tolerances.  f32 gradients: rtol 1e-5, atol 1e-5 * max|ref| (the order of
the f32 sums and the activations' derivatives differ from XLA's).  bf16
gradients: one bf16 step, plus that atol (an f32 value a last bit apart can
round to the neighbouring bf16 value).  Reduced LMs in f32 compute: the loss
within rtol 1e-5 and each gradient leaf within ``GRAD_SHARE`` of its
max|grad| (measured: 1.3e-6 for both archs).  Train steps, three in a row
against the jitted reference: the metrics within rtol 1e-5 and every
parameter and optimizer leaf within ``STEP_SHARE`` of its max|value|
(AdamW divides a gradient by its magnitude plus 1e-8, which magnifies the
last bits of gradients near 1e-8: measured 8.2e-5 on ``wi_up`` at the first
step).  With int8 compression a gradient a last bit apart can round to the
neighbouring code, a move of 1/127 of its leaf's max|g|: from the second
step on, the leaves within ``CODE_SHARE`` of max|value| and at most
``CODE_FLIPS`` of all their values past ``STEP_SHARE`` (measured: 6.3e-3 and
2.2e-5 at the third step).  The trainer resumed from the reference's
checkpoint: losses within rtol ``RESUME_RTOL`` over 10 steps."""
import itertools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.core import router as jrouter
from repro.data.tokens import TokenPipelineConfig as JTokenPipelineConfig
from repro.models import LM as JLM
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.train.loop import Trainer as JTrainer
from repro.train.loop import TrainLoopConfig as JTrainLoopConfig
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch import convert
from repro_torch.common.tree import tree_items
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import router
from repro_torch.data.tokens import TokenPipelineConfig
from repro_torch.kernels import launches, reset_launches
from repro_torch.models import layers, transformer
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.runtime import QuantScales, RuntimeConfig
from repro_torch.train.loop import Trainer, TrainLoopConfig
from repro_torch.train.steps import grads_of, make_eval_step, make_train_step

ACTS = ["none", "relu", "silu", "gelu"]
TYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TRIPLES = list(itertools.product(TYPES, repeat=3))  # (x, w, out)
RTOL = 1e-5
GRAD_SHARE = 1e-5
STEP_SHARE = 2e-4
CODE_SHARE = 1.5e-2
CODE_FLIPS = 1e-3
RESUME_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run thousands of small eager ops: under the test runner's
    parallel workers a pool of intra-op threads per op only contends with
    the other workers (a 3 s trainer test took 100 s), so each runs on one
    thread, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each |v|: 2^(e - 7) for |v| in [2^e, 2^(e+1))."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny))) - 7)


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_grad_close(got: torch.Tensor, want, what: str = "") -> None:
    """f32: rtol 1e-5, atol 1e-5 * max|want|; bf16: one bf16 step plus that atol."""
    g, w = np32(got), np32(want)
    atol = RTOL * max(np.abs(w).max(), 1e-30)
    if got.dtype == torch.bfloat16:
        bad = np.abs(g - w) > bf16_step(w) + atol
        assert not bad.any(), f"{what}: {bad.sum()} values beyond one bf16 step"
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=what)


def pair(rng, shape, dtype: str, scale: float = 1.0):
    """One array of normals in ``dtype`` as a JAX array and a torch tensor
    holding the same values."""
    a = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32), TYPES[dtype][1])
    return a, torch.from_numpy(np32(a).copy()).to(TYPES[dtype][0])


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- the engine backward


@pytest.mark.parametrize("policy", ["arype_only", "vpe_only"])
@pytest.mark.parametrize("xt,wt,ot", TRIPLES, ids=["-".join(t) for t in TRIPLES])
def test_engine_backward_matches_jax_grad(policy, xt, wt, ot):
    """dX and dW through ``router.matmul`` on the plain twins, for every
    activation, against ``jax.vjp`` of the reference's ``router.matmul``."""
    rng = np.random.default_rng(0)
    for act in ACTS:
        jx, x = pair(rng, (2, 5, 24), xt)
        jw, w = pair(rng, (24, 16), wt, 0.3)
        jct, ct = pair(rng, (2, 5, 16), ot)
        jcfg = JRuntimeConfig(policy=policy)

        def f(a, b):
            return jrouter.matmul(a, b, activation=act, out_dtype=TYPES[ot][1], config=jcfg)

        jout, vjp = jax.vjp(f, jx, jw)
        jdx, jdw = vjp(jct)
        x.requires_grad_()
        w.requires_grad_()
        out = router.matmul(x, w, activation=act, out_dtype=TYPES[ot][0],
                            config=RuntimeConfig(policy=policy))
        out.backward(ct)
        assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
        assert_grad_close(out, jout, f"{act} out")
        assert_grad_close(x.grad, jdx, f"{act} dx")
        assert_grad_close(w.grad, jdw, f"{act} dw")


def test_engine_function_leaves_no_grad_calls_alone_and_refuses_int8_backward():
    rng = np.random.default_rng(1)
    _, x = pair(rng, (6, 24), "bf16")
    _, w = pair(rng, (24, 16), "f32")
    cfg = RuntimeConfig(policy="arype_only")
    plain = router.matmul(x, w, activation="silu", config=cfg)
    out = router.matmul(x, w.clone().requires_grad_(), activation="silu", config=cfg)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "EngineMatmulBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert router.matmul(x, w.clone().requires_grad_(), config=cfg).grad_fn is None
    meta = router.matmul(x.to("meta").requires_grad_(), w.to("meta"), config=cfg)
    assert meta.device.type == "meta" and tuple(meta.shape) == (6, 16)
    table = QuantScales((("q", 0.05, 0.02),))
    qcfg = RuntimeConfig(policy="arype_only", quantize=True, quant_scales=table)
    router.matmul(x, w, config=qcfg, name="q")  # no grad: runs
    with pytest.raises(NotImplementedError, match="int8 route"):
        router.matmul(x, w.clone().requires_grad_(), config=qcfg, name="q")


def test_backward_products_place_themselves_and_record_no_route():
    """Under ``record_routes`` only the forward's matmul is recorded: the
    backward's products place themselves without recording (autograd may
    run them on another thread)."""
    from repro_torch.runtime import record_routes

    x = torch.randn(2, 5, requires_grad=True)
    w = torch.randn(5, 3, requires_grad=True)
    with record_routes() as routes:
        router.matmul(x, w, config=RuntimeConfig(), name="tiny").sum().backward()
    assert [(r.name, r.m, r.k, r.n) for r in routes] == [("tiny", 2, 5, 3)]
    assert x.grad is not None and w.grad is not None


# ---------------------------------------------------------------- the attention backward


ATTN_CASES = [  # b, s, hq, hkv, d, kind, window
    (2, 12, 4, 2, 8, "causal", 0),
    (1, 16, 4, 1, 16, "local", 5),
    (2, 9, 2, 2, 8, "full", 0),
    (1, 1040, 2, 1, 8, "causal", 0),  # S * Sk > 2^20: the blockwise arm
    (1, 1032, 2, 2, 8, "local", 300),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[f"{c[5]}-s{c[1]}-g{c[2] // c[3]}"
                                                  for c in ATTN_CASES])
def test_attention_backward_matches_jax_grad(case):
    """dq, dk, dv of ``attention_train`` (the flash twin forward, the
    reference arm's backward) against ``jax.vjp`` of the reference's
    ``attention_core`` without Pallas (naive, or blockwise past 2^20 scores)."""
    b, s, hq, hkv, d, kind, window = case
    rng = np.random.default_rng(2)
    (jq, q), (jk, k), (jv, v), (jct, ct) = (pair(rng, (b, s, h, d), "f32")
                                            for h in (hq, hkv, hkv, hq))

    def f(q_, k_, v_):
        return jlayers.attention_core(q_, k_, v_, kind=kind, window=window)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = layers.attention_train(q, k, v, kind=kind, window=window)
    assert type(out.grad_fn).__name__ == "TrainAttentionBackward"
    out.backward(ct)
    assert_grad_close(out, jout, "out")
    for name, got, want in zip("qkv", leaves, vjp(jct)):
        assert_grad_close(got.grad, want, f"d{name}")


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 7), ("full", 0)])
def test_blockwise_attention_matches_the_reference_at_ragged_chunks(kind, window):
    """The port's ``_blockwise_attention`` and its gradient against the
    reference's at chunks that leave S and Sk ragged, in bf16 (the output in
    q's type)."""
    rng = np.random.default_rng(3)
    (jq, q), (jk, k), (jv, v) = (pair(rng, (2, 21, 2, 1, 8), "bf16"),
                                 pair(rng, (2, 21, 2, 8), "bf16"), pair(rng, (2, 21, 2, 8), "bf16"))
    jct, ct = pair(rng, (2, 21, 2, 1, 8), "bf16")

    def f(q_, k_, v_):
        return jlayers._blockwise_attention(q_, k_, v_, kind=kind, window=window, chunk_q=8,
                                            chunk_kv=6)

    jout, vjp = jax.vjp(f, jq, jk, jv)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = layers._blockwise_attention(q, k, v, kind=kind, window=window, chunk_q=8, chunk_kv=6)
    out.backward(ct)
    assert_grad_close(out, jout, "out")
    for name, got, want in zip("qkv", leaves, vjp(jct)):
        assert_grad_close(got.grad, want, f"d{name}")


# ---------------------------------------------------------------- loss and gradients


def lm_batch(vocab: int, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module", params=["qwen3-0.6b", "granite-moe-1b-a400m"])
def lm_grads(request):
    """The reference's loss, metrics and gradients (``jax.value_and_grad``
    of its ``loss_fn``) of one reduced arch in f32 compute, with its
    params and batch."""
    jcfg = jreduced_config(jget_config(request.param))
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    batch = lm_batch(jcfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(jtransformer.loss_fn, has_aux=True), static_argnums=1)
    (loss, metrics), grads = fn(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return request.param, to_np(jp), batch, float(loss), to_np(metrics), to_np(grads)


def test_loss_and_every_gradient_match_jax_value_and_grad(lm_grads, record_property):
    arch, jp, batch, jloss, jmetrics, jgrads = lm_grads
    cfg = reduced_config(get_config(arch))
    params = convert.lm_params_from_numpy(jp, device="cpu")
    grads, metrics = grads_of(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=RTOL)
    ref = dict((jax.tree_util.keystr(k), v)
               for k, v in jax.tree_util.tree_flatten_with_path(jgrads)[0])
    port = dict(tree_items(grads))
    assert sorted(port) == sorted(ref)
    worst = 0.0
    for key, g in port.items():
        top = np.abs(ref[key]).max()
        share = float(np.abs(g.numpy() - ref[key]).max() / max(top, 1e-30))
        assert share <= GRAD_SHARE, (key, share)
        worst = max(worst, share)
    record_property("worst_grad_share", worst)
    if arch.startswith("granite"):  # the MoE's aux keeps its graph through forward_train
        layer = params["blocks"]["l0"]
        router_w = layer["ffn"]["router"].clone().requires_grad_()
        live = dict(params, blocks=dict(params["blocks"], l0=dict(
            layer, ffn=dict(layer["ffn"], router=router_w))))
        _, aux = transformer.forward_train(live, cfg, {"tokens": torch.as_tensor(batch["tokens"])})
        (d_router,) = torch.autograd.grad(aux, router_w)
        assert float(metrics["aux"]) > 0 and d_router.abs().max() > 0
    # the eval step gives the same metrics without a graph
    evaluated = make_eval_step(cfg)(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert all(v.grad_fn is None for v in evaluated.values())
    assert float(evaluated["loss"]) == float(metrics["loss"])


# ---------------------------------------------------------------- train steps


STEP_VARIANTS = [(1, False), (2, True)]  # (accum_steps, compress_grads)


@pytest.fixture(scope="module", params=STEP_VARIANTS, ids=["accum1", "accum2-int8"])
def reference_steps(request):
    """Three jitted reference train steps of reduced qwen3-0.6b (AdamW on a
    cosine schedule), from step 2, with their params, batches, metrics and
    state after each step."""
    accum, compress = request.param
    jcfg = jreduced_config(jget_config("qwen3-0.6b"))
    jp = JLM(jcfg).init(jax.random.PRNGKey(1))
    opt = jmake_optimizer("adamw", jcosine_schedule(1e-2, 2, 8))
    step_fn = jax.jit(jmake_train_step(jcfg, opt, grad_clip=0.5, accum_steps=accum,
                                       compress_grads=compress))
    state = opt.init(jp)
    batches = [lm_batch(jcfg.vocab_size, b=4, s=8, seed=s) for s in range(3)]
    out = [(to_np(jp), to_np(state))]
    metrics = []
    for i, batch in enumerate(batches):
        jp, state, m = step_fn(jp, state, jnp.asarray(2 + i, jnp.int32),
                               {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((to_np(jp), to_np(state)))
        metrics.append(to_np(m))
    return accum, compress, batches, out, metrics


def test_three_train_steps_match_the_jitted_reference(reference_steps):
    accum, compress, batches, states, jmetrics = reference_steps
    cfg = reduced_config(get_config("qwen3-0.6b"))
    opt = make_optimizer("adamw", cosine_schedule(1e-2, 2, 8))
    step_fn = make_train_step(cfg, opt, grad_clip=0.5, accum_steps=accum, compress_grads=compress)
    params = convert.lm_params_from_numpy(states[0][0], device="cpu")
    opt_state = opt.init(params)
    for i, batch in enumerate(batches):
        params, opt_state, metrics = step_fn(params, opt_state, 2 + i,
                                             {k: torch.as_tensor(v) for k, v in batch.items()})
        for key in ("ce", "aux", "loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[i][key]), rtol=RTOL,
                                       atol=1e-7, err_msg=f"step {i} {key}")
        want = dict((jax.tree_util.keystr(k), v) for k, v in
                    jax.tree_util.tree_flatten_with_path({"params": states[i + 1][0],
                                                          "opt": states[i + 1][1]})[0])
        got = dict(tree_items({"params": params, "opt": opt_state}))
        assert sorted(got) == sorted(want)
        limit = CODE_SHARE if compress and i > 0 else STEP_SHARE
        past = total = 0
        for key, t in got.items():
            top = max(np.abs(want[key]).max(), 1e-30)
            diff = np.abs(t.numpy() - want[key]) / top
            assert diff.max() <= limit, (i, key, float(diff.max()))
            past, total = past + int((diff > STEP_SHARE).sum()), total + diff.size
        assert past <= CODE_FLIPS * total, (i, past, total)


# ---------------------------------------------------------------- the trainer


def _loop(directory, **kw):
    return TrainLoopConfig(total_steps=20, checkpoint_every=10, checkpoint_dir=str(directory),
                           log_every=100, async_checkpoints=False, **kw)


def test_trainer_resumes_bit_exact_after_a_crash(tmp_path):
    """20 steps straight against 13 + crash + resume from step 10: the same
    losses and final parameters, bit for bit (one device, one order of
    operations)."""
    cfg = reduced_config(get_config("qwen3-0.6b"))
    data = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    straight = Trainer(cfg, _loop(tmp_path / "straight"), data, device="cpu").run()
    with pytest.raises(RuntimeError, match="injected failure at step 13"):
        Trainer(cfg, _loop(tmp_path / "resumed", fail_at_step=13), data, device="cpu").run()
    resumed = Trainer(cfg, _loop(tmp_path / "resumed"), data, device="cpu")
    assert resumed.ckpt.latest_step() == 10
    out = resumed.run()
    assert out["history"] == straight["history"][10:]
    for (key, a), (_, b) in zip(tree_items(straight["params"]), tree_items(out["params"])):
        assert torch.equal(a, b), key
    assert straight["median_step_time_s"] > 0 and straight["straggler_steps"] >= 0


def test_trainer_resumes_the_references_checkpoint(tmp_path):
    """The reference trainer runs 20 steps with a checkpoint at 10; the port's
    trainer restores that checkpoint and runs steps 10-19: its losses follow
    the reference's ``history[10:]``.  Then the port's own step-20
    checkpoint restores in the reference's ``load_pytree``."""
    from repro.checkpoint import load_pytree as jload_pytree

    jcfg = jreduced_config(jget_config("qwen3-0.6b"))
    cfg = reduced_config(get_config("qwen3-0.6b"))
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    ref_dir = tmp_path / "ref"
    jout = JTrainer(jcfg, JTrainLoopConfig(total_steps=20, checkpoint_every=10,
                                           checkpoint_dir=str(ref_dir), log_every=100,
                                           async_checkpoints=False),
                    JTokenPipelineConfig(**kw)).run()
    port_dir = tmp_path / "port"
    os.makedirs(port_dir)
    shutil.copytree(ref_dir / "step_00000010", port_dir / "step_00000010")
    trainer = Trainer(cfg, _loop(port_dir), TokenPipelineConfig(**kw), device="cpu")
    out = trainer.run()
    assert len(out["history"]) == 10
    np.testing.assert_allclose(out["history"], jout["history"][10:], rtol=RESUME_RTOL)
    jstate = JLM(jcfg).init(jax.random.PRNGKey(0))
    like = {"params": jstate, "opt": jmake_optimizer("adamw", 1e-3).init(jstate)}
    restored, extra = jload_pytree(str(port_dir / "step_00000020"), like)
    assert extra["next_step"] == 20
    for (key, got), (_, want) in zip(tree_items({"params": out["params"], "opt": out["opt_state"]}),
                                     jax.tree_util.tree_flatten_with_path(restored)[0]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=key)


def test_train_launcher_runs_a_reduced_arch_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    reset_launches()
    out = main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "8",
                "--ckpt", str(tmp_path), "--ckpt-every", "2", "--accum", "2"])
    assert len(out["history"]) == 3 and np.isfinite(out["final_loss"])
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    assert "[train] qwen3-0.6b (reduced) on cpu" in capsys.readouterr().out
    assert all(n == 0 for n in launches().values())  # the CPU runs no kernel


def test_train_launcher_resumes_only_a_named_directory(tmp_path, monkeypatch, capsys):
    """Without ``--ckpt`` each run starts fresh in its own directory under the
    temp dir; a second run on a finished ``--ckpt`` says there is nothing to
    run."""
    import tempfile

    from repro_torch.launch.train import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8"]
    first, second = main(args), main(args)
    assert len(first["history"]) == 2 and second["history"] == first["history"]
    assert len(os.listdir(tmp_path / "tmp")) == 2
    capsys.readouterr()
    again = main(args + ["--ckpt", os.path.join(tmp_path / "tmp", sorted(os.listdir(tmp_path / "tmp"))[0])])
    assert again["history"] == []
    assert "nothing to run" in capsys.readouterr().out


def test_quickstart_twin_runs_on_the_cpu(capsys):
    """``examples/quickstart_torch.py``: train, checkpoint, restore, the
    prefill's placement traced on ``meta`` tensors (an LM cache of
    ``AttnCache`` tuples; the attention passes them through, launching
    nothing), decode."""
    import runpy

    main = runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "examples",
                                       "quickstart_torch.py"))["main"]
    main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "checkpoint restored from step 20" in out and "RoutePlan: 15 matmuls" in out
    assert len(out.split("decoded: [")[1].split(",")) == 9

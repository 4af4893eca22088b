"""The port's flash attention (``repro_torch.kernels.flash_attention``) against
the JAX package's: the wrapper and its plain twin on CPU tensors against the
reference Pallas ``flash_attention`` (interpret mode, as
``tests/test_kernels.py`` runs it) and the oracle ``ref_attention``.

Tolerances are the reference test's: rtol = atol = 2e-5 in f32 (the order of
the f32 sums and exp differ), 3e-2 in bf16 (the output's rounding).  Inputs
are made with numpy and rounded to bf16 the same way in both frameworks.
Fully masked rows must be exactly 0 in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro.kernels.flash_attention import ref_attention as jref_attention
from repro.kernels.flash_attention.flash_attention import flash_fwd as jflash_fwd
from repro_torch.kernels import KERNELS
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_fwd,
    ref_attention,
)
from repro_torch.kernels.flash_attention.ops import valid_pairs

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def inputs(b, hq, hkv, sq, sk, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def as_np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def folded_ref(q, k, v, **kw):
    """The port's oracle on the GQA-repeated, head-folded tensors."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    fold = lambda t: t.repeat_interleave(g, dim=1).reshape(b * hq, t.shape[2], d)
    return ref_attention(q.reshape(b * hq, sq, d), fold(k), fold(v), **kw).reshape(q.shape)


# the reference test's sweep (tests/test_kernels.py::test_flash_attention_sweep)
SWEEP = [(2, 4, 2, 256, 256, 32, "causal", 0), (1, 4, 1, 128, 384, 16, "full", 0),
         (2, 2, 2, 300, 300, 32, "local", 64), (1, 8, 4, 256, 512, 64, "causal", 0),
         (1, 2, 2, 64, 64, 128, "local", 16)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,mask,win", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_reference_sweep(b, hq, hkv, sq, sk, d, mask, win, dtype):
    (jq, jk, jv), (q, k, v) = inputs(b, hq, hkv, sq, sk, d, dtype, seed=b * 7 + sq)
    want = as_np(jflash_attention(jq, jk, jv, mask=mask, window=win))
    got = flash_attention(q, k, v, mask=mask, window=win)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(as_np(got), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(folded_ref(q, k, v, mask=mask, window=win)), want,
                               rtol=tol, atol=tol)


# ragged Sq/Sk, kv_len < Sk, and fully masked rows (local with a short kv_len)
RAGGED = [(1, 4, 2, 77, 190, 16, "causal", 0, None), (1, 4, 1, 100, 130, 16, "full", 0, 70),
          (2, 2, 2, 77, 190, 16, "local", 20, 5), (1, 2, 1, 33, 33, 8, "local", 7, 30),
          (1, 2, 2, 129, 129, 24, "causal", 0, 100)]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,mask,win,kv_len", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_ragged_and_kv_len_match_reference(b, hq, hkv, sq, sk, d, mask, win, kv_len,
                                                   dtype):
    (jq, jk, jv), (q, k, v) = inputs(b, hq, hkv, sq, sk, d, dtype, seed=sq + sk)
    kw = dict(mask=mask, window=win, kv_len=kv_len)
    want = as_np(jflash_attention(jq, jk, jv, bq=32, bk=32, **kw))
    got = as_np(flash_attention(q, k, v, **kw))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(flash_attention_plain(q, k, v, bq=32, bk=32, **kw)), want,
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(folded_ref(q, k, v, **kw)), want, rtol=tol, atol=tol)
    dead = ~valid_pairs(mask, win, sk if kv_len is None else kv_len,
                        torch.arange(sq)[:, None], torch.arange(sk)[None]).any(dim=1).numpy()
    assert (got[:, :, dead] == 0).all() and (want[:, :, dead] == 0).all()
    if (mask, kv_len) == ("local", 5):
        assert dead.sum() == sq - 5 - win + 1  # rows 24.. see no key


@pytest.mark.parametrize("mask,win", [("causal", 0), ("local", 40), ("full", 0)])
@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 32)])
def test_plain_flash_fwd_matches_reference_body(mask, win, bq, bk):
    """The plain twin against the reference's own Pallas body at the same
    blocks (interpret mode; shapes the blocks divide, as it requires)."""
    rng = np.random.default_rng(bq + bk)
    q, k, v = (rng.standard_normal((3, 256, 16)).astype(np.float32) for _ in range(3))
    want = np.asarray(jflash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=mask,
                                 window=win, bq=bq, bk=bk, kv_len=200))
    got = flash_fwd(*map(torch.from_numpy, (q, k, v)), mask=mask, window=win, bq=bq, bk=bk,
                    kv_len=200)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mask,win,kv_len", [("causal", 0, None), ("local", 13, None),
                                             ("full", 0, 50), ("local", 5, 3)])
def test_result_does_not_depend_on_blocks(mask, win, kv_len):
    _, (q, k, v) = inputs(2, 4, 2, 77, 90, 16, "float32", seed=3)
    kw = dict(mask=mask, window=win, kv_len=kv_len)
    outs = [flash_attention_plain(q, k, v, bq=bq, bk=bk, **kw)
            for bq, bk in ((16, 16), (32, 64), (128, 128), (77, 90))]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=2e-5, atol=2e-5)


def test_wrapper_takes_strided_views_and_counts_no_launch_on_cpu():
    """The LM hands over (B, S, H, D) tensors transposed to (B, H, S, D); on
    CPU tensors the plain twin runs and the kernel's counter stays still."""
    _, (q, k, v) = inputs(2, 4, 2, 40, 40, 16, "float32", seed=5)
    before = KERNELS["flash_fwd"].launches
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views), flash_attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(flash_attention_plain(q, k, v), flash_attention(q, k, v),
                               rtol=0, atol=0)
    assert KERNELS["flash_fwd"].launches == before


def test_wrapper_refuses_bad_arguments():
    _, (q, k, v) = inputs(1, 4, 2, 8, 8, 16, "float32", seed=0)
    with pytest.raises(ValueError, match="mask"):
        flash_attention(q, k, v, mask="sliding")
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention(q, k, v, kv_len=9)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, mask="local", window=-1)
    with pytest.raises(ValueError, match="against"):
        flash_attention(q, k[:, :1].expand(1, 3, 8, 16), v[:, :1].expand(1, 3, 8, 16))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_jax_and_torch_inputs_round_to_the_same_bf16():
    (jq, _, _), (q, _, _) = inputs(1, 1, 1, 16, 16, 16, "bfloat16", seed=9)
    np.testing.assert_array_equal(np.asarray(jq, np.float32), q.float().numpy())
    assert jax.devices()[0].platform == "cpu"

"""The port's flash_attention slice against the JAX package on the same
inputs: the plain version (what the wrapper runs for CPU tensors) against
JAX's Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py
runs it) and JAX's ``attention_ref`` at tests/test_kernels.py's cases and
tolerance; ``ops.attention`` and its gradients against JAX's
``custom_vjp``; the model-layout attention of ``models.layers`` against
JAX's ``attention_traced`` / ``attention_chunked``; and the wrapper's
checks of what the kernel takes. The kernel itself runs only on the card
(tests/test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jflash_attention,
)
from repro.kernels.flash_attention.ops import attention as jattention
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L

# tests/test_kernels.py's cases, kwargs and tolerances
ATTN_CASES = [
    dict(b=1, h=1, hkv=1, sq=16, sk=16, d=8),
    dict(b=2, h=4, hkv=2, sq=64, sk=64, d=16),
    dict(b=2, h=4, hkv=1, sq=33, sk=65, d=32),   # ragged → padding paths
    dict(b=1, h=8, hkv=8, sq=128, sk=128, d=64),
]
KWARGS = [dict(causal=True), dict(causal=True, window=16),
          dict(causal=True, softcap=30.0), dict(causal=False)]
TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(b, h, hkv, sq, sk, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype),
            rng.standard_normal((b, hkv, sk, d)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kw", KWARGS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(
    str(v) for v in c.values()))
def test_flash_attention_matches_jax(case, kw):
    q, k, v = _qkv(**case, seed=case["sq"])
    want = np.asarray(jattention_ref(q, k, v, **kw))
    before = flash_attention.launches
    got = flash_attention(*_t(q, k, v), **kw)
    assert flash_attention.launches == before      # a CPU tensor: plain
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(attention_ref(*_t(q, k, v), **kw).numpy(),
                               want, rtol=TOL, atol=TOL)
    # the Pallas kernel pads a ragged bidirectional case with keys it does
    # not mask (tests/test_kernels.py skips it); compare where it is defined
    if kw.get("causal", True) or case["sq"] == case["sk"]:
        pallas = np.asarray(jflash_attention(q, k, v, block_q=32, block_k=32,
                                             **kw))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 0.0), (0, 50.0),
                                            (40, 50.0)])
def test_flash_attention_decode_offset(window, softcap):
    """One query at position 95 against a 96-key cache (the JAX test's
    case), with gemma2's window and softcap too."""
    q, k, v = _qkv(2, 4, 2, 1, 96, 16, seed=9)
    kw = dict(q_offset=95, window=window, softcap=softcap)
    got = flash_attention(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jattention_ref(q, k, v, **kw)),
                               rtol=TOL, atol=TOL)
    pallas = jflash_attention(q, k, v, block_q=1, block_k=32, **kw)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)


def test_flash_attention_bf16_matches_jax():
    """bf16 in, bf16 out, f32 inside: the port and JAX round the same f32
    result (up to f32 summation order) to bf16, so they differ by at most
    one bf16 ulp (2^-8 relative)."""
    q, k, v = _qkv(2, 4, 2, 40, 40, 32, seed=3)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jattention_ref(qj, kj, vj, window=16, softcap=30.0)
                      .astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qj, kj, vj))
    got = flash_attention(qt, kt, vt, window=16, softcap=30.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_strided_view_equals_contiguous_copy():
    """The model's (B, S, H, D) tensors seen as (B, H, S, D) views give what
    a contiguous copy gives."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 24, 6, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 30, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 30, 2, 16)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    kw = dict(window=8, softcap=20.0, q_offset=6)
    a = flash_attention(*views, **kw)
    b = flash_attention(*(t.contiguous() for t in views), **kw)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ops_attention_forward_matches_jax():
    q, k, v = _qkv(1, 4, 2, 20, 20, 8, seed=11)
    for use_kernel in (True, False):
        got = attention(*_t(q, k, v), True, 6, 25.0, 0, use_kernel)
        want = jattention(q, k, v, True, 6, 25.0, 0, use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("h,hkv,window,softcap,q_offset", [
    (2, 1, 0, 0.0, 0),          # tests/test_kernels.py's grad case
    (4, 2, 5, 30.0, 0),
    (4, 1, 0, 50.0, 3)])
def test_attention_grad_matches_jax(h, hkv, window, softcap, q_offset):
    q, k, v = _qkv(1, h, hkv, 16, 16 + q_offset, 8, seed=10)

    def f(q, k, v):
        return jnp.sum(jattention(q, k, v, True, window, softcap, q_offset,
                                  True) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = attention(qt, kt, vt, True, window, softcap, q_offset)
    (out ** 2).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (16, 0.0), (0, 25.0),
                                            (16, 50.0)])
def test_model_layout_attention_matches_jax(window, softcap):
    """``models.layers.attention`` (every branch through ``ops.attention``)
    against JAX's ``attention_traced`` and ``attention_chunked`` — prefill
    at positions 0..S-1, and a decode query at position ``cache_len``
    against an S_max-slot cache."""
    rng = np.random.default_rng(0)
    b, s, h, hkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(JL.attention_traced(q, k, v, q_positions=pos,
                                          k_positions=pos, **kw))
    chunked = np.asarray(JL.attention_chunked(q, k, v, q_positions=pos,
                                              k_positions=pos, chunk=16, **kw))
    for use_kernel, chunk in ((True, 0), (False, 0), (False, 16)):
        got = L.attention(*_t(q, k, v), q_offset=0, use_kernel=use_kernel,
                          chunk=chunk, **kw)
        assert got.shape == (b, s, h, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), chunked, rtol=TOL, atol=TOL)
    # decode: one query at position 40 against all 64 slots
    qpos = np.full((b, 1), 40)
    want = np.asarray(JL.attention_traced(q[:, :1], k, v, q_positions=qpos,
                                          k_positions=pos, **kw))
    got = L.attention(*_t(q[:, :1], k, v), q_offset=40, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_wrapper_checks_what_the_kernel_takes():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    fa._check(q, k, k)                                 # fits
    fa._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="GQA"):
        fa._check(torch.zeros((1, 3, 8, 16)), k, k)
    with pytest.raises(ValueError, match="head dim"):
        fa._check(torch.zeros((1, 4, 8, 6)), torch.zeros((1, 2, 8, 6)),
                  torch.zeros((1, 2, 8, 6)))
    with pytest.raises(ValueError, match="head dim"):
        fa._check(torch.zeros((1, 4, 8, 260)), torch.zeros((1, 2, 8, 260)),
                  torch.zeros((1, 2, 8, 260)))
    with pytest.raises(ValueError, match="dtype"):
        fa._check(q.to(torch.bfloat16), k, k)
    with pytest.raises(ValueError, match="D contiguous"):
        fa._check(torch.zeros((1, 4, 16, 8)).transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="do not fit"):
        fa._check(q, torch.zeros((1, 2, 8, 16)), torch.zeros((1, 2, 9, 16)))

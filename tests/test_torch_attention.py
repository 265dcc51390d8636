"""The port's flash_attention slice against the JAX package on the same
inputs: the plain version (what the wrapper runs for CPU tensors) against
JAX's Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py
runs it) and JAX's ``attention_ref`` at tests/test_kernels.py's cases and
tolerance; ``ops.attention`` and its gradients against JAX's
``custom_vjp``; the model-layout attention of ``models.layers`` against
JAX's ``attention_traced`` / ``attention_chunked``; the wrapper's
checks of what the kernels take and its choice among them; the bf16
decode kernel's split math (``attention_split_ref``, ``split_plan``)
against JAX's ``attention_ref``; and a numerics model of the bf16 prefill
kernel (P as bf16 hi + lo) against JAX's ``attention_ref`` at the bf16
check's tolerance. The kernels themselves run only on the card
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
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, attention_split_ref, split_plan,
)
from repro_torch.models import layers as L
from test_torch_engine import release_jax_executables  # noqa: F401

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
    # bf16 takes the tensor-core kernels: head dims in steps of 16
    fa._check(*(t.to(torch.bfloat16) for t in (q, k, k)))
    with pytest.raises(ValueError, match="head dim"):
        fa._check(*(torch.zeros(s, dtype=torch.bfloat16)
                    for s in ((1, 4, 8, 24), (1, 2, 8, 24), (1, 2, 8, 24))))


# The bf16 decode kernel's math (split over the keys, log-sum-exp combine)
SPLIT_KW = [dict(q_offset=95),
            dict(q_offset=95, window=40, softcap=50.0),
            dict(q_offset=92, window=2),          # 5 visible keys: at 8
            dict(q_offset=60, window=3, causal=False),  # splits, 3 empty
            dict(q_offset=0)]


@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("kw", SPLIT_KW, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_attention_split_ref_matches_jax(n_split, kw, sq):
    """Partials per split and their log-sum-exp combine give JAX's
    attention in f32, also where whole splits see no key (no NaN)."""
    q, k, v = _qkv(2, 4, 2, sq, 96, 16, seed=n_split + sq)
    want = np.asarray(jattention_ref(q, k, v, **kw))
    got = attention_split_ref(*_t(q, k, v), n_split, **kw)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_a_row_that_sees_no_key():
    """A window that ends before the first key: JAX's and the port's
    ``attention_ref`` give the mean of V (every logit is -1e30), the split
    math gives 0 (its masked keys weigh exactly 0); the wrapper documents
    the difference. The other rows agree."""
    q, k, v = _qkv(1, 4, 2, 3, 50, 16, seed=3)
    kw = dict(q_offset=60, window=12)     # rows at 60, 61, 62 see 49, -, -
    want = np.asarray(jattention_ref(q, k, v, **kw))
    ref = attention_ref(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(ref, want, rtol=TOL, atol=TOL)
    mean_v = np.repeat(v.mean(axis=2), 2, axis=1)
    np.testing.assert_allclose(ref[:, :, 1:], np.repeat(mean_v[:, :, None], 2,
                                                        axis=2),
                               rtol=TOL, atol=TOL)
    got = attention_split_ref(*_t(q, k, v), None, **kw).numpy()
    np.testing.assert_allclose(got[:, :, :1], want[:, :, :1], rtol=TOL,
                               atol=TOL)
    assert (got[:, :, 1:] == 0).all()


@pytest.mark.parametrize("sq,sk,kw", [
    (1, 8225, dict(q_offset=8222)),                 # gemma2's last round
    (1, 8225, dict(q_offset=8222, window=4096)),
    (1, 1000, dict(q_offset=998)),
    (8, 1000, dict(q_offset=990, window=5)),
    (2, 2000, dict(q_offset=1200, causal=False)),
    (1, 50, dict(q_offset=10, window=100)),
    (3, 300, dict(q_offset=400, window=150))])      # queries past the keys
@pytest.mark.parametrize("pairs,n_split", [(32, None), (1, None), (4, 8),
                                           (16, 3)])
def test_split_plan_covers_the_visible_keys_once(sq, sk, kw, pairs, n_split):
    lo, hi, chunk, n = split_plan(sq, sk, pairs=pairs, n_split=n_split, **kw)
    # the visible keys of the union of the rows, by brute force
    p = kw["q_offset"] + np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if kw.get("causal", True):
        vis &= p >= j
    if kw.get("window", 0) > 0:
        vis &= p - j < kw["window"]
    keys = np.flatnonzero(vis.any(axis=0))
    assert list(range(lo, hi)) == list(keys)
    if n_split is not None:
        assert n == n_split
    seen = np.zeros(sk, int)
    for s in range(n):
        c0, c1 = lo + s * chunk, min(lo + (s + 1) * chunk, hi)
        assert lo <= c0 and c1 <= hi or c1 <= c0
        if c1 > c0:
            seen[c0:c1] += 1
        elif n_split is None:
            raise AssertionError(f"split {s} of a chosen plan is empty")
    assert (seen[keys] == 1).all() and seen.sum() == len(keys)


def test_split_plan_fills_the_card_at_gemma2_decode():
    """gemma2's decode (4 slots x 8 kv heads) takes more than one split,
    and at least two CTAs per SM of the H100's 132."""
    for window in (0, 4096):
        *_, n = split_plan(1, 8225, q_offset=8222, window=window, pairs=32)
        assert n > 1 and 32 * n >= 2 * 132


def test_dispatch_by_dtype_and_shape():
    bf = torch.bfloat16
    dec_q, cache = torch.zeros((4, 16, 1, 256), dtype=bf), \
        torch.zeros((4, 8, 8225, 256), dtype=bf)
    how = fa.dispatch(dec_q, cache, q_offset=8222)
    assert how["kernel"] == "split" and how["n_split"] > 1
    pre_q, pre_k = torch.zeros((1, 16, 8192, 256), dtype=bf), \
        torch.zeros((1, 8, 8192, 256), dtype=bf)
    assert fa.dispatch(pre_q, pre_k)["kernel"] == "prefill"
    # many slots fill the card without a split; f32 keeps the f32 kernel
    many = torch.zeros((64, 8, 4096, 128), dtype=bf)
    assert fa.dispatch(torch.zeros((64, 16, 1, 128), dtype=bf), many,
                       q_offset=4000)["kernel"] == "prefill"
    assert fa.dispatch(dec_q.float(), cache.float(),
                       q_offset=8222)["kernel"] == "f32"
    # deepseek's group of 7 decodes split; past SPLIT_ROWS folded rows
    # (two positions of it) the prefill kernel takes the call
    ds = torch.zeros((4, 8, 2000, 128), dtype=bf)
    for sq, kernel in ((1, "split"), (2, "prefill")):
        assert fa.dispatch(torch.zeros((4, 56, sq, 128), dtype=bf), ds,
                           q_offset=1500)["kernel"] == kernel


def _prefill_model(q, k, v, *, window, softcap, p_parts, block_n=32):
    """The bf16 prefill kernel's numerics in plain PyTorch: bf16 q, k, v;
    Q K^T in f32; the logits in log2 units; an online softmax over
    ``block_n``-key tiles; P as ``p_parts`` bf16 terms (2: hi + lo, 1: one
    bf16 P); P V summed in f32; the output rounded to bf16."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    qf = q.float()
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    mul, cap = (d ** -0.5 / softcap, softcap * np.log2(np.e)) if softcap \
        else (d ** -0.5 * np.log2(np.e), 0.0)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for kb in range(0, k.shape[2], block_n):
        s = qf @ kf[:, :, kb:kb + block_n].transpose(-1, -2)
        x = cap * torch.tanh(s * mul) if cap else s * mul
        kpos = kb + torch.arange(s.shape[-1])[None, :]
        vis = (qpos >= kpos) & ((qpos - kpos < window) if window else True)
        x = torch.where(vis, x, torch.full((), -1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        parts, rest = [], p
        for _ in range(p_parts):
            parts.append(rest.to(torch.bfloat16).float())
            rest = rest - parts[-1]
        o = o * alpha + sum(t @ vf[:, :, kb:kb + block_n] for t in parts)
        m = m_new
    return (o / l).to(torch.bfloat16)


def test_prefill_numerics_model_holds_the_bf16_tolerance():
    """At a small gemma2-like shape (head dim 256, GQA 2, softcap 50, a
    window) the kernel's numerics with P as bf16 hi + lo stay within the
    bf16 check (rtol 2^-7, atol 1e-5) of JAX's attention_ref; one bf16 P
    leaves an error many times larger, past that check."""
    q, k, v = _qkv(1, 4, 2, 128, 128, 256, seed=14)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kw = dict(window=48, softcap=50.0)
    want = torch.from_numpy(np.array(
        jattention_ref(qj, kj, vj, **kw).astype(jnp.float32)))
    qt, kt, vt = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qj, kj, vj))

    def ratio(p_parts):
        got = _prefill_model(qt, kt, vt, p_parts=p_parts, **kw).float()
        return float(((got - want).abs()
                      / (1e-5 + 2 ** -7 * want.abs())).max())

    hi_lo, single = ratio(2), ratio(1)
    assert hi_lo <= 1.0, hi_lo
    assert single > 1.0 and single > 4 * hi_lo, (single, hi_lo)

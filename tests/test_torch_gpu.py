"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions: bit for bit for the exact kernels, at tests/test_kernels.py's
tolerance for flash_attention (its f32 sums run in another order). Marked
``gpu``: they skip where there is no CUDA card, and run on one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs on a machine that has only the port.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import init_state
from repro_torch.core import windowed as wnd
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.stream import EVENT_ADD, interleaved_churn
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ops import _prepare_window
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("w,d,k", [(256, 192, 16), (256, 256, 16),
                                   (100, 37, 5), (1, 1, 1), (33, 1000, 7)])
def test_partition_affinity_kernel_matches_plain(cuda, w, d, k):
    g = torch.Generator(device=cuda).manual_seed(w + d + k)
    labels = torch.randint(-1, k, (w, d), generator=g, device=cuda,
                           dtype=torch.int32)
    before = partition_affinity.launches
    got = partition_affinity(labels, k_max=k)
    assert partition_affinity.launches == before + 1
    want = partition_affinity_ref(labels, k_max=k)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _window(cuda, k_max, window=64, warm=128):
    s = interleaved_churn(load_dataset("grqc", scale=0.05), warmup_frac=0.2,
                          del_every=3, edge_del_every=5, seed=0)
    cfg = EngineConfig(k_max=k_max, k_init=1, max_cap=60, autoscale=True)
    et = torch.from_numpy(s.etype).to(cuda)
    vx = torch.from_numpy(s.vertex).to(cuda)
    nb = torch.from_numpy(s.nbrs).to(cuda)
    st = init_state(s.n, s.max_deg, k_max, 1, seed=0, device=cuda)
    for t in range(0, warm, window):
        sl = slice(t, t + window)
        if np.all(s.etype[sl] == EVENT_ADD):
            st = wnd.run_window_adds(st, vx[sl], nb[sl], t, policy="sdp",
                                     cfg=cfg)
        else:
            st = wnd.run_window_mixed(st, et[sl], vx[sl], nb[sl], t,
                                      policy="sdp", cfg=cfg)
    sl = slice(warm, warm + window)
    n = st.assignment.shape[0]
    prep = _prepare_window(type(st)(*(x.clone() for x in st)), et[sl],
                           vx[sl], nb[sl])
    scalars = torch.stack([st.num_partitions, st.total_edges, st.cut_edges,
                           st.denied_scaleout, st.scale_events])
    knobs = torch.tensor(tx.knob_values(cfg, n), dtype=torch.float32,
                         device=cuda)
    return n, (prep.ev, prep.src_lbl, prep.touch,
               tx.rand_index_table(st.key, warm, window, k_max), st.active,
               st.edge_load, st.vertex_count, st.cut_matrix, scalars, knobs)


def bag_case(dev, v, d, b, l, dtype, seed, low=-1):
    """A (V, D) table in ``dtype`` and (B, L) int32 bags on ``dev``: ids in
    [low, V), about a quarter of the slots -1, bag 0 all padding — the
    cases the kernel must get right, built by hand because full-vocab
    ``make_batch`` ids are almost never -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((v, d), generator=g, device=dev).to(dtype)
    idx = torch.randint(low, v, (b, l), generator=g, device=dev,
                        dtype=torch.int32)
    pad = torch.rand((b, l), generator=g, device=dev) < 0.25
    idx = torch.where(pad, torch.full_like(idx, -1), idx)
    idx[0] = -1
    return table, idx


# tests/test_kernels.py's embedding_bag shapes (V, D, B, L), the serve
# shape (4096 bags of 8 slots at D = 256), and rows past 2^23 at D = 256,
# where idx * D passes 2^31
BAG_CASES = [(10, 8, 4, 1, -1), (50, 24, 12, 5, -1), (100, 130, 7, 9, -1),
             (30, 256, 3, 4, -1), (1 << 20, 256, 4096, 8, -1),
             ((1 << 23) + 4096, 256, 1024, 8, 1 << 23)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l,low", BAG_CASES)
def test_embedding_bag_kernel_matches_plain(cuda, v, d, b, l, low, dtype):
    table, idx = bag_case(cuda, v, d, b, l, dtype, seed=v + b, low=low)
    if low > 0:
        assert int(idx.max()) * d >= 2 ** 31
    for mode in ("sum", "mean"):
        before = embedding_bag.launches
        got = embedding_bag(table, idx, mode=mode)
        assert embedding_bag.launches == before + 1
        want = embedding_bag_ref(table, idx, mode=mode)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (b, d)
        assert torch.equal(got, want), mode
        assert not got[0].any()                 # the all-padding bag


@pytest.mark.parametrize("k_max", [6, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_fused_chooser_kernel_matches_plain(cuda, policy, k_max):
    n, args = _window(cuda, k_max)
    for guard in ("text", "alg1"):
        for auto in (True, False):
            kw = dict(n=n, policy=policy, balance_guard=guard,
                      autoscaling=auto)
            got = fk.fused_window_choose(*args, **kw)
            want = fused_window_choose_ref(*args, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (policy, guard, auto)


# flash_attention: tests/test_kernels.py's cases (B, H, Hkv, Sq, Sk, D) and
# the LM archs' head shapes (phi3 32/32 x 96, deepseek 56/8 x 128, gemma2
# 16/8 x 256)
ATTN_CASES = [(1, 1, 1, 16, 16, 8), (2, 4, 2, 64, 64, 16),
              (2, 4, 1, 33, 65, 32), (1, 8, 8, 128, 128, 64),
              (1, 32, 32, 70, 70, 96), (1, 56, 8, 40, 40, 128),
              (2, 16, 8, 100, 100, 256)]
ATTN_KW = [dict(), dict(window=16), dict(softcap=30.0), dict(causal=False),
           dict(window=16, softcap=50.0)]


def _qkv(cuda, b, h, hkv, sq, sk, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("kw", ATTN_KW, ids=str)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(cuda, case, kw):
    q, k, v = _qkv(cuda, *case, torch.float32, seed=sum(case))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 50.0)])
def test_flash_attention_kernel_decode_and_views(cuda, window, softcap):
    """A decode query against a cache slice seen through (B, S, H, D) ->
    (B, H, S, D) views, as the model launches it, in f32 and bf16 (bf16
    out: the two round one f32 result, so one bf16 ulp apart at most)."""
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -7)):
        g = torch.Generator(device=cuda).manual_seed(5)
        cache = torch.randn((3, 4, 130, 8, 64), generator=g, device=cuda) \
            .to(dtype)
        q = torch.randn((4, 1, 16, 64), generator=g, device=cuda).to(dtype)
        kv = cache[1].transpose(1, 2)                 # (B, Hkv, S, D) view
        kw = dict(q_offset=97, window=window, softcap=softcap)
        got = flash_attention(q.transpose(1, 2), kv, kv, **kw)
        want = attention_ref(q.transpose(1, 2), kv.contiguous(),
                             kv.contiguous(), **kw)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dmax,f", [(8, 1, 8), (20, 6, 40), (33, 9, 130),
                                      (5, 3, 256), (64, 100, 33),
                                      (300, 192, 128)])
def test_segment_spmm_kernel_matches_plain(cuda, n, dmax, f, dtype):
    g = torch.Generator(device=cuda).manual_seed(n + dmax)
    x = torch.randn((n, f), generator=g, device=cuda).to(dtype)
    adj = torch.randint(-1, n, (n, dmax), generator=g, device=cuda,
                        dtype=torch.int32)
    adj[0] = -1
    for mode in ("sum", "mean"):
        before = segment_spmm.launches
        got = segment_spmm(x, adj, mode=mode)
        assert segment_spmm.launches == before + 1
        want = segment_spmm_ref(x, adj, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
        assert not got[0].any()


def test_lm_layers_launch_the_attention_kernel(cuda):
    """gemma2's smoke config on the card: every layer of a forward and of a
    decode step launches flash_attention once, and the logits agree with
    the plain attention's."""
    cfg = get_arch("gemma2-9b").smoke_config
    params = T.init_params(cfg, generator=torch.Generator(device=cuda)
                           .manual_seed(0), device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 12), device=cuda)
    before = flash_attention.launches
    logits, ck, cv = T.prefill_step(params, toks, cfg)
    assert flash_attention.launches == before + cfg.n_layers
    want, _, _ = T.prefill_step(params, toks, cfg, use_kernel=False)
    torch.testing.assert_close(logits, want, rtol=2e-4, atol=2e-4)
    pad = (0, 0, 0, 0, 0, 4)
    ck, cv = (torch.nn.functional.pad(c, pad) for c in (ck, cv))
    nxt = torch.randint(0, cfg.vocab, (2, 1), device=cuda)
    before = flash_attention.launches
    got, _, _ = T.decode_step_inplace(params, nxt, ck.clone(), cv.clone(), 12,
                                      cfg)
    assert flash_attention.launches == before + cfg.n_layers
    want, _, _ = T.decode_step_inplace(params, nxt, ck, cv, 12, cfg,
                                       use_kernel=False)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)

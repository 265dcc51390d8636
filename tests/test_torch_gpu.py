"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions: bit for bit for the exact kernels, at tests/test_kernels.py's
tolerance for flash_attention's f32 kernel (its f32 sums run in another
order) and at one bf16 ulp for its bf16 prefill and split kernels. Marked
``gpu``: they skip where there is no CUDA card, and run on one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs on a machine that has only the port.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import transition as tx
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import init_state
from repro_torch.core import windowed as wnd
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.stream import EVENT_ADD, interleaved_churn
from repro_torch.api import Partitioner
from repro_torch.kernels import common
from repro_torch.kernels.embedding_bag.embedding_bag import (
    backward_launch, backward_order, embedding_bag, embedding_bag_backward,
    load_width,
)
from repro_torch.kernels.embedding_bag.ops import bag_lookup
from repro_torch.kernels.embedding_bag.ref import (
    backward_order_ref, embedding_bag_backward_ref, embedding_bag_ref,
)
from repro_torch.data import pipeline as dp
from repro_torch.launch import steps as train_steps
from repro_torch.launch import train
from repro_torch.models import recsys as RS
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ops import _prepare_window
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
from repro_torch.kernels.partition_affinity import partition_affinity as pa
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, attention_split_ref,
)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.core.rng import prng_key
from repro_torch.graph.csr import cap_degree
from repro_torch.graph.stream import VertexStream
from repro_torch.kernels.fused_chooser import ops as fops
from repro_torch.kernels.fused_chooser import sweep as fsweep
from repro_torch.kernels.fused_chooser.sweep import WINDOW_SETUPS
from repro_torch.kernels.fused_chooser.ref import prepare_window_ref
from repro_torch.kernels.fused_chooser.window_prep import (
    prep_max_w, window_prep, window_prep_rows,
)
from repro_torch.kernels.fused_chooser.ref import prepare_rows_ref
from repro_torch.core.sharded_state import shard_state, unshard_state
from repro_torch.launch.mesh import make_vertices_mesh
from repro_torch.kernels.partition_affinity.ops import scores_for_state
from repro_torch.kernels.window_rng.ops import window_rng
from repro_torch.kernels.window_rng.ref import window_rng_ref
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90): the kernels run only there")
    return torch.device("cuda", 0)


def _assert_affinity_matches(labels, k):
    before = partition_affinity.launches
    got = partition_affinity(labels, k_max=k)
    assert partition_affinity.launches == before + 1
    want = partition_affinity_ref(labels, k_max=k)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("w,d,k", [(256, 192, 16), (256, 256, 16),
                                   (100, 37, 5), (1, 1, 1), (33, 1000, 7)])
def test_partition_affinity_kernel_matches_plain(cuda, w, d, k):
    g = torch.Generator(device=cuda).manual_seed(w + d + k)
    labels = torch.randint(-1, k, (w, d), generator=g, device=cuda,
                           dtype=torch.int32)
    _assert_affinity_matches(labels, k)


# rows of one label, of 37 (4-byte loads), of the session's 192 (16-byte
# loads) and of grqc's 2,843 (several load rounds); K in registers (1, 16;
# 32, the last), and in a shared histogram (200, 2,000: fewer rows a
# block); labels up to K + 2, which count in no bin
@pytest.mark.parametrize("k", [1, 16, 32, 200, 2000])
@pytest.mark.parametrize("d", [1, 37, 192, 2843])
def test_partition_affinity_kernel_any_width_and_k(cuda, d, k):
    g = torch.Generator(device=cuda).manual_seed(d * 7 + k)
    labels = torch.randint(-1, k + 2, (70, d), generator=g, device=cuda,
                           dtype=torch.int32)
    _assert_affinity_matches(labels, k)
    # the same rows seen from an int32 past a 16-byte boundary
    flat = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=cuda),
                      labels.reshape(-1)])
    view = flat[1:].view(70, d)
    assert view.data_ptr() % 16 == 4
    _assert_affinity_matches(view, k)


def test_partition_affinity_refuses_only_above_its_limit(cuda):
    pa._lib()                                    # binds the library's entries
    lib = common.load_kernel("partition_affinity")
    assert lib.partition_affinity_max_k() == pa.MAX_K >= 4096
    labels = torch.randint(-1, 4, (3, 5), device=cuda, dtype=torch.int32)
    _assert_affinity_matches(labels, pa.MAX_K)
    with pytest.raises(ValueError, match="58112"):
        partition_affinity(labels, k_max=pa.MAX_K + 1)


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


# (dtype, D, base offset in elements, load width): every width the wrapper
# picks, from the row width (D * element size) and the table's base
# alignment — 16-byte rows seen from a base 4 or 8 bytes past a 16-byte
# boundary, and bf16 rows 2 bytes past one
BAG_WIDTHS = [(torch.float32, 256, 0, 16), (torch.float32, 6, 0, 8),
              (torch.float32, 5, 0, 4), (torch.float32, 256, 1, 4),
              (torch.float32, 256, 2, 8), (torch.bfloat16, 256, 0, 16),
              (torch.bfloat16, 12, 0, 8), (torch.bfloat16, 6, 0, 4),
              (torch.bfloat16, 5, 0, 2), (torch.bfloat16, 256, 1, 2),
              (torch.bfloat16, 256, 2, 4), (torch.bfloat16, 256, 4, 8)]


@pytest.mark.parametrize("l", [1, 8, 37, 2000])
@pytest.mark.parametrize("dtype,d,off,width", BAG_WIDTHS, ids=str)
def test_embedding_bag_kernel_load_widths(cuda, dtype, d, off, width, l):
    """Each load width on a table view at that alignment, bags of 1, 8, 37
    (past one 32-slot id load) and 2,000 slots (past the earlier kernel's
    1,536), a quarter of the slots -1 and bag 0 all padding; the launch
    counted under its width."""
    v, b = 300, 45
    g = torch.Generator(device=cuda).manual_seed(d + off + l)
    flat = torch.randn((v * d + off,), generator=g, device=cuda).to(dtype)
    table = flat[off:].view(v, d)
    assert table.data_ptr() % 16 == (off * table.element_size()) % 16
    assert load_width(d, table.element_size(), table.data_ptr()) == width
    idx = torch.randint(0, v, (b, l), generator=g, device=cuda,
                        dtype=torch.int32)
    pad = torch.rand((b, l), generator=g, device=cuda) < 0.25
    idx = torch.where(pad, torch.full_like(idx, -1), idx)
    idx[0] = -1
    for mode in ("sum", "mean"):
        before = embedding_bag.launches
        by = dict(embedding_bag.kernel_launches)
        got = embedding_bag(table, idx, mode=mode)
        assert embedding_bag.launches == before + 1
        assert embedding_bag.kernel_launches == {
            k: n + (k == f"load{width}") for k, n in by.items()}
        want = embedding_bag_ref(table, idx, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
        assert not got[0].any()


def test_embedding_bag_kernel_all_padding(cuda):
    table = torch.randn((20, 256), device=cuda).to(torch.bfloat16)
    idx = torch.full((70, 9), -1, dtype=torch.int32, device=cuda)
    for mode in ("sum", "mean"):
        got = embedding_bag(table, idx, mode=mode)
        assert torch.equal(got, torch.zeros((70, 256), device=cuda))


# the backward: (V, D, B, L, kind) — the two-tower training shape's user
# bags (131,072 bags of 8 at D = 256 over 2^22 rows), rows past 2^23 at
# D = 256, V = 1, ragged widths, long bags, heavy padding and hot rows
# (long runs of one row)
BWD_CASES = [((1 << 22), 256, 131_072, 8, "random"),
             ((1 << 23) + 4096, 256, 1024, 8, "random"),
             (1, 16, 40, 3, "random"), (7, 130, 300, 37, "random"),
             (300, 5, 45, 2000, "padded"), (50, 256, 4096, 8, "hot"),
             (1000, 24, 512, 9, "dup")]


def bwd_case(dev, v, d, b, l, kind, seed):
    """(idx, g) on the card: ids in [-1, V) (``padded``: half the bags all
    -1; ``hot``: ids from 3 rows; ``dup``: one id a bag), a bag gradient
    spread over e^±9 with -0.0 entries."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(-1, v, (b, l), generator=gen, device=dev,
                        dtype=torch.int32)
    if kind == "padded":
        idx[::2] = -1
    elif kind == "hot":
        idx = torch.randint(0, min(v, 3), (b, l), generator=gen, device=dev,
                            dtype=torch.int32)
    elif kind == "dup":
        idx[:] = idx[:, :1].clamp(min=0)
    idx[0, 0] = -1
    g = torch.randn((b, d), generator=gen, device=dev) * torch.exp(
        torch.rand((b, 1), generator=gen, device=dev) * 18 - 9)
    g[torch.rand((b, d), generator=gen, device=dev) < 0.05] = -0.0
    return idx, g


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l,kind", BWD_CASES)
def test_embedding_bag_backward_kernel_matches_plain_on_host(cuda, v, d, b, l,
                                                            kind, mode):
    """The kernel's dense table gradient equals the plain backward run on
    host copies of the same inputs bit for bit (-0.0 and +0.0 told apart),
    and a second launch equals the first."""
    idx, g = bwd_case(cuda, v, d, b, l, kind, seed=v + b + l)
    before = embedding_bag_backward.launches
    got = embedding_bag_backward(g, idx, v, mode=mode)
    again = embedding_bag_backward(g, idx, v, mode=mode)
    assert embedding_bag_backward.launches == before + 2
    want = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, mode=mode)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (v, d)
    assert _same_bits(got.cpu(), want), mode
    assert _same_bits(again, got)


def test_embedding_bag_backward_all_padding_and_limits(cuda):
    idx = torch.full((70, 9), -1, dtype=torch.int32, device=cuda)
    g = torch.randn((70, 256), device=cuda)
    for mode in ("sum", "mean"):
        got = embedding_bag_backward(g, idx, 20, mode=mode)
        assert _same_bits(got, torch.zeros((20, 256), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        embedding_bag_backward(g.half(), idx, 20)
    with pytest.raises(ValueError, match="num_rows"):
        embedding_bag_backward(g, idx, 0)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_lookup_autograd_on_card(cuda, mode):
    """bag_lookup's forward and backward through the two kernels: the
    table gradient equals the plain backward of the same cotangent on the
    host, bit for bit."""
    v, d, b, l = 5000, 256, 2048, 8
    table = torch.randn((v, d), device=cuda).requires_grad_(True)
    idx, g = bwd_case(cuda, v, d, b, l, "random", seed=3)
    fwd, bwd = embedding_bag.launches, embedding_bag_backward.launches
    out = bag_lookup(table, idx, mode)
    (grad,) = torch.autograd.grad(out, table, g)
    assert embedding_bag.launches == fwd + 1
    assert embedding_bag_backward.launches == bwd + 1
    assert torch.equal(out, embedding_bag_ref(table.detach(), idx, mode=mode))
    want = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, mode=mode)
    assert _same_bits(grad.cpu(), want)


def test_two_tower_training_on_card(cuda, tmp_path):
    """The train step at the smoke config on the card, through both bag
    kernels, against the same steps on the CPU (the towers' products and
    sums run other kernels there: tests/test_recsys.py's tolerance), and
    the trainer CLI on the card with a resume."""
    cfg = get_arch("two-tower-retrieval").smoke_config
    host = RS.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    out = {}
    for name, params, dev in (("cpu", host, "cpu"), ("cuda", card, cuda)):
        step, opt = train_steps._train_step_fn(RS.loss_fn, cfg)
        state = opt.init(params)
        losses = []
        for t in range(4):
            batch = train.batch_tensors(RS.make_batch(cfg, 16, seed=t), dev)
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        out[name] = (params, losses)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    for x, y in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-5)
    before = embedding_bag_backward.launches
    args = ["--arch", "two-tower-retrieval", "--steps", "4", "--batch", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"]
    assert train.main(args) == 0
    assert embedding_bag_backward.launches == before + 8
    assert train.main(args[:3] + ["8"] + args[4:]) == 0
    assert embedding_bag_backward.launches == before + 16


def _assert_fused_matches(n, args, policy):
    for guard in ("text", "alg1"):
        for auto in (True, False):
            kw = dict(n=n, policy=policy, balance_guard=guard,
                      autoscaling=auto)
            before = fk.fused_window_choose.launches
            kernel = fk.dispatch(args[1].shape[0], args[3].shape[1])
            by = dict(fk.fused_window_choose.kernel_launches)
            got = fk.fused_window_choose(*args, **kw)
            assert fk.fused_window_choose.launches == before + 1
            assert fk.fused_window_choose.kernel_launches == {
                k: c + (k == kernel) for k, c in by.items()}
            want = fused_window_choose_ref(*args, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (policy, guard, auto)


# k_max 40: partitions past the 32 lanes of the kernel's warp; 192, the
# lanes kernel's last; 193 and up, the large kernel
@pytest.mark.parametrize("k_max", [6, 1, 40, 192, 193, 200, 1000])
@pytest.mark.parametrize("policy", POLICIES)
def test_fused_chooser_kernel_matches_plain(cuda, policy, k_max):
    n, args = _window(cuda, k_max)
    _assert_fused_matches(n, args, policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_chooser_kernel_matches_plain_wide_rows(cuda, policy):
    """Rows of 8,001 columns: the window's own entries padded with -1 and
    scattered over each row by a random column permutation (the same for
    src_lbl and touch). The producer warps read a row in 42 batches of 192
    columns, only the first before they wait for the decider; the
    permutation puts labels, and entries that the slot before touched, in
    the batches read after that wait. 8,001 is odd, so the rows are not
    16-byte aligned either."""
    n, args = _window(cuda, 6)
    ev, src_lbl, touch, *rest = args
    w, d = src_lbl.shape
    pad = torch.full((w, 8001 - d), -1, dtype=torch.int32, device=cuda)
    g = torch.Generator().manual_seed(0)
    perm = torch.argsort(torch.rand((w, 8001), generator=g), dim=1).to(cuda)
    wide = tuple(torch.cat([t, pad], 1).gather(1, perm).contiguous()
                 for t in (src_lbl, touch))
    prev = torch.arange(-1, w - 1, device=cuda)[:, None]
    assert bool((wide[0][:, 192:] >= 0).any())
    assert bool(((wide[1][:, 192:] == prev) & (prev >= 0)).any())
    _assert_fused_matches(n, (ev, *wide, *rest), policy)


@pytest.mark.parametrize("k_max", [6, 300])
@pytest.mark.parametrize("policy", ["sdp", "greedy"])
def test_fused_chooser_kernel_matches_plain_large_loads(cuda, policy, k_max):
    """Edge loads past 2^24: the f32 sum of loads is no longer the integer
    sum, and the kernel adds the terms left to right as the plain version
    does (at K = 300, 300 loads of 2^25 would also wrap a 32-bit sum)."""
    n, args = _window(cuda, k_max)
    args = list(args)
    args[5] = args[5] + (1 << 25) + torch.arange(
        k_max, dtype=torch.int32, device=cuda) * 7
    _assert_fused_matches(n, tuple(args), policy)


@pytest.mark.parametrize("k_max", [1, 16, 40, 192])
@pytest.mark.parametrize("policy", POLICIES)
def test_fused_chooser_large_kernel_matches_lanes(cuda, policy, k_max):
    """The large kernel, which takes any K, launched (uncounted) at K the
    wrapper sends to the lanes kernel: bit-equal to the lanes kernel."""
    n, args = _window(cuda, k_max)
    counts = (fk.fused_window_choose.launches,
              dict(fk.fused_window_choose.kernel_launches))
    for guard in ("text", "alg1"):
        for auto in (True, False):
            kw = dict(policy=policy, balance_guard=guard, autoscaling=auto)
            for x, y in zip(fk.launch("large", *args, **kw),
                            fk.launch("lanes", *args, **kw)):
                assert torch.equal(x, y), (guard, auto)
    assert counts == (fk.fused_window_choose.launches,
                      fk.fused_window_choose.kernel_launches)


def test_fused_chooser_limits_match_the_build(cuda):
    lib = fk._lib()
    assert lib.fused_chooser_max_k() == fk.LANES_MAX_K
    for w in (1, 64, 256, 4096):
        assert lib.fused_chooser_large_max_k(w) == fk.large_max_k(w)
    assert fk.large_max_k(256) >= 4096


def test_partitioner_session_k200_matches_plain(cuda):
    """A card session with use_kernel=True at k_max = 200 (the large
    fused_chooser kernel and partition_affinity's shared histogram) leaf
    for leaf equal to the plain windowed session on the card."""
    s = interleaved_churn(load_dataset("grqc", scale=0.2), warmup_frac=0.2,
                          del_every=3, edge_del_every=5, seed=0)
    cfg = EngineConfig(k_max=200, k_init=1, max_cap=40, autoscale=True)
    before = dict(fk.fused_window_choose.kernel_launches)
    aff = partition_affinity.launches
    parts = [Partitioner.from_stream(s, cfg, policy="sdp", seed=0, window=64,
                                     use_kernel=k, device=cuda).feed(s)
             for k in (True, False)]
    assert fk.fused_window_choose.kernel_launches["large"] > before["large"]
    assert fk.fused_window_choose.kernel_launches["lanes"] == before["lanes"]
    assert partition_affinity.launches > aff
    for f in parts[0].state._fields:
        assert torch.equal(getattr(parts[0].state, f),
                           getattr(parts[1].state, f)), f


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


# bf16: kernel and plain version round one f32 result computed in another
# order, so they may land one bf16 ulp (<= 2^-7 relative) apart
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
BF16_KW = [dict(window=24), dict(softcap=50.0), dict(window=24, softcap=50.0),
           dict(causal=False)]


def _counted(kernel, fn):
    """Run ``fn`` and check it made one launch, of ``kernel``."""
    before = flash_attention.launches
    by = dict(flash_attention.kernel_launches)
    out = fn()
    assert flash_attention.launches == before + 1
    assert flash_attention.kernel_launches[kernel] == by[kernel] + 1
    assert sum(flash_attention.kernel_launches.values()) == sum(by.values()) + 1
    return out


@pytest.mark.parametrize("kw", BF16_KW, ids=str)
@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_attention_bf16_prefill_kernel(cuda, d, group, kw):
    """The tensor-core kernel at every head dim of the port's configs, GQA
    groups of 1, 2 and 7 (deepseek's, not a power of two), and a query
    length that is no multiple of the 64-row tile (Sk longer than Sq, so
    the queries sit at an offset)."""
    hkv, sq, sk = 2, 100, 131
    q, k, v = _qkv(cuda, 2, hkv * group, hkv, sq, sk, d, torch.bfloat16,
                   seed=d + group)
    kw = dict(kw, q_offset=sk - sq)
    assert fa.dispatch(q, k, causal=kw.get("causal", True),
                       window=kw.get("window", 0),
                       q_offset=kw["q_offset"])["kernel"] == "prefill"
    got = _counted("prefill", lambda: flash_attention(q, k, v, **kw))
    want = attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("case", [
    # (B, H, Hkv, Sq, S, q_offset, window, softcap, MIN_CHUNK or None)
    (4, 16, 8, 1, 1000, 998, 0, 50.0, None),     # 999 keys, no multiple
    (4, 16, 8, 1, 1000, 999, 0, 0.0, None),      # q_offset = Sk - 1
    (2, 16, 8, 1, 3000, 2500, 700, 50.0, None),  # window: keys 1801 .. 2500
    (2, 4, 2, 4, 1000, 990, 3, 50.0, 2),         # 8 rows, windows shorter
                                                 # than the union: splits
                                                 # empty for some rows
    (1, 7, 1, 1, 2000, 1200, 0, 0.0, None),      # G = 7
    (2, 8, 2, 2, 2000, 1500, 0, 50.0, None)],    # G = 4, two positions
    ids=str)
def test_flash_attention_split_kernel(cuda, monkeypatch, case, d):
    """The decode kernel on the cache seen through (B, S, H, D) views, as
    the model launches it, against the plain version and its own split
    math."""
    b, h, hkv, sq, s, off, window, softcap, min_chunk = case
    if min_chunk is not None:     # more, shorter splits than the card wants
        monkeypatch.setattr(fa_ref, "MIN_CHUNK", min_chunk)
    g = torch.Generator(device=cuda).manual_seed(s + d)
    cache = torch.randn((2, b, s, hkv, d), generator=g, device=cuda) \
        .to(torch.bfloat16)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda) \
        .to(torch.bfloat16).transpose(1, 2)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    kw = dict(q_offset=off, window=window, softcap=softcap)
    how = fa.dispatch(q, k, window=window, q_offset=off)
    lo, hi, chunk, n_split = how["plan"]
    assert how["kernel"] == "split" and n_split > 1
    assert lo + chunk * (n_split - 1) < hi <= lo + chunk * n_split
    if min_chunk is not None:     # the first position sees none of the last
        assert off < lo + chunk * (n_split - 1)
    got = _counted("split", lambda: flash_attention(q, k, v, **kw))
    want = attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    split = attention_split_ref(q, k, v, n_split, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got.float(), split.float(), **BF16_TOL)


@pytest.mark.parametrize("case", [
    # (B, H, Hkv, S, q_offset, window, softcap): a key block of the
    # sequence-sharded decode, the row at its end, inside it, windowed
    (1, 16, 8, 2048, 2047, 0, 50.0), (1, 16, 8, 2048, 700, 0, 50.0),
    (1, 16, 8, 2048, 1900, 1024, 50.0), (4, 16, 16, 512, 300, 0, 0.0),
    (2, 7, 1, 1000, 999, 0, 0.0),
    # llama4-scout's decode_32k block on a (4, 16) mesh, cut to 1,024 keys:
    # 32 sequences x 8 KV heads, more CTAs than the card has SMs
    (32, 40, 8, 1024, 1023, 0, 0.0), (32, 40, 8, 1024, 600, 256, 0.0)],
    ids=str)
def test_flash_attention_lse_from_the_split_kernel(cuda, case):
    """``lse=True``: the split kernel's output and each row's log-sum-exp
    (read from its (m, l) partials) against ``attention_lse_ref``."""
    b, h, hkv, s, off, window, softcap = case
    q, k, v = _qkv(cuda, b, h, hkv, 1, s, 128, torch.bfloat16, seed=s + h)
    kw = dict(q_offset=off, window=window, softcap=softcap)
    out, lse = _counted("split", lambda: flash_attention(q, k, v, lse=True,
                                                         **kw))
    want, want_lse = fa_ref.attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, 1) and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


def test_flash_attention_lse_needs_the_split_kernel(cuda):
    for dtype, sq in ((torch.bfloat16, 64), (torch.float32, 1)):
        q, k, v = _qkv(cuda, 1, 4, 2, sq, 64, 64, dtype, seed=sq)
        with pytest.raises(ValueError, match="split kernel's partials"):
            flash_attention(q, k, v, lse=True)


def test_sharded_lm_bundles_on_card(cuda):
    """gemma2's smoke config in bf16, 2 layers, as step bundles on a (data
    2, model 2) mesh of four cuda:0 entries: a train step, a prefill, a
    4-slot decode and a 1-slot decode whose cache is split over every axis
    (its key blocks merged through ``flash_attention(lse=True)``), each
    against the one-card step on the card and each attention call on the
    kernel. bf16 partial products summed in another order: the loss within
    2^-8, mu, logits and caches within 2^-4 relative L2 (phase lm's)."""
    import dataclasses
    from repro_torch.configs.base import ArchDef
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.mesh import gather, make_mesh, place_tree

    cfg = dataclasses.replace(get_arch("gemma2-9b").smoke_config, n_layers=2,
                              dtype="bfloat16")
    arch = ArchDef("gemma2-9b", "lm", cfg, cfg, "smoke")
    mesh = make_mesh((2, 2), ("data", "model"), devices=[cuda] * 4)
    params = T.init_params(cfg, generator=torch.Generator(device=cuda)
                           .manual_seed(0), device=cuda)

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / torch.linalg.vector_norm(b.double()))

    b = train_steps.build_lm(arch, LMShape("t", "train", 32, 2), mesh)
    batch = train.batch_tensors(dp.lm_batch(cfg.vocab, 2, 32, seed=0, step=0),
                                cuda)
    opt = train_steps.make_opt()
    before = flash_attention.launches
    _, o_sh, m = b.fn(*place_tree((params, opt.init(params), batch),
                                  b.in_shardings))
    assert flash_attention.launches == before + 2 * 4 * cfg.n_layers
    _, state, want = train_steps.train_step(T.loss_fn, cfg, opt)(
        params, opt.init(params), batch)
    assert abs(float(gather(m["loss"])) - float(want["loss"])) \
        <= 2 ** -8 * abs(float(want["loss"]))
    for got, ref in zip(tree_leaves(o_sh["mu"]), tree_leaves(state["mu"])):
        assert rel(gather(got), ref) <= 2 ** -4
    b = train_steps.build_lm(arch, LMShape("p", "prefill", 32, 2), mesh)
    got = b.fn(*place_tree((params, batch["tokens"]), b.in_shardings))
    want = T.prefill_step(params, batch["tokens"], cfg)
    for x, y in zip(got, want):
        assert rel(gather(x), y) <= 2 ** -4
    for slots in (4, 1):
        b = train_steps.build_lm(arch, LMShape("d", "decode", 64, slots), mesh)
        g = torch.Generator(device=cuda).manual_seed(slots)
        shape = (cfg.n_layers, slots, 64, cfg.n_kv_heads, cfg.head_dim)
        ck, cv = (torch.randn(shape, generator=g, device=cuda).bfloat16()
                  for _ in range(2))
        tok = torch.randint(0, cfg.vocab, (slots, 1), generator=g,
                            device=cuda, dtype=torch.int32)
        before = flash_attention.launches
        lg, k2, _ = b.fn(*place_tree((params, tok, ck, cv, torch.tensor(
            50, dtype=torch.int32)), b.in_shardings))
        assert flash_attention.launches > before
        want, wk, _ = T.decode_step_inplace(params, tok, ck, cv, 50, cfg)
        assert rel(gather(lg), want) <= 2 ** -4
        assert rel(gather(k2)[:, :, 50], wk[:, :, 50]) <= 2 ** -4


def test_flash_attention_bf16_head_dim_raises(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 40, 40, 72, torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)


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


def _scattered_adj(g, n, dmax, m, dev, density=0.2):
    """(n, dmax) ids in [0, m) at scattered slots, -1 elsewhere; row 0 all
    padding."""
    adj = torch.randint(0, m, (n, dmax), generator=g, device=dev,
                        dtype=torch.int32)
    keep = torch.rand((n, dmax), generator=g, device=dev) < density
    adj = torch.where(keep, adj, torch.full_like(adj, -1))
    adj[0] = -1
    return adj


# (n, dmax, f): every F residue mod 4 (f32) and mod 8 (bf16), F = 1433 at a
# small N, F spanning several column slabs (128 f32 or 256 bf16 columns),
# rows whose valid slots lie past slot 32 among -1s, N off a multiple of a
# CTA's rows
SPMM_LAYOUTS = [(9, 40, f) for f in range(1, 9)] + [
    (33, 70, 1433), (17, 100, 300), (21, 45, 600), (130, 192, 129),
    (5, 2843, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dmax,f", SPMM_LAYOUTS)
def test_segment_spmm_kernel_layouts(cuda, n, dmax, f, dtype):
    g = torch.Generator(device=cuda).manual_seed(n * 7 + f)
    x = torch.randn((n + 3, f), generator=g, device=cuda).to(dtype)
    adj = _scattered_adj(g, n, dmax, n + 3, cuda)
    assert bool((adj[:, 33:] >= 0).any()) or dmax <= 33
    for mode in ("sum", "mean"):
        got = segment_spmm(x, adj, mode=mode)
        want = segment_spmm_ref(x, adj, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
        assert not got[0].any()


# (dtype, F, kernels a call launches): one slab (the gather alone) or
# several (the compaction, then the gather)
@pytest.mark.parametrize("dtype,f,kernels", [
    (torch.float32, 128, ("gather",)), (torch.bfloat16, 256, ("gather",)),
    (torch.float32, 129, ("compact", "gather")),
    (torch.bfloat16, 1433, ("compact", "gather"))])
def test_segment_spmm_counts_each_kernel(cuda, dtype, f, kernels):
    g = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn((40, f), generator=g, device=cuda).to(dtype)
    adj = _scattered_adj(g, 33, 50, 40, cuda)
    before, by = segment_spmm.launches, dict(segment_spmm.kernel_launches)
    got = segment_spmm(x, adj)
    assert segment_spmm.launches == before + 1
    assert segment_spmm.kernel_launches == {
        k: n + (k in kernels) for k, n in by.items()}
    assert torch.equal(got, segment_spmm_ref(x, adj))


def test_segment_spmm_kernel_rows_past_2_31(cuda):
    """bf16 x whose row * F passes 2^31 elements: 64-bit row offsets."""
    f, m = 256, (1 << 23) + 64
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((m, f), generator=g, device=cuda).to(torch.bfloat16)
    adj = _scattered_adj(g, 40, 24, 64, cuda, density=0.5)
    adj = torch.where(adj >= 0, adj + (1 << 23), adj)
    assert int(adj.max()) * f >= 2 ** 31
    for mode in ("sum", "mean"):
        got = segment_spmm(x, adj, mode=mode)
        want = segment_spmm_ref(x, adj, mode=mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want), mode
    del x


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


@pytest.mark.parametrize("arch_id", ["moonshot-v1-16b-a3b",
                                     "llama4-scout-17b-a16e"])
def test_moe_lm_prefill_and_decode_on_card(cuda, arch_id):
    """The MoE smoke configs (f32) on the card — every layer's attention on
    flash_attention, the router and dispatch as plain ops — against the
    same prefill and in-place decode on host copies of the params, cache
    and tokens (the CPU runs the plain attention): tests/test_models_lm.py's
    2e-4, and the same expert choices in every layer."""
    cfg = get_arch(arch_id).smoke_config
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    before = flash_attention.launches
    logits, ck, cv = T.prefill_step(card, toks.to(cuda), cfg)
    assert flash_attention.launches == before + cfg.n_layers
    want, hk, hv = T.prefill_step(host, toks, cfg)
    for got, ref in ((logits, want), (ck, hk), (cv, hv)):
        torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=2e-4)
    pad = (0, 0, 0, 0, 0, 4)
    ck, cv, hk, hv = (torch.nn.functional.pad(c, pad) for c in (ck, cv, hk, hv))
    for pos in (12, 13):
        nxt = torch.randint(0, cfg.vocab, (2, 1),
                            generator=torch.Generator().manual_seed(pos))
        before = flash_attention.launches
        got, _, _ = T.decode_step_inplace(card, nxt.to(cuda), ck, cv, pos, cfg)
        assert flash_attention.launches == before + cfg.n_layers
        want, _, _ = T.decode_step_inplace(host, nxt, hk, hv, pos, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(ck.cpu(), hk, rtol=2e-4, atol=2e-4)


def test_moe_lm_train_step_on_card(cuda):
    """One AdamW step of moonshot's smoke config on the card (attention
    forward on the kernel, its backward through the plain version) against
    the same step on the CPU: loss, xent, aux and every param after the
    step at tests/test_recsys.py's tolerance."""
    cfg = get_arch("moonshot-v1-16b-a3b").smoke_config
    host = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    batch = dp.lm_batch(cfg.vocab, 2, 16, seed=0, step=0)
    out = {}
    for name, params, dev in (("cpu", host, "cpu"), ("cuda", card, cuda)):
        step, opt = train_steps._train_step_fn(T.loss_fn, cfg)
        before = flash_attention.launches
        params, _, m = step(params, opt.init(params),
                            train.batch_tensors(batch, dev))
        launched = flash_attention.launches - before
        out[name] = (params, {k: float(v) for k, v in m.items()}, launched)
    assert out["cuda"][2] == cfg.n_layers          # forward only
    for k in ("loss", "xent", "aux", "gnorm"):
        np.testing.assert_allclose(out["cuda"][1][k], out["cpu"][1][k],
                                   rtol=1e-4, err_msg=k)
    for x, y in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the window loops: window_rng, window_prep, the pure-ADD fixup
# ---------------------------------------------------------------------------

# the session's first window, its 450th (t0 = 114,958 - 94), the uint32
# wrap of the event index, and K from 1 to 1,000
@pytest.mark.parametrize("k", [1, 16, 1000])
@pytest.mark.parametrize("t0", [0, 114_958, 2**32 - 100])
def test_window_rng_kernel_matches_plain(cuda, t0, k):
    for seed in (0, 2**40 + 5):
        key = prng_key(seed, device=cuda)
        for w in (1, 256):
            before = window_rng.launches
            got = window_rng(key, t0, w, k)
            assert window_rng.launches == before + 1
            assert torch.equal(got, window_rng_ref(key, t0, w, k))


_STATES = {}


def _setup(cuda, name, warm=None):
    """(state, cfg, (etype, vertex, rows)) after ``warm`` events (the
    setup's own by default) of the setup's churn stream on the card."""
    spec = WINDOW_SETUPS[name]
    spec = spec[:7] + (spec[7] if warm is None else warm,)
    if spec not in _STATES:
        _STATES[spec] = fsweep.window_state(cuda, *spec, fsweep.CHURN)
    return _STATES[spec]


def _assert_prep_matches(state, ets, vs, rows):
    got_state, want_state = (fsweep.clone_state(state) for _ in range(2))
    before = window_prep.launches
    got = window_prep(got_state, ets, vs, rows)
    assert window_prep.launches == before + 1
    want = prepare_window_ref(want_state, ets, vs, rows)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got_state.adj, want_state.adj)
    assert torch.equal(got_state.present, state.present)   # never written


@pytest.mark.parametrize("window", ["stream", 0, 1, 2, 3, 4, 5,
                                    "chain0", "chain1", "chain2"])
@pytest.mark.parametrize("setup", ["session", "grqc_wide", "odd", "k1",
                                   "k40", "k200", "k1000"])
def test_window_prep_kernel_matches_plain(cuda, setup, window):
    """The stream's own mixed window, crafted ones (pads, self-loops, an
    edge deleted from both endpoints, a vertex added twice, a deleted
    vertex added again: ``sweep.crafted_window``) and windows over four hot
    vertices, whose rows carry long chains of slots
    (``sweep.chain_window``)."""
    state, _, (et, vx, nb) = _setup(cuda, setup)
    w, warm = WINDOW_SETUPS[setup][6:]
    if window == "stream":
        sl = slice(warm, warm + w)
        ets, vs, rows = et[sl], vx[sl], nb[sl]
    elif isinstance(window, str):
        ets, vs, rows = fsweep.chain_window(state, w, int(window[5:]))
    else:
        ets, vs, rows = fsweep.crafted_window(state, w, window)
    _assert_prep_matches(state, ets, vs, rows)


def test_window_prep_limit_matches_the_build(cuda):
    """The longest window the kernel takes is the wrapper's limit, and a
    longer one raises before any launch."""
    lib = common.load_kernel("window_prep")
    lib.window_prep_max_w.restype = ctypes.c_int
    assert lib.window_prep_max_w() == prep_max_w() == 2048
    state = init_state(10, 3, 4, 1, seed=0, device=cuda)
    w = prep_max_w() + 1
    ets = torch.zeros(w, dtype=torch.int32, device=cuda)
    rows = torch.full((w, 3), -1, dtype=torch.int32, device=cuda)
    before = window_prep.launches
    with pytest.raises(ValueError, match="up to 2048 slots"):
        window_prep(state, ets, ets, rows)
    assert window_prep.launches == before


def _row_window(cuda, setup, w, window):
    state, _, (et, vx, nb) = _setup(cuda, setup)
    warm = WINDOW_SETUPS[setup][7]
    if window == "stream":
        sl = slice(warm, warm + w)
        return state, (et[sl], vx[sl], nb[sl])
    if window.startswith("chain"):
        return state, fsweep.chain_window(state, w, int(window[5:]))
    return state, fsweep.crafted_window(state, w, int(window[7:]))


@pytest.mark.parametrize("window", ["stream", "crafted0", "crafted3",
                                    "chain1"])
@pytest.mark.parametrize("blocks", [1, 3, 4])
@pytest.mark.parametrize("w", [64, 256])
@pytest.mark.parametrize("setup", ["session", "grqc_wide"])
def test_window_prep_rows_kernel_matches_plain(cuda, setup, w, blocks,
                                               window):
    """The row-block form on every block of a P-block state (D = 192 and
    2,843): its emissions and the block's adjacency after it equal the
    plain loop's, block by block; presence is never written."""
    state, (ets, vs, rows) = _row_window(cuda, setup, w, window)
    sharded = shard_state(state, make_vertices_mesh(devices=[cuda] * blocks))
    n_loc = sharded.adj.blocks[0].shape[0]
    for b, (adj, prs) in enumerate(zip(sharded.adj.blocks,
                                       sharded.present.blocks)):
        got_adj, want_adj, prs0 = adj.clone(), adj.clone(), prs.clone()
        before = window_prep_rows.launches
        got = window_prep_rows(got_adj, prs, ets, vs, rows, b * n_loc)
        assert window_prep_rows.launches == before + 1
        want = prepare_rows_ref(want_adj, prs, ets, vs, rows, b * n_loc)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (f, b)
        assert torch.equal(got_adj, want_adj), b
        assert torch.equal(prs, prs0)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_sharded_session_on_card_matches_dense(cuda, blocks):
    """A sharded card session (P blocks on one card) equals the dense card
    session with the kernels on a churn stream (a last partial window
    too), and launched the row-block prep P times a window and the chooser
    and RNG once."""
    g = cap_degree(load_dataset("twitter", scale=0.03), 192)
    s = interleaved_churn(g, **fsweep.CHURN)
    t = s.num_events - 100
    chunk = (s.etype[:t], s.vertex[:t], s.nbrs[:t])
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=400, autoscale=True)
    dense = Partitioner(cfg, n=s.n, max_deg=192, engine="windowed",
                        use_kernel=True, device=cuda).feed(chunk)
    before = (window_prep_rows.launches, fk.fused_window_choose.launches,
              window_rng.launches)
    part = Partitioner(cfg, n=s.n, max_deg=192, sharded=True,
                       shard_devices=[cuda] * blocks).feed(chunk)
    part.sync()
    windows = part.metrics()["mixed_windows"]
    assert windows == -(-t // 256) == part.metrics()["kernel_windows"]
    assert (window_prep_rows.launches - before[0],
            fk.fused_window_choose.launches - before[1],
            window_rng.launches - before[2]) == (blocks * windows, windows,
                                                 windows)
    got = unshard_state(part.state, n=s.n)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(dense.state, f)), f


def _assert_add_matches(n, args, policy, autos):
    for guard in ("text", "alg1"):
        for auto in autos:
            kw = dict(n=n, policy=policy, balance_guard=guard,
                      autoscaling=auto)
            before = fk.add_window_choose.launches
            got = fk.add_window_choose(*args, **kw)
            assert fk.add_window_choose.launches == before + 1
            want = wnd.add_window_fixup_ref(*args, **kw)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (policy, guard, auto)


@pytest.mark.parametrize("window", ["first", "crafted"])
@pytest.mark.parametrize("setup", list(WINDOW_SETUPS))
@pytest.mark.parametrize("policy", POLICIES)
def test_add_window_kernel_matches_plain(cuda, policy, setup, window):
    """A pure-ADD window: the stream's first events, from the empty state,
    or a crafted window mid-stream (pads, a vertex added twice, ADDs of present
    vertices, rows naming their subject), scored by partition_affinity."""
    w, warm = WINDOW_SETUPS[setup][6:]
    if window == "first":
        # the stream's first w events, any deletion among them a pad
        state, cfg, (et, vx, nb) = _setup(cuda, setup, warm=0)
        vs = torch.where(et[:w] == EVENT_ADD, vx[:w], -1)
        rows, t0 = nb[:w], 0
    else:
        state, cfg, _ = _setup(cuda, setup)
        _, vs, rows = fsweep.crafted_window(state, w, 3, adds_only=True)
        t0 = warm
    args = fsweep.add_window_args(state, cfg, vs, rows, t0, scores_for_state)
    autos = (True, False) if setup == "session" else (True,)
    _assert_add_matches(state.assignment.shape[0], args, policy, autos)


def _add_case(cuda, k_max, window):
    """``add_window_choose``'s arguments and n on the session's stream at
    ``k_max`` partitions: its first 256 events from the empty state (any
    deletion a pad), or a crafted pure-ADD window after 768 events."""
    spec = fsweep.MAIN[:4] + (k_max,) + fsweep.MAIN[5:]
    w, warm = spec[6:]
    if window == "first":
        spec = spec[:7] + (0,)
    if spec not in _STATES:
        _STATES[spec] = fsweep.window_state(cuda, *spec, fsweep.CHURN)
    state, cfg, (et, vx, nb) = _STATES[spec]
    if window == "first":
        vs, rows, t0 = torch.where(et[:w] == EVENT_ADD, vx[:w], -1), nb[:w], 0
    else:
        _, vs, rows = fsweep.crafted_window(state, w, 3, adds_only=True)
        t0 = warm
    return (fsweep.add_window_args(state, cfg, vs, rows, t0,
                                   scores_for_state),
            state.assignment.shape[0])


@pytest.mark.parametrize("window", ["first", "crafted"])
@pytest.mark.parametrize("k_max", [1, 16, 40, 192])
@pytest.mark.parametrize("policy", POLICIES)
def test_add_window_lanes_kernel_matches_plain_and_large(cuda, policy, k_max,
                                                         window):
    """The lanes pure-ADD kernel, which the wrapper takes up to K = 192,
    bit-equal to the plain loop and to the large kernel (launched
    uncounted) for every guard and autoscale; the wrapper's launches
    counted by kernel."""
    args, n = _add_case(cuda, k_max, window)
    assert fk.add_dispatch(256, k_max) == "lanes"
    for guard in ("text", "alg1"):
        for auto in (True, False):
            kw = dict(policy=policy, balance_guard=guard, autoscaling=auto)
            before = fk.add_window_choose.launches
            by = dict(fk.add_window_choose.kernel_launches)
            got = fk.add_window_choose(*args, n=n, **kw)
            assert fk.add_window_choose.launches == before + 1
            assert fk.add_window_choose.kernel_launches == {
                k: c + (k == "lanes") for k, c in by.items()}
            large = fk.add_launch("large", *args, **kw)
            assert fk.add_window_choose.launches == before + 1
            want = wnd.add_window_fixup_ref(*args, n=n, **kw)
            for x, y, z in zip(got, want, large):
                assert torch.equal(x, y), (guard, auto)
                assert torch.equal(z, y), (guard, auto)


def test_partitioner_twitter_prefix_kernels_match_plain(cuda):
    """The twitter session (scale 1.0, degree cap 192) over its first 66
    windows — 63 pure-ADD, 3 mixed — with use_kernel=True, leaf for leaf
    equal to use_kernel=False on the card; every window went through its
    kernels, every pure-ADD one through the lanes add kernel, and the 66
    windows' random tables came from one window_rng draw."""
    g = cap_degree(load_dataset("twitter"), 192)
    s = interleaved_churn(g, warmup_frac=0.2, del_every=3, edge_del_every=5,
                          seed=0)
    T = 66 * 256
    sub = VertexStream(s.etype[:T], s.vertex[:T], s.nbrs[:T], n=s.n)
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=40000, autoscale=True)
    counters = (window_prep, window_rng, fk.add_window_choose,
                fk.fused_window_choose, partition_affinity)
    before = [c.launches for c in counters]
    by = dict(fk.add_window_choose.kernel_launches)
    kernel = Partitioner.from_stream(sub, cfg, policy="sdp", seed=0,
                                     use_kernel=True, device=cuda).feed(sub)
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [3, 1, 63, 3, 63]     # one draw for the 66 windows
    assert fk.add_window_choose.kernel_launches == {
        "lanes": by["lanes"] + 63, "large": by["large"]}
    m = kernel.metrics()
    assert (m["add_windows"], m["mixed_windows"]) == (63, 3)
    plain = Partitioner.from_stream(sub, cfg, policy="sdp", seed=0,
                                    use_kernel=False, device=cuda).feed(sub)
    assert [c.launches for c in counters] == [
        b + n for b, n in zip(before, launched)]
    for f in kernel.state._fields:
        assert torch.equal(getattr(kernel.state, f),
                           getattr(plain.state, f)), f


def test_window_pipelines_read_nothing_back_to_the_host(cuda):
    """A pure-ADD and a mixed window through the kernels, each captured in
    a CUDA graph (a read back to the host inside a window breaks the
    capture), then replayed on a copy of the same state: leaf for leaf the
    eager result."""
    state, cfg, (et, vx, nb) = _setup(cuda, "session")
    knobs = tx.knob_tensor(cfg, state.assignment.shape[0], cuda)
    _, vs_add, rows_add = fsweep.crafted_window(state, 256, 3, adds_only=True)
    sl = slice(768, 1024)
    calls = {
        "add": lambda st: fops.run_window_adds_fused(
            st, vs_add, rows_add, 768, policy="sdp", cfg=cfg, knobs=knobs),
        "mixed": lambda st: fops.run_window_mixed_fused(
            st, et[sl], vx[sl], nb[sl], 768, policy="sdp", cfg=cfg,
            knobs=knobs)}
    for kind, call in calls.items():
        want = call(fsweep.clone_state(state))
        st = fsweep.clone_state(state)
        warm = fsweep.clone_state(state)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call(warm)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = call(st)
        for dst, src in zip(st, state):             # the key is never written
            if dst.dtype != torch.uint32:
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (kind, f)


def _grqc_session(cuda, use_kernel, **kw):
    s = interleaved_churn(load_dataset("grqc", scale=0.3), warmup_frac=0.2,
                          del_every=3, edge_del_every=5, seed=0)
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=300, autoscale=True)
    return Partitioner.from_stream(s, cfg, policy="sdp", seed=0, window=128,
                                   use_kernel=use_kernel, device=cuda,
                                   **kw).feed(s), s


@pytest.mark.parametrize("m,passes", [(64, 2), (0, 3), (300, 0)])
def test_rebalance_kernel_matches_plain_histograms(cuda, m, passes):
    """rebalance() on a card session with use_kernel=True takes its label
    histograms from partition_affinity at W = n — once for the migration's
    ranking and twice an LPA iteration — and equals the same rebalance with
    the plain histograms on the card, leaf for leaf, and a recount."""
    from repro_torch.core.metrics import recompute_counters
    (kp, _), (pp, _) = (_grqc_session(cuda, k) for k in (True, False))
    before = partition_affinity.launches
    ek = kp.rebalance(m=m, passes=passes)
    assert partition_affinity.launches - before == \
        (1 if m else 0) + 2 * passes
    after = partition_affinity.launches
    ep = pp.rebalance(m=m, passes=passes)
    assert partition_affinity.launches == after
    assert ek == ep
    if not passes:     # commits only ever lower the cut
        assert ek["cut_after"] <= ek["cut_before"]
    for f in kp.state._fields:
        assert torch.equal(getattr(kp.state, f), getattr(pp.state, f)), f
    st = kp.state
    rec = recompute_counters(st.assignment.cpu().numpy(),
                             st.present.cpu().numpy(), st.adj.cpu().numpy(),
                             st.edge_load.shape[0])
    assert np.array_equal(rec["cut_matrix"], st.cut_matrix.cpu().numpy())
    assert rec["cut_edges"] == int(st.cut_edges)


def test_snapshot_on_card_restores_on_cpu_and_back(cuda, tmp_path):
    """A card session's snapshot restores into a CPU session and back onto
    the card; all three, fed the same tail, stay equal."""
    part, s = _grqc_session(cuda, True, auto_shrink=True, shrink_every=512)
    cfg = part.cfg
    part.feed((np.ones(300, np.int32), s.vertex[:300],
               np.full((300, 1), -1, np.int32)))
    part.compact()
    part.snapshot(str(tmp_path / "card"), blocking=False)
    part.wait()
    kw = dict(policy="sdp", window=128, use_kernel=True, auto_shrink=True,
              shrink_every=512)
    host = Partitioner.restore(str(tmp_path / "card"), cfg, device="cpu",
                               **kw)
    host.snapshot(str(tmp_path / "host"))
    back = Partitioner.restore(str(tmp_path / "host"), cfg, device=cuda,
                               **kw)
    assert host.device.type == "cpu" and back.device.type == "cuda"
    tail = (s.etype[:600], s.vertex[:600], s.nbrs[:600])
    for p in (part, host, back):
        p.feed(tail)
    for f in part.state._fields:
        want = getattr(part.state, f).cpu()
        assert torch.equal(want, getattr(host.state, f)), f
        assert torch.equal(want, getattr(back.state, f).cpu()), f


# -- the serving tier and crash-safe sessions on the card -------------------

def _grqc_stream():
    return interleaved_churn(load_dataset("grqc", scale=0.3), warmup_frac=0.2,
                             del_every=3, edge_del_every=5, seed=0)


def _grqc_card(s, cuda, cls=Partitioner, **kw):
    cfg = EngineConfig(k_max=16, k_init=1, max_cap=300, autoscale=True)
    kw.setdefault("window", 128)
    return cls.from_stream(s, cfg, policy="sdp", seed=0, use_kernel=True,
                           device=cuda, **kw)


def _arrivals(s, mean_batch=24.0):
    from repro_torch.graph.stream import poisson_arrivals
    bounds, _ = poisson_arrivals(s, rate=1.0, mean_batch=mean_batch, seed=1)
    return [(s.etype[a:b], s.vertex[a:b], s.nbrs[a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


def _assert_states_equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f


class _Recording(Partitioner):
    """Records the cursor after each dispatched batch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.boundaries = [0]

    def feed_prepared(self, chunk):
        super().feed_prepared(chunk)
        self.boundaries.append(self.cursor)
        return self


@pytest.mark.parametrize("stream", ["current", "side"])
@pytest.mark.parametrize("engine", ["windowed", "auto"])
def test_service_on_card_equals_sync_session(cuda, engine, stream):
    """PartitionService over a card session with use_kernel=True (built on
    the current stream, or on a side stream that then carries every
    dispatch and gather) equals a synchronous card session, and its
    completion tokens are CUDA events on the session's stream."""
    from repro_torch.api import PartitionService
    s = _grqc_stream()
    sync = _grqc_card(s, cuda, engine=engine).feed(s)
    side = torch.cuda.Stream(cuda) if stream == "side" else None
    part = _grqc_card(s, cuda, engine=engine)
    before = window_rng.launches
    with torch.cuda.stream(side):
        svc = PartitionService(part, max_pending_chunks=64)
    assert svc._stream == (side or torch.cuda.current_stream(cuda))
    with svc:
        for c in _arrivals(s):
            svc.submit(c, timeout=60)
        svc.flush(timeout=120)
        labels = svc.where_many(np.arange(s.n))
        m = svc.metrics()
    assert isinstance(svc._token(), torch.cuda.Event)
    assert window_rng.launches > before
    assert m["events_ingested"] == s.num_events
    _assert_states_equal(sync.state, part.state)
    assert np.array_equal(labels, sync.state.assignment.cpu().numpy())


def test_service_queries_during_ingest_see_batch_boundaries(cuda):
    """A reader thread's where_many answers taken while the card ingests:
    each equals a synchronous card session's labels at a dispatched batch
    boundary between the cursors read before and after the query."""
    import threading
    from repro_torch.api import PartitionService
    s = _grqc_stream()
    part = _grqc_card(s, cuda, cls=_Recording, engine="windowed")
    rng = np.random.default_rng(3)
    answers, stop = [], threading.Event()
    svc = PartitionService(part, max_pending_chunks=64)

    def reader():
        while not stop.is_set():
            ids = rng.integers(0, s.n, 256).astype(np.int32)
            lo = part.cursor
            answers.append((lo, ids, svc.where_many(ids), part.cursor))

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    for c in _arrivals(s, mean_batch=8.0):
        svc.submit(c, timeout=60)
    svc.flush(timeout=120)
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive()
    svc.close()
    assert len(answers) > 1
    ref = _grqc_card(s, cuda, engine="windowed")
    labels, prev = {}, 0
    for c in part.boundaries:
        ref.feed((s.etype[prev:c], s.vertex[prev:c], s.nbrs[prev:c]))
        prev = c
        labels[c] = ref.state.assignment.cpu().numpy().copy()
    for lo, ids, got, hi in answers:
        assert any(np.array_equal(got, labels[c][ids])
                   for c in part.boundaries if lo <= c <= hi), (lo, hi)


def test_crash_on_card_recovers_equal(cuda, tmp_path):
    """A RecoverableSession on the card crashes (injected) at 70 % of the
    stream; recover() on the card and the rest of the stream reach the
    uninterrupted card session's state."""
    from repro_torch.runtime import CrashError, RecoverableSession
    s = _grqc_stream()
    T = s.num_events
    ref = _grqc_card(s, cuda).feed(s)
    sess = RecoverableSession(_grqc_card(s, cuda), str(tmp_path),
                              snapshot_every=512,
                              inject_crash_after=int(0.7 * T))
    with pytest.raises(CrashError):
        for a in range(0, T, 300):
            sess.feed((s.etype[a:a + 300], s.vertex[a:a + 300],
                       s.nbrs[a:a + 300]))
    sess.wait()
    cfg = ref.cfg
    rec = RecoverableSession.recover(str(tmp_path), cfg, policy="sdp",
                                     window=128, use_kernel=True,
                                     device=cuda)
    assert rec.device.type == "cuda" and rec.cursor > int(0.7 * T)
    c = rec.cursor
    rec.feed((s.etype[c:], s.vertex[c:], s.nbrs[c:]))
    _assert_states_equal(ref.state, rec.state)


def test_remesh_card_cpu_card_continues(cuda, tmp_path):
    """remesh() card → CPU → card mid-stream: the session goes on
    bit-identically to the one that never moved."""
    from repro_torch.runtime import RecoverableSession
    s = _grqc_stream()
    T = s.num_events
    ref = _grqc_card(s, cuda).feed(s)
    sess = RecoverableSession(_grqc_card(s, cuda), str(tmp_path))
    cuts = (0, T // 3, 2 * T // 3, T)
    for (a, b), dev in zip(zip(cuts[:-1], cuts[1:]), ("cpu", cuda, None)):
        sess.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
        if dev is not None:
            sess.remesh(dev)
            assert sess.state.assignment.device.type == \
                torch.device(dev).type
    assert sess.device.type == "cuda"
    _assert_states_equal(ref.state, sess.state)


# -- the sweep form of the fused chooser and the sweep lanes on the card ----

_SWEEP_WARMS = (64, 128, 192, 256)


@pytest.fixture(scope="module")
def _sweep_windows():
    """Four distinct windows (states and prep tables) per k_max, made once:
    lane b takes window b % 4."""
    cache = {}

    def get(cuda, k_max):
        if k_max not in cache:
            cache[k_max] = [_window(cuda, k_max, warm=w) for w in _SWEEP_WARMS]
        return cache[k_max]
    return get


def _stack_lanes(args_per_lane):
    return tuple(torch.stack(x).contiguous() for x in zip(*args_per_lane))


@pytest.mark.parametrize("guard", ["text", "alg1"])
@pytest.mark.parametrize("lanes", [1, 3, 64])
@pytest.mark.parametrize("k_max", [16, 200])
def test_fused_chooser_sweep_form_matches_single_and_plain(
        cuda, _sweep_windows, k_max, lanes, guard):
    """The sweep form, one launch for L lanes of mixed policies and scale
    gates (K = 16: the lanes layout; K = 200: the large one): each lane
    bit-equal to the single-session kernel on its own inputs and to the
    plain version."""
    wins = _sweep_windows(cuda, k_max)
    n = wins[0][0]
    per = [wins[b % 4][1] for b in range(lanes)]
    pol = [b % len(POLICIES) for b in range(lanes)]
    gate = [(b // len(POLICIES) + b) % 2 for b in range(lanes)]
    flags = torch.tensor(list(zip(pol, gate)), dtype=torch.int32,
                         device=cuda)
    args = _stack_lanes(per)
    kernel = f"sweep_{fk.dispatch(per[0][1].shape[0], k_max)}"
    for dynamic in (True, False):
        before = dict(fk.fused_window_choose_lanes.kernel_launches)
        single = fk.fused_window_choose.launches
        got = fk.fused_window_choose_lanes(*args, flags, n=n,
                                           balance_guard=guard,
                                           dynamic=dynamic)
        assert fk.fused_window_choose_lanes.kernel_launches == {
            k: c + (k == kernel) for k, c in before.items()}
        assert fk.fused_window_choose.launches == single
        cpu = [x.cpu() for x in args]
        want = fk.fused_window_choose_lanes(*cpu, flags.cpu(), n=n,
                                            balance_guard=guard,
                                            dynamic=dynamic)
        for b in range(lanes):
            one = fk.fused_window_choose(
                *per[b], n=n, policy=POLICIES[pol[b]], balance_guard=guard,
                autoscaling=dynamic and gate[b] == 1)
            for x, y, z in zip(got, one, want):
                assert torch.equal(x[b], y), (b, pol[b], gate[b])
                assert torch.equal(x[b].cpu(), z[b]), (b, pol[b], gate[b])


def test_fused_chooser_sweep_form_on_grqc_rows(cuda):
    """The sweep form at grqc's 2,843-wide rows, 3 lanes: equal to the
    single-session kernel lane by lane."""
    state, cfg, (et, vx, nb) = fsweep.window_state(
        cuda, *WINDOW_SETUPS["grqc_wide"], fsweep.CHURN)
    n = state.assignment.shape[0]
    w, k = 256, cfg.k_max
    per = []
    for b in range(3):
        st = type(state)(*(x.clone() for x in state))
        sl = slice(1024 + b * w, 1024 + (b + 1) * w)
        prep = _prepare_window(st, et[sl], vx[sl], nb[sl])
        per.append((prep.ev, prep.src_lbl, prep.touch,
                    window_rng(st.key, sl.start, w, k), *wnd.small_args(st),
                    tx.knob_tensor(cfg, n, cuda)))
    flags = torch.tensor([[0, 1], [2, 0], [5, 1]], dtype=torch.int32,
                         device=cuda)
    got = fk.fused_window_choose_lanes(*_stack_lanes(per), flags, n=n,
                                       balance_guard="text", dynamic=True)
    for b, (p, g) in enumerate(flags.tolist()):
        one = fk.fused_window_choose(*per[b], n=n, policy=POLICIES[p],
                                     balance_guard="text",
                                     autoscaling=g == 1)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y), b


@pytest.mark.parametrize("kw", [dict(window=4096),
                                dict(cfg=EngineConfig(k_max=20000))])
def test_partitioner_past_a_kernel_limit_raises_when_built(cuda, kw):
    """A card session past a kernel's shape limit raises at construction,
    naming the knob to lower; the same session without the kernels, or on
    the CPU, is built."""
    knob = "window" if "window" in kw else "k_max"
    with pytest.raises(ValueError, match=knob):
        Partitioner(use_kernel=True, device=cuda, **kw)
    Partitioner(use_kernel=False, device=cuda, **kw)
    Partitioner(use_kernel=True, device="cpu", **kw)


def test_sweep_kernel_lanes_match_card_sessions(cuda):
    """Sweep(...).windowed(64).kernel() on the card: one sweep-form launch
    per window step, and every lane equal to its own card session."""
    from repro_torch.api import Sweep
    s = interleaved_churn(load_dataset("grqc", scale=0.2), warmup_frac=0.2,
                          del_every=3, edge_del_every=5, seed=0)
    runs = [(p, EngineConfig(k_max=16, k_init=1 if p == "sdp" else 4,
                             max_cap=60, autoscale=p == "sdp"), b)
            for b, p in enumerate(POLICIES)]
    before = fk.fused_window_choose_lanes.launches
    res = Sweep(s, device=cuda).lanes(runs).windowed(64).kernel().run()
    assert fk.fused_window_choose_lanes.launches - before == \
        -(-s.num_events // 64)
    for r in res:
        part = Partitioner.from_stream(s, r.cfg, policy=r.policy, seed=r.seed,
                                       window=64, engine="windowed",
                                       use_kernel=True, device=cuda).feed(s)
        _assert_states_equal(part.state, r.state)


# ---------------------------------------------------------------------------
# the GNNs (no kernel of their own: the card's index_add / scatter_reduce
# and matmuls against the same step on the host's CPU)
# ---------------------------------------------------------------------------

def _gnn_grads(loss_fn, params, batch, cfg):
    loss, _, grads = train_steps.value_and_grad(loss_fn, params, batch, cfg)
    return float(loss), {k: v.cpu() for k, v in _leaf_items(grads)}


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _assert_gnn_close(got, want, nonfinite_ok=False):
    (lg, gg), (lw, gw) = got, want
    assert abs(lg - lw) <= 1e-5 * abs(lw)
    for k, w in gw.items():
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(gg[k]), fin), k
        assert nonfinite_ok or bool(fin.all()), k
        d = torch.linalg.vector_norm((gg[k][fin] - w[fin]).double())
        assert float(d) <= 1e-4 * float(torch.linalg.vector_norm(
            w[fin].double())) + 1e-12, k


@pytest.mark.parametrize("arch_id", ["meshgraphnet", "pna", "schnet",
                                     "nequip"])
def test_gnn_first_step_on_card_matches_host(cuda, arch_id):
    from repro_torch.graph.generators import make_graph
    from repro_torch.models.gnn import common as GC

    mod = train_steps._GNN_MODELS[arch_id]
    cfg = get_arch(arch_id).smoke_config
    gen = torch.Generator().manual_seed(0)
    if arch_id in ("schnet", "nequip"):
        batch = GC.batch_molecules(16, 12, 24, seed=0)
        params = mod.init_params(cfg, generator=gen, device="cpu")
    else:
        batch = GC.graph_to_batch(make_graph("mesh", 256, 700, seed=0), 16,
                                  with_positions=True, seed=0)
        params = mod.init_params(cfg, 16, generator=gen, device="cpu")
    want = _gnn_grads(mod.loss_fn, params, train.batch_tensors(batch, "cpu"),
                      cfg)
    got = _gnn_grads(mod.loss_fn, tree_map(lambda x: x.to(cuda), params),
                     train.batch_tensors(batch, cuda), cfg)
    _assert_gnn_close(got, want, nonfinite_ok=arch_id == "nequip")


@pytest.mark.parametrize("p", [1, 4, 8])
def test_halo_mgn_step_on_card_matches_host_and_dense(cuda, p):
    import dataclasses

    from repro_torch.graph.generators import make_graph
    from repro_torch.graph.halo import build_halo_spec
    from repro_torch.models.gnn import common as GC
    from repro_torch.models.gnn import meshgraphnet as MGN
    from repro_torch.runtime.gnn_halo_train import (
        halo_batch, make_mgn_halo_loss,
    )

    cfg = dataclasses.replace(get_arch("meshgraphnet").smoke_config,
                              remat=True)
    g = make_graph("mesh", 2000, 5500, seed=1)
    batch = GC.graph_to_batch(g, 16, seed=0)
    spec = build_halo_spec(g, np.random.default_rng(p).integers(0, p, g.n), p)
    hb = halo_batch(spec, batch["node_feat"], batch["targets"])
    params = MGN.init_params(cfg, 16, generator=torch.Generator().manual_seed(
        0), device="cpu")
    loss_fn = make_mgn_halo_loss(cfg, spec.block_size)
    want = _gnn_grads(loss_fn, params, train.batch_tensors(hb, "cpu"), cfg)
    card = tree_map(lambda x: x.to(cuda), params)
    got = _gnn_grads(loss_fn, card, train.batch_tensors(hb, cuda), cfg)
    _assert_gnn_close(got, want)
    dense = _gnn_grads(MGN.loss_fn, card, train.batch_tensors(batch, cuda),
                       cfg)
    _assert_gnn_close(got, dense)


# ---------------------------------------------------------------------------
# the backward's order and pass, window_rng's table axis and its callers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,d,b,l,kind", [
    ((1 << 22), 256, 131_072, 8, "random"), (50, 256, 4096, 8, "hot"),
    (7, 130, 300, 37, "random"), (300, 5, 45, 2000, "padded"),
    (1000, 24, 512, 9, "dup"), (1, 16, 40, 3, "random")])
def test_embedding_bag_backward_order_and_pass(cuda, v, d, b, l, kind):
    """The card's order against the plain one: the same CSR offsets and bag
    counts, each run the same positions (a run of more than 32 in the same
    ascending order; shorter ones sorted by the pass); then the pass over
    it into a NaN-filled table writes every row, bit-equal to the plain
    backward on the host, twice."""
    idx, g = bwd_case(cuda, v, d, b, l, kind, seed=7 * v + l)
    got = backward_order(idx, v)
    want = backward_order_ref(idx.cpu(), v)
    torch.cuda.synchronize()
    assert all(x.dtype == torch.int32 for x in got)
    assert torch.equal(got.offsets.cpu(), want.offsets)
    assert torch.equal(got.counts.cpu(), want.counts)
    off = want.offsets.tolist()
    perm, ref = got.perm.cpu(), want.perm
    for r in range(v):
        run, ref_run = perm[off[r]:off[r + 1]], ref[off[r]:off[r + 1]]
        if run.numel() > 32:
            assert torch.equal(run, ref_run), r
        else:
            assert torch.equal(torch.sort(run).values, ref_run), r
    for mode in ("sum", "mean"):
        plain = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, mode=mode)
        for _ in range(2):
            out = torch.full((v, d), float("nan"), device=cuda)
            backward_launch(g, idx, got, out, mode == "mean")
            torch.cuda.synchronize()
            assert _same_bits(out.cpu(), plain), mode


def test_embedding_bag_backward_odd_alignment_takes_the_scalar_pass(cuda):
    """A g whose base is not 16-byte aligned (a row view at an odd offset)
    takes the one-float pass, bit-equal to the plain backward."""
    v, d, b, l = 500, 64, 300, 6
    idx, g = bwd_case(cuda, v, d, b, l, "random", seed=11)
    flat = torch.empty(b * d + 1, device=cuda)
    g_odd = flat[1:].view(b, d)
    g_odd.copy_(g)
    for mode in ("sum", "mean"):
        got = embedding_bag_backward(g_odd, idx, v, mode=mode)
        want = embedding_bag_backward_ref(g.cpu(), idx.cpu(), v, mode=mode)
        assert _same_bits(got.cpu(), want), mode


@pytest.mark.parametrize("k", [1, 16, 1000])
@pytest.mark.parametrize("lanes", [1, 3, 64])
def test_window_rng_table_axis_matches_one_window_draws(cuda, lanes, k):
    """(L, 2) keys draw the (L, w, K) tables in one launch, each bit-equal
    to its one-window draw and to the plain version, at a shared start and
    at one whose window wraps past 2^32."""
    keys = torch.stack([prng_key(7 * j + (2**40 if j % 2 else 0),
                                 device=cuda) for j in range(lanes)])
    w = 256
    for t0 in (114_958, 2**32 - 100):
        before = window_rng.launches
        got = window_rng(keys, t0, w, k)
        assert window_rng.launches == before + 1
        assert got.shape == (lanes, w, k)
        one = torch.stack([window_rng(keys[j], t0, w, k)
                           for j in range(lanes)])
        assert torch.equal(got, one)
        assert torch.equal(got.cpu(), window_rng_ref(keys.cpu(), t0, w, k))


@pytest.mark.parametrize("k_max,window", [(16, 128), (200, 256)])
def test_session_multi_window_draws_equal_one_draw_a_window(cuda, monkeypatch,
                                                            k_max, window):
    """A card session whose windows take their tables from draws of many
    windows (one launch for the feed) equals one that draws a table a
    window, fed in chunks that cut windows; then a rebalance and more
    feeds."""
    s = _grqc_stream()
    T = s.num_events
    bounds = [0, 1000, 1001, T // 2, T]
    cfg = EngineConfig(k_max=k_max, k_init=1, max_cap=300, autoscale=True)

    def run(per_draw):
        monkeypatch.setattr(fops, "windows_per_draw",
                            lambda w, k: per_draw or (1 << 30))
        part = Partitioner.from_stream(s, cfg, policy="sdp", seed=0,
                                       use_kernel=True, window=window,
                                       device=cuda)
        before = window_rng.launches
        for a, b in zip(bounds[:-2], bounds[1:-1]):
            part.feed((s.etype[a:b], s.vertex[a:b], s.nbrs[a:b]))
        part.rebalance(m=32, passes=1)
        a = bounds[-2]
        part.feed((s.etype[a:], s.vertex[a:], s.nbrs[a:]))
        part.sync()
        return part, window_rng.launches - before

    many, draws = run(None)
    one, per_window = run(1)
    feeds = [b - a for a, b in zip(bounds[:-1], bounds[1:])]
    assert draws == sum(f >= window for f in feeds)
    assert per_window == sum(f // window for f in feeds)
    _assert_states_equal(many.state, one.state)


def test_sweep_one_window_rng_launch_a_step(cuda):
    """Sweep(...).windowed(64).kernel(): one window_rng launch a window
    step for all six lanes, every lane equal to its own card session."""
    from repro_torch.api import Sweep
    s = interleaved_churn(load_dataset("grqc", scale=0.2), warmup_frac=0.2,
                          del_every=3, edge_del_every=5, seed=0)
    runs = [(p, EngineConfig(k_max=16, k_init=1 if p == "sdp" else 4,
                             max_cap=60, autoscale=p == "sdp"), b)
            for b, p in enumerate(POLICIES)]
    before = window_rng.launches
    res = Sweep(s, device=cuda).lanes(runs).windowed(64).kernel().run()
    assert window_rng.launches - before == -(-s.num_events // 64)
    for r in res:
        part = Partitioner.from_stream(s, r.cfg, policy=r.policy, seed=r.seed,
                                       window=64, engine="windowed",
                                       use_kernel=True, device=cuda)
        draws = window_rng.launches
        part.feed(s)
        assert window_rng.launches - draws == 1
        _assert_states_equal(part.state, r.state)

"""Each kernel module of the port against its JAX twin on the same inputs,
exactly: partition_affinity_ref vs the Pallas partition_affinity (run as
the JAX package's tests run it on the CPU, in interpret mode), the fused
chooser's prep tables, and fused_window_choose_ref vs the Pallas
fused_window_choose on the same prepared tables. On the CPU every wrapper
runs its plain version; the kernel-vs-plain checks on the card live in
tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import transition as jtx
from repro.kernels.fused_chooser import fused_chooser as jfk
from repro.kernels.fused_chooser import ops as jops
from repro.kernels.partition_affinity import ops as jpa_ops
from repro.kernels.partition_affinity.partition_affinity import (
    partition_affinity as jpartition_affinity,
)
from repro_torch.core import transition as ttx
from repro_torch.core.config import EngineConfig, POLICIES
from repro_torch.core.state import state_from_numpy
from repro_torch.kernels.fused_chooser import fused_chooser as tfk
from repro_torch.kernels.fused_chooser import ops as tops
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
from repro_torch.kernels.partition_affinity import ops as tpa_ops
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref

from test_torch_windowed import _mid_state
from test_torch_engine import release_jax_executables  # noqa: F401


@pytest.mark.parametrize("w,d,k", [(1, 1, 1), (7, 3, 2), (100, 37, 5),
                                   (130, 129, 16), (256, 256, 16)])
def test_partition_affinity_plain_matches_pallas(w, d, k):
    rng = np.random.default_rng(w * 1000 + d)
    labels = rng.integers(-1, k, size=(w, d)).astype(np.int32)
    sc_j, deg_j = jpartition_affinity(jnp.asarray(labels), k_max=k)
    sc_t, deg_t = partition_affinity_ref(torch.from_numpy(labels), k_max=k)
    np.testing.assert_array_equal(np.asarray(sc_j), sc_t.numpy())
    np.testing.assert_array_equal(np.asarray(deg_j), deg_t.numpy())
    # the wrapper runs the plain version for CPU tensors, and counts nothing
    before = partition_affinity.launches
    sc_w, deg_w = partition_affinity(torch.from_numpy(labels), k_max=k)
    assert torch.equal(sc_w, sc_t) and torch.equal(deg_w, deg_t)
    assert partition_affinity.launches == before


def test_scores_for_state_matches_jax_on_holes():
    s_j, mid, _, _ = _mid_state(seed=21)
    rows = s_j.nbrs[:48]
    sc_j, deg_j = jpa_ops.scores_for_state(mid, jnp.asarray(rows))
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    sc_t, deg_t = tpa_ops.scores_for_state(st, torch.from_numpy(rows))
    np.testing.assert_array_equal(np.asarray(sc_j), sc_t.numpy())
    np.testing.assert_array_equal(np.asarray(deg_j), deg_t.numpy())


def _prepared(seed, w):
    """JAX and port prep tables for the window after a holed mid-state."""
    s_j, mid, half, kw = _mid_state(seed=seed)
    sl = slice(half, half + w)
    ets, vs, rows = s_j.etype[sl], s_j.vertex[sl], s_j.nbrs[sl]
    prep_j = jops._prepare_window(mid, jnp.asarray(ets), jnp.asarray(vs),
                                  jnp.asarray(rows))
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    prep_t = tops._prepare_window(st, torch.from_numpy(ets),
                                  torch.from_numpy(vs), torch.from_numpy(rows))
    return mid, st, prep_j, prep_t, half, kw


def test_prepare_window_matches_jax():
    _, _, prep_j, prep_t, _, _ = _prepared(13, 64)
    for f in prep_j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(prep_j, f)),
                                      getattr(prep_t, f).numpy(), err_msg=f)


_CASES = ([("sdp", g, a) for g in ("text", "alg1") for a in (True, False)]
          + [(p, "text", False) for p in POLICIES[1:]])


@pytest.fixture(scope="module")
def window_tables():
    mid, st, prep_j, prep_t, half, kw = _prepared(13, 48)
    k = int(mid.edge_load.shape[0])
    n = int(mid.assignment.shape[0])
    cfg = EngineConfig(**kw)
    rand_j = jtx.rand_index_table(mid.key, half, 48, k)
    rand_t = ttx.rand_index_table(st.key, half, 48, k)
    np.testing.assert_array_equal(np.asarray(rand_j), rand_t.numpy())
    knobs = ttx.knob_values(cfg, n)
    scal_j = jnp.stack([mid.num_partitions, mid.total_edges, mid.cut_edges,
                        mid.denied_scaleout, mid.scale_events])
    args_j = (prep_j.ev, prep_j.src_lbl, prep_j.touch, rand_j, mid.active,
              mid.edge_load, mid.vertex_count, mid.cut_matrix, scal_j,
              jnp.asarray(knobs, jnp.float32))
    args_t = (prep_t.ev, prep_t.src_lbl, prep_t.touch, rand_t, st.active,
              st.edge_load, st.vertex_count, st.cut_matrix,
              torch.from_numpy(np.array(scal_j)),
              torch.tensor(knobs, dtype=torch.float32))
    return n, args_j, args_t


@pytest.mark.parametrize("policy,guard,autoscaling", _CASES)
def test_fused_window_choose_plain_matches_pallas(window_tables, policy,
                                                  guard, autoscaling):
    n, args_j, args_t = window_tables
    want = jfk.fused_window_choose(
        *args_j, jnp.array([0, 1], jnp.int32), n=n, policy=policy,
        balance_guard=guard, autoscaling=autoscaling, dynamic=False)
    kw = dict(n=n, policy=policy, balance_guard=guard, autoscaling=autoscaling)
    got = fused_window_choose_ref(*args_t, **kw)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    # the wrapper takes the plain version for CPU tensors
    before = tfk.fused_window_choose.launches
    for x, y in zip(got, tfk.fused_window_choose(*args_t, **kw)):
        assert torch.equal(x, y)
    assert tfk.fused_window_choose.launches == before


def test_fused_window_choose_k_max_one():
    """A single partition slot: every choice is slot 0, scale-outs are
    denied — against the JAX oracle on a k_max=1 window."""
    from repro.core import EngineConfig as JCfg
    from repro.core import run_stream as jrun
    from repro.graph import stream as jstream
    from test_torch_engine import churn_pair
    s_j, _ = churn_pair(seed=3)
    kw = dict(k_max=1, k_init=1, max_cap=20, autoscale=True)
    first = jstream.VertexStream(etype=s_j.etype[:64], vertex=s_j.vertex[:64],
                                 nbrs=s_j.nbrs[:64], n=s_j.n)
    mid, _ = jrun(first, cfg=JCfg(**kw), seed=1)
    sl = slice(64, 64 + 40)
    from repro.kernels.fused_chooser.ops import run_window_mixed_fused as jfused
    want = jfused(mid, jnp.asarray(s_j.etype[sl]), jnp.asarray(s_j.vertex[sl]),
                  jnp.asarray(s_j.nbrs[sl]), jnp.int32(64), policy="sdp",
                  cfg=JCfg(**kw))
    st = state_from_numpy([np.asarray(x) for x in mid], device="cpu")
    got = tops.run_window_mixed_fused(
        st, torch.from_numpy(s_j.etype[sl]), torch.from_numpy(s_j.vertex[sl]),
        torch.from_numpy(s_j.nbrs[sl]), 64, policy="sdp",
        cfg=EngineConfig(**kw))
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert int(got.denied_scaleout) > 0


def test_kernel_inputs_must_share_a_device():
    labels = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        partition_affinity(labels, k_max=2)


# ---------------------------------------------------------------------------
# the CUDA fused chooser's warp reductions (a CPU model in
# kernels/fused_chooser/ref.py) against transition's sequential loops
# ---------------------------------------------------------------------------

from types import SimpleNamespace  # noqa: E402

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.fused_chooser import ref as fref  # noqa: E402


@st.composite
def _k_vectors(draw):
    """K in 1..80 (past the warp's 32 lanes, into a third entry a lane):
    loads and scores from small ranges, so ties are common, and masks that
    may be all False."""
    k = draw(st.integers(1, 80))
    ints = st.lists(st.integers(-2, 6), min_size=k, max_size=k)
    mask = draw(st.one_of(st.just([False] * k),
                          st.lists(st.booleans(), min_size=k, max_size=k)))
    return (torch.tensor(draw(ints), dtype=torch.int32),
            torch.tensor(draw(ints), dtype=torch.int32),
            torch.tensor(mask), draw(st.integers(-200, 200)))


@settings(max_examples=300, deadline=None)
@given(_k_vectors())
def test_warp_reductions_pick_what_the_loops_pick(vecs):
    load, scores, active, ridx = vecs
    assert fref.warp_masked_argmin(load, active) == int(
        ttx.masked_argmin(load, active))
    assert fref.warp_nth_active(active, ridx) == int(
        ttx.nth_active(active, torch.tensor(ridx, dtype=torch.int32)))
    state = SimpleNamespace(active=active, edge_load=load)
    assert fref.warp_affinity_choice(active, scores, load, ridx) == int(
        ttx._affinity_choice_at(state, scores,
                                torch.tensor(ridx, dtype=torch.int32)))
    # LDG's and Fennel's banded pick (transition._choose_ldg's last lines):
    # scores / 4 gives f32 ties and near-ties inside the 1e-6 band
    h = torch.where(active, scores.to(torch.float32) / 4
                    + (load == 3).to(torch.float32) * 5e-7, -torch.inf)
    tied = active & (h >= h.max() - 1e-6)
    assert fref.warp_banded_pick(h, active, load) == int(
        ttx.masked_argmin(load, tied))

"""The ``window_prep`` kernel's decomposition on the CPU: its model
``ref.prepare_window_chains`` — the previous-toucher index from the events
alone, then each touched adjacency row walked through its own chain of
slots — against the serial prep loop (``ref.prepare_window_ref``) and JAX
``_prepare_window``, on crafted windows (``sweep.crafted_window``), windows
over a few hot vertices (``sweep.chain_window``) and a hypothesis property
over windows that name few vertices, so chains are long."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.state import PartitionState as JState
from repro.kernels.fused_chooser import ops as jops
from repro_torch.core.state import init_state, state_to_numpy
from repro_torch.kernels.fused_chooser import sweep as fsweep
from repro_torch.kernels.fused_chooser.ref import (
    prepare_window_chains, prepare_window_ref,
)
from test_torch_engine import release_jax_executables  # noqa: F401

_JAX_PREP = jax.jit(jops._prepare_window)
_STATES = {}


def _state(setup):
    if setup not in _STATES:
        _STATES[setup] = fsweep.window_state(
            torch.device("cpu"), *fsweep.WINDOW_SETUPS[setup],
            fsweep.CHURN)[0]
    return _STATES[setup]


def _assert_prep_equal(state, ets, vs, rows):
    """The model, the serial loop and JAX on copies of ``state``: every
    output and the adjacency after it equal; presence unwritten."""
    leaves = state_to_numpy(state)
    want = _JAX_PREP(JState(*(jnp.asarray(x) for x in leaves)),
                     jnp.asarray(ets.numpy()), jnp.asarray(vs.numpy()),
                     jnp.asarray(rows.numpy()))
    a, b = fsweep.clone_state(state), fsweep.clone_state(state)
    ref = prepare_window_ref(a, ets, vs, rows)
    got = prepare_window_chains(b, ets, vs, rows)
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
        assert torch.equal(getattr(ref, f), getattr(got, f)), f
    assert torch.equal(a.adj, b.adj)
    np.testing.assert_array_equal(leaves.present, b.present.numpy())
    return got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("setup", ["odd", "k40"])
def test_prep_chains_match_on_crafted_windows(setup, seed):
    """Pads, self-loops, an edge deleted from both endpoints, a vertex
    added twice, a deleted vertex added again (and a pure-ADD window)."""
    state = _state(setup)
    w = fsweep.WINDOW_SETUPS[setup][6]
    got = _assert_prep_equal(state,
                             *fsweep.crafted_window(state, w, seed))
    assert int(got.ev[:, 4].sum()) > 0                  # existing edges
    _assert_prep_equal(state, torch.zeros(w, dtype=torch.int32),
                       *fsweep.crafted_window(state, w, seed,
                                              adds_only=True)[1:])


@pytest.mark.parametrize("seed", range(4))
def test_prep_chains_match_on_hot_vertex_windows(seed):
    state = _state("odd")
    ets, vs, rows = fsweep.chain_window(state, 100, seed)
    got = _assert_prep_equal(state, ets, vs, rows)
    assert int(got.ev[:, 2].sum()) > 1 and int(got.ev[:, 3].sum()) > 1


# a state of N vertices (rows of D), a window of W slots over vertices
# 0..HOT-1 (and -1: a pad, or a DEL_EDGE of no neighbour)
N, D, W, HOT = 10, 4, 16, 5
_vertex = st.integers(-1, HOT - 1)
_row = st.lists(st.integers(-1, N - 1), min_size=D, max_size=D)


@settings(max_examples=200, deadline=None)
@given(present=st.lists(st.booleans(), min_size=N, max_size=N),
       assign=st.lists(st.integers(0, 3), min_size=N, max_size=N),
       adj=st.lists(_row, min_size=N, max_size=N),
       slots=st.lists(st.tuples(st.integers(0, 3), _vertex, _row, _vertex),
                      min_size=W, max_size=W))
def test_prep_chains_match_on_few_vertex_windows(present, assign, adj,
                                                 slots):
    """Few vertices, so a vertex is added, edge-deleted from both ends,
    deleted and added again within one window; a DEL_EDGE's neighbour is
    drawn from the same few (self-loops) or -1."""
    state = init_state(N, D, 4, 2, seed=0, device="cpu")
    state.present.copy_(torch.tensor(present))
    state.assignment.copy_(torch.tensor(assign, dtype=torch.int32))
    state.adj.copy_(torch.tensor(adj, dtype=torch.int32))
    rows = np.array([r for _, _, r, _ in slots], np.int32)
    ets = np.array([e for e, _, _, _ in slots], np.int32)
    rows[:, 0] = np.where(ets == 2, [u for *_, u in slots], rows[:, 0])
    _assert_prep_equal(state, torch.from_numpy(ets),
                       torch.tensor([v for _, v, _, _ in slots],
                                    dtype=torch.int32),
                       torch.from_numpy(rows))

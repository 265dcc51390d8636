"""The bag backward's order and pass on the CPU against the JAX package: the
order's plain counterpart (``backward_order_ref``: int32 CSR offsets over
V + 1 rows, each row's run of flat positions, each bag's count of valid
slots) and a host model of the card's pass over it — every row written
once, zeros where the run is empty, a run of at most 32 positions sorted
first (the card places them in no fixed order), the adds in ascending
position order from +0.0 — held bit for bit to ``jax.vjp`` of JAX's
``bag_lookup``, and the CSR arrays of a small hand case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import bag_lookup as jbag_lookup
from repro_torch.kernels.embedding_bag.embedding_bag import (
    backward_order, embedding_bag_backward,
)
from repro_torch.kernels.embedding_bag.ref import backward_order_ref
from test_torch_engine import release_jax_executables  # noqa: F401

SHORT_RUN = 32             # the pass sorts runs of at most this many slots


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _case(v, d, b, l, kind, seed):
    """(idx, g): ids in [-1, V): ``random``; ``dup`` (one id a bag);
    ``padded`` (half the bags all -1, a quarter of the rest's slots);
    ``hot`` (ids from 3 rows: runs of hundreds); ``last`` (ids from the
    last 3 rows, V - 1 among them); ``allpad`` (every slot -1). A bag
    gradient whose magnitudes span e^±9, with -0.0 entries."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    if kind == "dup":
        idx[:] = rng.integers(0, v, (b, 1))
    elif kind == "padded":
        idx[::2] = -1
        idx[1::2] = np.where(rng.random((len(idx[1::2]), l)) < 0.25, -1,
                             idx[1::2])
    elif kind == "hot":
        idx = rng.integers(0, min(v, 3), (b, l)).astype(np.int32)
    elif kind == "last":
        idx = rng.integers(max(v - 3, 0), v, (b, l)).astype(np.int32)
    elif kind == "allpad":
        idx[:] = -1
    idx[0, 0] = -1
    g = (rng.standard_normal((b, d))
         * np.exp(rng.uniform(-9, 9, (b, 1)))).astype(np.float32)
    g[rng.random((b, d)) < 0.05] = -0.0
    return idx, g


def _scramble(order, seed):
    """The order as the card's placement may leave it: every run of at most
    SHORT_RUN positions permuted at random (longer runs stay ascending:
    the card sorts them before the pass)."""
    off = order.offsets.numpy()
    perm = order.perm.numpy().copy()
    rng = np.random.default_rng(seed)
    for r in range(len(off) - 1):
        a, b = off[r], off[r + 1]
        if b - a <= SHORT_RUN:
            perm[a:b] = rng.permutation(perm[a:b])
    return order._replace(perm=torch.from_numpy(perm))


def pass_model(g, order, v, l, mode):
    """The card's pass on the host, in numpy f32: row r's run sorted when
    it is short, its slots' bag gradients (divided by the bag's count for
    ``mean``) added in ascending position order into a sum from +0.0; an
    empty run gives a row of +0.0. All rows advance one slot a step."""
    off = order.offsets.numpy().astype(np.int64)
    perm = order.perm.numpy().copy()
    cnt = np.maximum(order.counts.numpy(), 1).astype(np.float32)
    lens = np.diff(off)
    for r in np.flatnonzero((lens > 1) & (lens <= SHORT_RUN)):
        perm[off[r]:off[r + 1]] = np.sort(perm[off[r]:off[r + 1]])
    out = np.zeros((v, g.shape[1]), np.float32)
    for j in range(int(lens.max(initial=0))):
        rows = np.flatnonzero(lens > j)
        bags = perm[off[rows] + j] // l
        x = g[bags]
        if mode == "mean":
            x = x / cnt[bags][:, None]
        out[rows] = out[rows] + x
    return out


# (V, D, B, L): V = 1, a few rows, ragged widths, a row width of 256
SHAPES = [(1, 4, 5, 3), (2, 16, 9, 1), (7, 130, 40, 8), (64, 24, 33, 5),
          (300, 256, 200, 37)]


@pytest.mark.parametrize("kind", ["random", "dup", "padded", "hot", "last",
                                  "allpad"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", SHAPES)
def test_order_and_pass_model_bit_equal_to_jax_vjp(v, d, b, l, mode, kind):
    """The plain order walked by the pass model — as the plain order gives
    it and with its short runs scrambled as the card's placement may leave
    them — equals jax.vjp of JAX's bag_lookup bit for bit (-0.0 and +0.0
    told apart); and so does the wrapper on CPU tensors."""
    idx, g = _case(v, d, b, l, kind, seed=v * 1000 + b + l)
    table = np.random.default_rng(v).standard_normal((v, d)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda t: jbag_lookup(t, jnp.asarray(idx), mode),
                     jnp.asarray(table))
    want = _bits(vjp(jnp.asarray(g))[0])
    tidx = torch.from_numpy(idx)
    order = backward_order(tidx, v)          # CPU: the plain order
    for o in (order, _scramble(order, seed=b)):
        np.testing.assert_array_equal(_bits(pass_model(g, o, v, l, mode)),
                                      want)
    got = embedding_bag_backward(torch.from_numpy(g), tidx, v, mode=mode)
    np.testing.assert_array_equal(_bits(got), want)


@pytest.mark.parametrize("kind", ["random", "dup", "padded", "hot", "last",
                                  "allpad"])
@pytest.mark.parametrize("v,d,b,l", SHAPES)
def test_order_is_a_stable_csr(v, d, b, l, kind):
    """Offsets are the exclusive prefix sums of the per-row counts of valid
    slots (V + 1 entries, the last the number of valid slots), each run is
    its row's positions in ascending order, counts are each bag's valid
    slots; all int32."""
    idx, _ = _case(v, d, b, l, kind, seed=3 * v + l)
    order = backward_order_ref(torch.from_numpy(idx), v)
    assert all(x.dtype == torch.int32 for x in order)
    flat = idx.reshape(-1)
    valid = flat >= 0
    off = order.offsets.numpy()
    assert off.shape == (v + 1,) and off[0] == 0 and off[-1] == valid.sum()
    np.testing.assert_array_equal(
        np.diff(off), np.bincount(flat[valid], minlength=v))
    perm = order.perm.numpy()
    assert perm.shape == (b * l,)
    for r in range(v):
        np.testing.assert_array_equal(perm[off[r]:off[r + 1]],
                                      np.flatnonzero(flat == r))
    np.testing.assert_array_equal(order.counts.numpy(),
                                  (idx >= 0).sum(axis=1))


def test_order_hand_case():
    """Bags [[2, -1, 0], [0, 2, 2], [-1, -1, -1]] over V = 4: row 0 at
    positions 2 and 3, row 1 none, row 2 at 0, 4 and 5, row 3 (V - 1)
    none; the -1 slots in no run."""
    idx = torch.tensor([[2, -1, 0], [0, 2, 2], [-1, -1, -1]],
                       dtype=torch.int32)
    order = backward_order(idx, 4)
    assert order.offsets.tolist() == [0, 2, 2, 5, 5]
    assert order.perm[:5].tolist() == [2, 3, 0, 4, 5]
    assert order.counts.tolist() == [2, 3, 0]
    g = torch.tensor([[1.0, -0.0], [2.0, 3.0], [5.0, 7.0]])
    f = np.float32
    half, third = g[0].numpy() / f(2), g[1].numpy() / f(3)
    want = np.zeros((4, 2), np.float32)
    want[0] = f(0) + half + third
    want[2] = f(0) + half + third + third
    model = pass_model(g.numpy(), order, 4, 3, "mean")
    np.testing.assert_array_equal(_bits(model), _bits(want))
    assert _bits(model)[1].tolist() == [0, 0]       # +0.0, written

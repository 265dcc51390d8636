"""The port's int8 gradient compression (``repro_torch.optim.compression``)
against the JAX package's (``repro.optim.compression``) on the CPU.

``int8_compress`` / ``int8_decompress`` bit for bit on eager JAX;
``compressed_allreduce_grads`` at one rank against JAX's ``shard_map``
on the one-device mesh, and at four ranks against JAX's over four forced
host devices in a child process. JAX's CPU ``psum`` sums the ranks' f32
scales in rank order (checked on 2,000 random 4-tuples while porting),
as the port does, so against ``shard_map`` called eagerly (as
tests/test_optim_checkpoint.py calls it) every output is held bit for
bit. Under ``jax.jit`` XLA contracts the residual ``gf - q * scale`` into
one fused multiply-add, where the port (and eager JAX) rounds the product
first: there the means and ``q`` stay bit-equal and the residual is held
within ``ULP_BOUND``, half an f32 ulp of ``q * scale`` (the one rounding
the two forms differ by). The error-feedback check keeps the JAX test's
own rtol 0.1."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.optim import compression as JC
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import (
    compressed_allreduce_grads, init_error_feedback, int8_compress,
    int8_decompress,
)
from test_torch_engine import release_jax_executables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"w": (64,), "big": (4099,), "blk": {"a": (3, 5), "b": (7, 2, 3)}}


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A seeded gradient tree: normal draws times a per-leaf magnitude,
    one leaf with exact halves (the rounding's ties) and one all zero."""
    rs = np.random.default_rng(seed)

    def leaf(shape):
        return (rs.standard_normal(shape)
                * 10.0 ** rs.integers(-4, 3) * scale).astype(np.float32)

    out = {k: leaf(v) for k, v in SHAPES.items() if k != "blk"}
    out["blk"] = {k: leaf(v) for k, v in SHAPES["blk"].items()}
    out["w"][:8] = np.float32(127.0) * np.float32(
        [0.5, 1.5, -2.5, 3.5, 1.0, -1.0, 0.0, 126.5]) / np.float32(127.0)
    out["blk"]["a"][:] = 0.0
    return out


def _to_t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _eq(want, got):
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        w = np.asarray(w)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("seed", range(4))
def test_int8_compress_and_decompress_match_jax(seed):
    for x in jax.tree.leaves(_tree(seed)):
        qj, sj = JC.int8_compress(jnp.asarray(x))
        qt, st = int8_compress(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        np.testing.assert_array_equal(
            np.asarray(JC.int8_decompress(qj, sj)),
            int8_decompress(qt, st).numpy())


def ulp_bound(grads, err):
    """Half an f32 ulp of each element's ``q * scale`` (the product the
    fused form does not round), from the port's own ``q`` and scale."""
    def one(g, e):
        q, scale = int8_compress(g.to(torch.float32) + e)
        prod = int8_decompress(q, scale).abs()
        return (torch.nextafter(prod, torch.full_like(prod, np.inf))
                - prod) / 2
    return jax.tree.map(one, grads, err)


def _within(want, got, bound):
    for w, g, b in zip(*(jax.tree.leaves(jax.tree.map(np.asarray, t))
                         for t in (want, got, bound))):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert (np.abs(w - g) <= b).all(), np.abs(w - g).max()


def _jax_one_rank(g, err, jit=False):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    f = jax.shard_map(
        lambda gg, ee: JC.compressed_allreduce_grads(gg, ee, "dp"),
        mesh=mesh, in_specs=(JP(), JP()), out_specs=(JP(), JP()))
    return (jax.jit(f) if jit else f)(g, err)


def test_one_rank_allreduce_matches_jax_shard_map():
    """Two rounds with the error carried, at one rank, bit for bit against
    eager ``shard_map``; one round against the jitted one (residual within
    ``ulp_bound``)."""
    mesh = make_mesh((1,), ("dp",), devices=["cpu"])
    jerr = JC.init_error_feedback(_tree(0))
    terr = init_error_feedback(_to_t(_tree(0)))
    _eq(jerr, terr)
    for r in range(2):
        g = _tree(10 + r)
        jmean, jerr = _jax_one_rank(jax.tree.map(jnp.asarray, g), jerr)
        ((tmean, terr2),) = compressed_allreduce_grads([_to_t(g)], [terr],
                                                       mesh, "dp")
        _eq(jmean, tmean)
        _eq(jerr, terr2)
        kmean, kerr = _jax_one_rank(jax.tree.map(jnp.asarray, g),
                                    jax.tree.map(lambda t: jnp.asarray(
                                        t.numpy()), terr), jit=True)
        _eq(kmean, tmean)
        _within(kerr, terr2, ulp_bound(_to_t(g), terr))
        terr = terr2


def test_error_feedback_unbiased_over_time():
    """JAX's check (tests/test_optim_checkpoint.py): 16 rounds of a
    constant 0.01 gradient, the mean within rtol 0.1, at 1 and 4 ranks."""
    for ranks in (1, 4):
        mesh = make_mesh((ranks,), ("dp",), devices=["cpu"] * ranks)
        g = {"w": torch.full((64,), 0.01)}
        err = [init_error_feedback(g) for _ in range(ranks)]
        total = torch.zeros(64)
        for _ in range(16):
            out = compressed_allreduce_grads([g] * ranks, err, mesh, "dp")
            err = [e for _, e in out]
            total = total + out[0][0]["w"]
            for m, _ in out[1:]:
                assert torch.equal(m["w"], out[0][0]["w"])
        np.testing.assert_allclose((total / 16).numpy(), 0.01, rtol=0.1)


FOUR_RANKS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compression import (compressed_allreduce_grads,
                                     init_error_feedback)
sys.path.insert(0, {tests!r})
from test_torch_compression import ROUNDS, _rank_tree
mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))

def body(g, e):
    sq = lambda t: jax.tree.map(lambda x: x[0], t)
    m, ne = compressed_allreduce_grads(sq(g), sq(e), "dp")
    ex = lambda t: jax.tree.map(lambda x: x[None], t)
    return ex(m), ex(ne)

f = jax.shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                  out_specs=(P("dp"), P("dp")))
stack = lambda ts: jax.tree.map(lambda *xs: jnp.stack(xs), *ts)
err0 = stack([init_error_feedback(_rank_tree(0, r)) for r in range(4)])
out = {{}}
for tag, fn, rounds in (("", f, ROUNDS), ("jit_", jax.jit(f), 1)):
    err = err0
    for i in range(rounds):
        mean, err = fn(stack([_rank_tree(i, r) for r in range(4)]), err)
        for j, (m, e) in enumerate(zip(jax.tree.leaves(mean),
                                       jax.tree.leaves(err))):
            out[f"{{tag}}m{{i}}_{{j}}"] = np.asarray(m)
            out[f"{{tag}}e{{i}}_{{j}}"] = np.asarray(e)
np.savez({path!r}, **out)
"""
ROUNDS = 2


def _rank_tree(round_: int, rank: int) -> dict:
    """Rank ``rank``'s gradients in round ``round_``: its own draws, one
    rank an order of magnitude larger (the scales differ)."""
    return _tree(100 * round_ + rank, 10.0 if rank == 2 else 1.0)


def test_four_rank_allreduce_matches_jax_over_four_devices(tmp_path):
    path = str(tmp_path / "jax.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    code = FOUR_RANKS.format(tests=os.path.join(REPO, "tests"), path=path)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    want = np.load(path)
    mesh = make_mesh((4,), ("dp",), devices=["cpu"] * 4)
    err = [init_error_feedback(_to_t(_rank_tree(0, r))) for r in range(4)]
    for i in range(ROUNDS):
        grads = [_to_t(_rank_tree(i, r)) for r in range(4)]
        res = compressed_allreduce_grads(grads, err, mesh, "dp")
        for r, (m, e) in enumerate(res):
            bound = jax.tree.leaves(ulp_bound(grads[r], err[r]))
            for j, (ml, el) in enumerate(zip(jax.tree.leaves(
                    jax.tree.map(lambda t: t.numpy(), m)), jax.tree.leaves(
                    jax.tree.map(lambda t: t.numpy(), e)))):
                np.testing.assert_array_equal(want[f"m{i}_{j}"][r], ml)
                np.testing.assert_array_equal(want[f"e{i}_{j}"][r], el)
                if i == 0:
                    np.testing.assert_array_equal(want[f"jit_m0_{j}"][r], ml)
                    assert (np.abs(want[f"jit_e0_{j}"][r] - el)
                            <= bound[j].numpy()).all()
        err = [e for _, e in res]


def test_a_leaf_off_its_ranks_device_raises():
    mesh = make_mesh((2,), ("dp",), devices=["meta"] * 2)
    g = _to_t(_tree(0))
    with pytest.raises(ValueError, match="rank 0 of mesh axis 'dp'"):
        compressed_allreduce_grads([g, g], [g, g], mesh, "dp")
    with pytest.raises(ValueError, match="2 ranks"):
        compressed_allreduce_grads([g], [g], mesh, "dp")

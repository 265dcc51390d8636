"""The port's blocked GNN layout against the JAX package on the CPU:
``build_halo_spec``'s arrays byte for byte (random assignments with an
empty shard, P = 1, and the SDP and hash sessions' assignments of a
mesh graph, from the port's own ``Partitioner``), ``scatter_nodes`` /
``gather_nodes``, ``halo_aggregate`` over the stacked blocks against
JAX's ``naive_aggregate`` (and bit for bit against the port's, its sums
being order-free), SDP publishing fewer rows than hash, and the
fanout sampler's subgraphs and minibatches byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph import halo as jhalo
from repro.graph import sampler as jsampler
from repro.graph.generators import make_graph as jmake_graph
from repro.runtime.gnn_sharded import naive_aggregate as jnaive_aggregate
from repro_torch.api import Partitioner
from repro_torch.core.config import EngineConfig
from repro_torch.graph import halo, sampler
from repro_torch.graph import stream as gstream
from repro_torch.graph.generators import make_graph
from repro_torch.runtime.gnn_sharded import halo_aggregate, naive_aggregate

SPEC_ARRAYS = ("perm", "block_of", "publish_idx", "halo_map", "senders",
               "receivers")


def assert_specs_equal(got, want):
    for f in SPEC_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (got.block_size, got.n_shards) == (want.block_size, want.n_shards)
    assert (got.halo_size, got.publish_size) == (want.halo_size,
                                                  want.publish_size)
    for f in (1, 128):
        assert got.collective_bytes_per_layer(f) == \
            want.collective_bytes_per_layer(f)


def session_assignment(g, policy: str, p: int) -> np.ndarray:
    """A CPU session of ``g``'s stream at k = p, as
    examples/train_gnn_partitioned.py builds its layout."""
    s = gstream.build_stream(g, seed=0)
    cfg = EngineConfig(k_max=p, k_init=p, autoscale=False)
    part = Partitioner.from_stream(s, cfg, policy=policy,
                                   device="cpu").feed(s)
    a = part.state.assignment.numpy().copy()
    a[a < 0] = 0
    return a


CASES = [("mesh", 96, 260, 4), ("mesh", 400, 1100, 8),
         ("communication", 300, 900, 3), ("mesh", 50, 120, 1),
         ("uniform", 200, 10, 5), ("social", 2000, 9000, 16)]


@pytest.mark.parametrize("family,n,m,p", CASES)
def test_halo_spec_matches_jax_byte_for_byte(family, n, m, p):
    g, jg = make_graph(family, n, m, seed=0), jmake_graph(family, n, m,
                                                         seed=0)
    a = np.random.default_rng(p).integers(0, p, g.n)
    if p > 2:
        a[a == p - 1] = 0                    # an empty shard
    assert_specs_equal(halo.build_halo_spec(g, a, p),
                       jhalo.build_halo_spec(jg, a, p))


@pytest.fixture(scope="module")
def mesh_layouts():
    g, jg = make_graph("mesh", 400, 1100, seed=1), jmake_graph("mesh", 400,
                                                              1100, seed=1)
    return g, jg, {pol: session_assignment(g, pol, 4)
                   for pol in ("sdp", "hash")}


def test_session_layouts_match_jax_and_sdp_publishes_less(mesh_layouts):
    g, jg, assign = mesh_layouts
    pub = {}
    for pol, a in assign.items():
        spec = halo.build_halo_spec(g, a, 4)
        assert_specs_equal(spec, jhalo.build_halo_spec(jg, a, 4))
        pub[pol] = int((spec.publish_idx >= 0).sum())
    # tests/test_distribution.py's direction, on the port's sessions
    assert pub["sdp"] < 0.8 * pub["hash"], pub


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_scatter_gather_and_halo_aggregate_match_jax(p):
    g, jg = make_graph("mesh", 150, 400, seed=3), jmake_graph("mesh", 150,
                                                             400, seed=3)
    a = np.random.default_rng(10 + p).integers(0, p, g.n)
    spec = halo.build_halo_spec(g, a, p)
    jspec = jhalo.build_halo_spec(jg, a, p)
    x = np.random.default_rng(p).standard_normal((g.n, 6)).astype(np.float32)
    blocks = halo.scatter_nodes(spec, x)
    np.testing.assert_array_equal(blocks, jhalo.scatter_nodes(jspec, x))
    np.testing.assert_array_equal(
        halo.scatter_nodes(spec, x, fill=-2.0),
        jhalo.scatter_nodes(jspec, x, fill=-2.0))
    np.testing.assert_array_equal(halo.gather_nodes(spec, blocks), x)
    out = halo_aggregate(
        torch.from_numpy(blocks),
        *(torch.from_numpy(t) for t in (spec.publish_idx, spec.halo_map,
                                        spec.senders, spec.receivers)),
        block_size=spec.block_size)
    assert out.shape == blocks.shape
    e = g.edge_array()
    snd = np.concatenate([e[:, 0], e[:, 1]]).astype(np.int32)
    rcv = np.concatenate([e[:, 1], e[:, 0]]).astype(np.int32)
    want = np.asarray(jnaive_aggregate(jnp.asarray(x), jnp.asarray(snd),
                                       jnp.asarray(rcv)))
    np.testing.assert_allclose(halo.gather_nodes(spec, out.numpy()), want,
                               rtol=1e-5, atol=1e-5)
    got = naive_aggregate(torch.from_numpy(x), torch.from_numpy(snd),
                          torch.from_numpy(rcv))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the sums accumulate in f64 and round once, so the blocked layout's
    # edge order gives the unblocked one's bits
    np.testing.assert_array_equal(halo.gather_nodes(spec, out.numpy()),
                                  got.numpy())
    # pad rows of the blocks aggregate nothing
    pad = np.ones(blocks.shape[:2], bool)
    pad[spec.block_of, spec.perm] = False
    assert not out.numpy()[pad].any()


@pytest.mark.parametrize("fanouts", [(3, 2), (15, 10), (4,)])
def test_sampler_matches_jax(fanouts):
    g, jg = make_graph("social", 500, 2000, seed=4), jmake_graph(
        "social", 500, 2000, seed=4)
    seeds = np.random.default_rng(0).integers(0, g.n, 16)
    seeds[3] = -1                            # a padded seed samples nothing
    got = sampler.sample_subgraph(g, seeds, fanouts,
                                  np.random.default_rng(7))
    want = jsampler.sample_subgraph(jg, seeds, fanouts,
                                    np.random.default_rng(7))
    for f in ("node_ids", "senders", "receivers"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.seed_count == want.seed_count == 16
    assert (got.num_nodes, got.senders.shape[0]) == \
        sampler.subgraph_sizes(16, fanouts) == \
        jsampler.subgraph_sizes(16, fanouts)
    b1 = sampler.make_minibatch(g, 8, 16, fanouts, seed=2, out_dim=2)
    b2 = jsampler.make_minibatch(jg, 8, 16, fanouts, seed=2, out_dim=2)
    assert sorted(b1) == sorted(b2)
    for k in b2:
        assert b1[k].dtype == b2[k].dtype, k
        np.testing.assert_array_equal(b1[k], b2[k])

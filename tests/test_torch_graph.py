"""The port's numpy graph substrate (repro_torch.graph) builds byte-identical
graphs and streams to the JAX package's for the same seed."""
import numpy as np
import pytest

from repro.graph import csr as jcsr
from repro.graph import datasets as jds
from repro.graph import generators as jgen
from repro.graph import stream as jstream
from repro_torch.graph import csr as tcsr
from repro_torch.graph import datasets as tds
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream


def _same_graph(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.indices.dtype == b.indices.dtype


def _same_stream(a, b):
    for f in ("etype", "vertex", "nbrs"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (a.n, a.intervals, a.truncated_nbrs) == \
        (b.n, b.intervals, b.truncated_nbrs)


@pytest.mark.parametrize("name,scale", [("3elt", 0.05), ("grqc", 0.05),
                                        ("twitter", 0.01),
                                        ("email-enron", 0.01)])
def test_datasets_identical(name, scale):
    _same_graph(jds.load_dataset(name, scale=scale),
                tds.load_dataset(name, scale=scale))


def test_uniform_family_and_cap_degree_identical():
    _same_graph(jgen.make_graph("uniform", 300, 900, seed=2),
                tgen.make_graph("uniform", 300, 900, seed=2))
    g_j = jds.load_dataset("twitter", scale=0.01)
    g_t = tds.load_dataset("twitter", scale=0.01)
    _same_graph(jcsr.cap_degree(g_j, 20, seed=1), tcsr.cap_degree(g_t, 20, seed=1))


@pytest.mark.parametrize("kw", [
    dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0),
    dict(warmup_frac=0.15, del_every=2, edge_del_every=4, readd_every=6, seed=7),
    dict(warmup_frac=0.5, del_every=0, max_deg=6, seed=1),
])
def test_interleaved_churn_identical(kw):
    g_j = jgen.make_graph("social", 200, 700, seed=0)
    g_t = tgen.make_graph("social", 200, 700, seed=0)
    _same_stream(jstream.interleaved_churn(g_j, **kw),
                 tstream.interleaved_churn(g_t, **kw))


def test_build_stream_and_geometry_helpers():
    g_j = jds.load_dataset("grqc", scale=0.05)
    g_t = tds.load_dataset("grqc", scale=0.05)
    s_j = jstream.build_stream(g_j, max_deg=8, seed=3)
    s_t = tstream.build_stream(g_t, max_deg=8, seed=3)
    _same_stream(s_j, s_t)
    assert tuple(s_t.required_geometry()) == tuple(s_j.required_geometry())
    np.testing.assert_array_equal(jstream.normalize_rows(s_j.nbrs, 12),
                                  tstream.normalize_rows(s_t.nbrs, 12))
    with pytest.raises(ValueError, match="grow the target geometry"):
        tstream.normalize_rows(s_t.nbrs, 2)

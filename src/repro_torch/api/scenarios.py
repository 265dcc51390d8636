"""The long-lived session's scenarios, with the JAX package's digests of
their final states pinned.

* **fig16's quality lanes** (the JAX package's
  ``benchmarks/fig16_quality.py``): three adversarial streams fed interval
  by interval, with and without ``rebalance(m, passes=2)`` after every
  interval.
* **the lifecycle**: a churn session that bulk-deletes down to an eighth
  of its vertices with ``auto_shrink`` on, compacts, snapshots, restores
  into a second session, and feeds the same tail (ADDs over original ids,
  DELs) to both.

The drivers take the session class as an argument, so the CPU tests run
the same code with the JAX package's ``Partitioner`` and check the pinned
digests; ``chip_smoke.py`` runs it with the port's on the card and checks
its states against the same digests.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.graph import stream as gstream
from repro_torch.graph.csr import Graph, cap_degree
from repro_torch.graph.datasets import load_dataset
from repro_torch.graph.stream import EVENT_ADD, EVENT_DEL_VERTEX, VertexStream

# fig16: partitions, wiki-vote's scale and degree cap, community block,
# rebalance budget — quick and full, as the benchmark sets them
FIG16_K = 4
FIG16_PASSES = 2
FIG16_SCALE = {True: 0.15, False: 1.0}
FIG16_BLOCK = {True: 200, False: 600}
FIG16_M = {True: 32, False: 128}
DEG_CAP = 192
# the JAX package's final states of fig16's six full-scale lanes (sha256
# over the leaves in field order; see tests/test_torch_rebalance.py)
FIG16_FULL_DIGESTS = {
    ("hub_arrivals", False):
        "c428626c7823b5733018896ed50238da91ceb52d5b73ffa14184164aeb4db11b",
    ("hub_arrivals", True):
        "b51dde1c6e0f79814f66a5533d2d68021d83a64f99bd76616fcd364cb23b50d2",
    ("community_merge", False):
        "fdd26f4690b612c07bd96fb9716b918601f700bbc4e5bcc26818972b4176ef9b",
    ("community_merge", True):
        "93186ae4a8aa395ec365531f071b453e7e9493da6028a36ed1be8d6ab1302ba0",
    ("flash_crowd", False):
        "2e2ea53944969f679c559ca8a7371b136f145b6f9aa4f7c421d2b95a76acbb36",
    ("flash_crowd", True):
        "89f4b98d2af2aae1875c24b2088578c8a0cbe8d6847229c2bd3a5362fe9667dc",
}
# the smoke run's twitter session (scale 1.0, the churn stream below,
# LIFECYCLE_CFG["twitter"], window 256) and the same state after
# rebalance(m=128, passes=2): the JAX package's, from
# ``python tests/test_torch_rebalance.py`` (~5 min of JAX on a CPU)
TWITTER_SESSION_DIGEST = (
    "ee5e42a3670aedde660526a82462ae0c07e54bb88b576390e5a1413d660a6d93")
TWITTER_REBALANCE_DIGEST = (
    "642e5a66f293bb3561e850b40d13e2d27c947c163b2c3bddc1ef7a604614f943")
# the lifecycle on grqc at scale 1.0: the JAX package's final state
GRQC_LIFECYCLE_DIGEST = (
    "bdbbe872f7d82b58dd0b3059238fcc370dc3f83c1eb115f7497aeda3366bd8a5")
# the lifecycle's churn stream (the smoke run's session stream) and sizes
CHURN_ARGS = dict(warmup_frac=0.2, del_every=3, edge_del_every=5, seed=0)
LIFECYCLE_CFG = {"grqc": dict(k_max=16, k_init=1, max_cap=1500,
                              autoscale=True),
                 "twitter": dict(k_max=16, k_init=1, max_cap=40000,
                                 autoscale=True)}
LIFECYCLE_DEL_CHUNK = 4096
LIFECYCLE_SHRINK_EVERY = 8192


def fig16_cfg() -> EngineConfig:
    """``benchmarks.common.default_cfg(k=4)``."""
    return EngineConfig(k_max=16, k_init=FIG16_K, max_cap=1 << 30,
                        autoscale=False)


def fig16_streams(quick: bool) -> list[tuple[str, VertexStream]]:
    """fig16's three streams: hub arrivals with a tenth of the warm-up
    leaving, two communities bridged mid-stream, a flash crowd of an
    eighth of the graph — on wiki-vote, degree-capped at 192."""
    g = cap_degree(load_dataset("wiki-vote", scale=FIG16_SCALE[quick]),
                   DEG_CAP)
    crowd = max(g.n // 8, 16)
    return [
        ("hub_arrivals", gstream.hub_arrivals(g, del_frac=0.1, seed=0)),
        ("community_merge", gstream.community_merge(
            block=FIG16_BLOCK[quick], seed=0)),
        ("flash_crowd", gstream.flash_crowd(g, crowd=crowd, seed=0)),
    ]


def checkpoints(s) -> list[int]:
    """The interval ends a lane stops at (and the stream's end)."""
    pts = sorted({int(c) for c in s.intervals} | {s.num_events})
    return [c for c in pts if c > 0]


def quality_lane(partitioner_cls, s, cfg, *, rebalance: bool, m: int,
                 passes: int = FIG16_PASSES, **kw):
    """Feed ``s`` interval by interval through a session of
    ``partitioner_cls`` (policy SDP, seed 0), running ``rebalance(m,
    passes)`` after every interval when ``rebalance``. Returns the session
    and one ``(cursor, cut ratio)`` row per interval."""
    part = partitioner_cls.from_stream(s, cfg, policy="sdp", seed=0, **kw)
    rows, prev = [], 0
    for cur in checkpoints(s):
        part.feed((s.etype[prev:cur], s.vertex[prev:cur], s.nbrs[prev:cur]))
        part.sync()
        prev = cur
        if rebalance:
            part.rebalance(m=m, passes=passes)
        rows.append((cur, part.metrics()["edge_cut_ratio"]))
    return part, rows


def present_after(s) -> np.ndarray:
    """Vertex ids present once every event of ``s`` has applied (an ADD
    makes a vertex present, a DEL_VERTEX absent)."""
    present = np.zeros(s.required_geometry().n, bool)
    for et, v in zip(s.etype, s.vertex):
        if et == EVENT_ADD:
            present[v] = True
        elif et == EVENT_DEL_VERTEX:
            present[v] = False
    return np.flatnonzero(present)


def lifecycle_stream(name: str, scale: float = 1.0):
    """``(graph, churn stream)`` of a dataset, degree-capped at 192 as the
    smoke run's sessions are."""
    g = cap_degree(load_dataset(name, scale=scale), DEG_CAP)
    return g, gstream.interleaved_churn(g, **CHURN_ARGS)


def lifecycle_plan(g: Graph, s: VertexStream, seed: int = 0):
    """The lifecycle's events after the stream ``s`` over graph ``g``:
    bulk DEL_VERTEX chunks that leave fewer than an eighth of the
    universe's vertices present, and a tail — ADDs of a fifth of the
    deleted vertices (original ids, rows from ``g`` less the edges the
    stream deleted) interleaved with DELs of a tenth of the survivors. Returns ``(survivors, del_chunks,
    tail)``, each chunk an ``(etype, vertex, nbrs)`` triple."""
    rng = np.random.default_rng(seed)
    present = present_after(s)
    # edges the stream deleted stay deleted: a re-add's row leaves them
    # out, or the adjacency would go one-sided
    de = s.etype == gstream.EVENT_DEL_EDGE
    dead = {(min(int(a), int(b)), max(int(a), int(b)))
            for a, b in zip(s.vertex[de], s.nbrs[de, 0])}
    n_keep = min(len(present), max(s.n // 8 - 1, 1))
    perm = rng.permutation(present)
    survivors, victims = np.sort(perm[:n_keep]), perm[n_keep:]
    width = s.max_deg
    none = np.full((LIFECYCLE_DEL_CHUNK, 1), -1, np.int32)
    dels = []
    for a in range(0, len(victims), LIFECYCLE_DEL_CHUNK):
        vx = victims[a:a + LIFECYCLE_DEL_CHUNK].astype(np.int32)
        dels.append((np.full(len(vx), EVENT_DEL_VERTEX, np.int32), vx,
                     none[:len(vx)]))
    back = victims[:len(victims) // 5]
    gone = rng.choice(survivors, len(survivors) // 10, replace=False)
    ev = [(EVENT_ADD, int(v)) for v in back] + \
        [(EVENT_DEL_VERTEX, int(v)) for v in gone]
    order = rng.permutation(len(ev))
    et = np.asarray([ev[i][0] for i in order], np.int32)
    vx = np.asarray([ev[i][1] for i in order], np.int32)
    nb = np.full((len(ev), width), -1, np.int32)
    for i, (e, v) in enumerate(zip(et, vx)):
        if e == EVENT_ADD:
            v = int(v)
            row = [int(u) for u in g.neighbors(v)
                   if (min(u, v), max(u, v)) not in dead][:width]
            nb[i, :len(row)] = row
    return survivors, dels, (et, vx, nb)


def run_lifecycle(partitioner_cls, g: Graph, s: VertexStream, cfg,
                  directory: str, probe=None, **kw):
    """The lifecycle over ``s`` (see module docstring) with sessions of
    ``partitioner_cls``: feed ``s``, bulk-delete (``auto_shrink``),
    ``compact()``, check the id map on every survivor, ``snapshot()``
    without blocking and ``wait()``, restore into a second session, feed
    the tail to both. ``probe(stage, session)``, when given, is called
    after each stage ("fed", "deleted", "compacted", "checked",
    "snapshotted", "restored", "done"). Returns ``(original, restored,
    survivors)``."""
    probe = probe or (lambda stage, session: None)
    survivors, dels, tail = lifecycle_plan(g, s)
    kw = dict(policy="sdp", auto_shrink=True,
              shrink_every=LIFECYCLE_SHRINK_EVERY, **kw)
    part = partitioner_cls.from_stream(s, cfg, seed=0, **kw)
    part.feed((s.etype, s.vertex, s.nbrs))
    probe("fed", part)
    for chunk in dels:
        part.feed(chunk)
    probe("deleted", part)
    part.compact()
    probe("compacted", part)
    check_id_map(part, survivors)
    probe("checked", part)
    part.snapshot(directory, blocking=False)
    part.wait()
    probe("snapshotted", part)
    restored = partitioner_cls.restore(directory, cfg, **kw)
    probe("restored", restored)
    part.feed(tail)
    restored.feed(tail)
    probe("done", restored)
    return part, restored, survivors


def check_id_map(part, survivors: np.ndarray) -> None:
    """Every survivor maps to a distinct present internal slot and back."""
    inner = part.to_internal(survivors)
    present = np.asarray(_host(part.state.present))
    if (inner < 0).any() or len(np.unique(inner)) != len(inner) \
            or not present[inner].all():
        raise AssertionError("a survivor lost its slot in the compaction")
    back = part.to_external(inner)
    if not np.array_equal(back, survivors):
        raise AssertionError("to_external(to_internal(id)) != id")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def state_digest(state) -> str:
    """SHA-256 over every leaf's bytes in field order — equal for equal
    states of either package (the key as its two uint32 words)."""
    h = hashlib.sha256()
    for leaf in state:
        h.update(_host(leaf).tobytes())
    return h.hexdigest()

"""The port's ``FaultTolerantLoop`` and ``ElasticRunner``
(``repro_torch.runtime.fault`` / ``.elastic``) against the JAX package's on
the same step sequences (``tests/test_fault_elastic.py``): the poisoned
batch restored and skipped, the retry budget, the straggler hook (driven by
an oracle), the pre-rescale save that ignores the interval, and the
4 → 2 → 4 round trip, bitwise, on meshes of CPU row blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.runtime.fault import FaultTolerantLoop as JLoop
from repro_torch.api import Partitioner
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import windowed as twnd
from repro_torch.core.config import EngineConfig
from repro_torch.core.sharded_state import shard_state, unshard_state
from repro_torch.graph import generators as tgen
from repro_torch.graph import stream as tstream
from repro_torch.launch.mesh import (
    Mesh, Placement, RowBlocks, make_vertices_mesh, tree_map,
)
from repro_torch.runtime.elastic import ElasticRunner
from repro_torch.runtime.fault import FaultTolerantLoop
from repro_torch.runtime.shard_session import sharded_window
from test_torch_engine import release_jax_executables  # noqa: F401


def _events(loop):
    """A loop's events without the wall times the straggler events carry."""
    return [{k: v for k, v in e.items() if k != "t"} for e in loop.events]


@pytest.mark.parametrize("poison_at", [0, 2, 3])
def test_poisoned_batch_restores_and_skips(tmp_path, poison_at):
    """One poisoned batch: restore the checkpointed state, skip it; the
    surviving batches all land. Both loops: the same events, step and
    final state."""
    batches = [1.0, 2.0, 4.0, 8.0]
    batches.insert(poison_at, "poison")

    def step_fn(state, batch):
        if batch == "poison":
            raise RuntimeError("node failure")
        return {"w": state["w"] + batch}, {}

    loops = {}
    for name, mgr, zeros in (("jax", JManager, jnp.zeros(2)),
                             ("port", CheckpointManager, torch.zeros(2))):
        loop = (JLoop if name == "jax" else FaultTolerantLoop)(
            mgr(str(tmp_path / name), interval=1), max_retries=2)
        state = {"w": zeros}
        loops[name] = (loop, loop.run(state, iter(batches), step_fn,
                                      like=state))
    (lj, (sj, kj)), (lt, (st_, kt)) = loops["jax"], loops["port"]
    np.testing.assert_array_equal(np.asarray(sj["w"]), st_["w"].numpy())
    np.testing.assert_array_equal(st_["w"].numpy(), np.full(2, 15.0))
    assert kj == kt
    assert _events(lj) == _events(lt)
    assert [e["event"] for e in lt.events] == ["failure"]
    assert lj.retries == lt.retries == 0


def test_retry_budget_aborts_loudly(tmp_path):
    """A step that keeps failing aborts after max_retries, not spinning on
    restore-and-retry; both loops journal the same failures."""
    def step_fn(state, batch):
        raise RuntimeError("hard failure")

    runs = []
    for name, mgr, loop_t, zeros in (
            ("jax", JManager, JLoop, jnp.zeros(2)),
            ("port", CheckpointManager, FaultTolerantLoop, torch.zeros(2))):
        loop = loop_t(mgr(str(tmp_path / name), interval=1), max_retries=3)
        state = {"w": zeros}
        with pytest.raises(RuntimeError, match="hard failure"):
            loop.run(state, iter([1.0] * 10), step_fn, like=state)
        runs.append(loop)
    failures = [e for e in runs[1].events if e["event"] == "failure"]
    assert len(failures) == runs[1].max_retries + 1
    assert _events(runs[0]) == _events(runs[1])


def test_straggler_hook_fires_after_patience(tmp_path):
    """Consecutive slow steps past the patience fire on_straggler once and
    reset the streak (timing-free: an oracle says which steps are slow);
    both loops fire at the same steps and journal the same events."""
    def oracle(base):
        class Oracle(base):
            slow_steps = {2, 3, 5, 6, 7}

            def is_straggler(self, seconds):
                return self._now_step in self.slow_steps
        return Oracle

    results = []
    for name, mgr, loop_t, zeros in (
            ("jax", JManager, JLoop, jnp.zeros(1)),
            ("port", CheckpointManager, FaultTolerantLoop, torch.zeros(1))):
        m = oracle(mgr)(str(tmp_path / name), interval=10**9)
        fired = []
        loop = loop_t(m, straggler_patience=2, on_straggler=fired.append)

        def step_fn(state, batch, m=m):
            m._now_step = batch
            return state, {}

        _, step = loop.run({"w": zeros}, iter(range(9)), step_fn)
        results.append((fired, _events(loop), step))
    assert results[0] == results[1]
    fired, events, step = results[1]
    assert fired == [3, 6] and step == 9
    assert [e["step"] for e in events] == [2, 3, 5, 6, 7]


def test_loop_over_sharded_windows_skips_the_poisoned_one(tmp_path):
    """The loop over a vertex-sharded session's windows (3 CPU row blocks,
    a checkpoint a window): a poisoned window is restored and skipped, and
    the state equals the dense mixed-window engine fed the windows without
    it, at their own t0s."""
    g = tgen.make_graph("social", 80, 240, seed=0)
    s = tstream.interleaved_churn(g, warmup_frac=0.25, del_every=3, seed=1)
    w = 16
    cfg = EngineConfig(k_max=8, k_init=2, max_cap=90)
    n_win = s.num_events // w
    windows = [(i * w, *(torch.tensor(np.asarray(x)[i * w:(i + 1) * w])
                         for x in (s.etype, s.vertex, s.nbrs)))
               for i in range(n_win)]
    bad = n_win // 2
    batches = windows[:bad] + ["poison"] + windows[bad + 1:]

    def step_fn(state, batch):
        if isinstance(batch, str):
            raise RuntimeError("poisoned window")
        t0, et, vx, nb = batch
        return sharded_window(state, et, vx, nb, t0, n_sem=s.n,
                              policy="sdp", cfg=cfg), {}

    mesh = make_vertices_mesh(devices=["cpu"] * 3)
    start = Partitioner(cfg, n=s.n, max_deg=s.max_deg, device="cpu").state
    loop = FaultTolerantLoop(CheckpointManager(str(tmp_path), interval=1))
    got, step = loop.run(shard_state(start, mesh), batches, step_fn)
    assert isinstance(got.adj, RowBlocks) and step == n_win - 1
    assert [e["event"] for e in loop.events] == ["failure"]

    # the dense mixed-window engine on the same windows, at their own t0s
    want = Partitioner(cfg, n=s.n, max_deg=s.max_deg, device="cpu").state
    for t0, et, vx, nb in windows[:bad] + windows[bad + 1:]:
        want = twnd.run_window_mixed(want, et, vx, nb, t0, policy="sdp",
                                     cfg=cfg)
    got = unshard_state(got, n=s.n)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# -- ElasticRunner ---------------------------------------------------------

def _data_mesh(devices):
    return Mesh(tuple(torch.device(d) for d in devices), ("data", "model"),
                (len(devices), 1))


def _row_placements(mesh, tree):
    """Row blocks along "data" where the rows divide, else whole."""
    return tree_map(
        lambda x: Placement(mesh, "data" if np.ndim(x) >= 1
                            and np.shape(x)[0] % mesh.shape["data"] == 0
                            else None), tree)


def test_rescale_saves_unconditionally(tmp_path):
    """The pre-rescale migration save ignores the interval: with an
    interval far past the step, the checkpoint still lands before the mesh
    changes (a failed rescale can fall back to disk)."""
    def whole(mesh, tree):
        return tree_map(lambda x: Placement(mesh), tree)

    m = CheckpointManager(str(tmp_path), interval=10**9)
    runner = ElasticRunner(_data_mesh, whole, m)
    st0 = runner.place(["cpu"], {"w": torch.arange(4.0)},
                       {"mu": torch.zeros(4)}, step=7)
    assert m.latest() is None
    st1 = runner.rescale(st0, ["cpu"])
    assert m.latest() == 7              # save_now, not maybe_save
    np.testing.assert_array_equal(st1.params["w"].numpy(), np.arange(4.0))
    back = runner.recover(["cpu"] * 2, {"w": torch.zeros(4)},
                          {"mu": torch.ones(4)})
    assert back.step == 7 and torch.equal(back.params["w"],
                                          torch.arange(4.0))


# bit patterns that expose any lossy migration (denormals, -0.0, big ints)
BITS = np.asarray([1e-39, -0.0, 3.14159, 2.0**31, -7.5, 1e38, 0.0, -1e-45]
                  * 4, np.float32)


def test_rescale_round_trip_bitwise_4_2_4(tmp_path):
    params = {"w": torch.from_numpy(BITS.copy()),
              "odd": torch.from_numpy(BITS[:7].copy())}
    opt = {"mu": torch.from_numpy(BITS[::-1].copy()),
           "step": torch.tensor(3, dtype=torch.int64)}
    runner = ElasticRunner(_data_mesh, _row_placements,
                           CheckpointManager(str(tmp_path), interval=1))
    st0 = runner.place(["cpu"] * 4, params, opt, step=1)
    assert isinstance(st0.params["w"], RowBlocks)
    assert len(st0.params["w"].blocks) == 4
    assert isinstance(st0.params["odd"], torch.Tensor)   # 7 rows: whole
    st1 = runner.rescale(st0, ["cpu"] * 2)               # scale-in 4 -> 2
    assert len(st1.params["w"].blocks) == 2
    st2 = runner.rescale(st1, ["cpu"] * 4)               # scale-out 2 -> 4
    assert np.asarray(st2.params["w"]).tobytes() == BITS.tobytes()
    assert np.asarray(st2.params["odd"]).tobytes() == BITS[:7].tobytes()
    assert np.asarray(st2.opt_state["mu"]).tobytes() == \
        BITS[::-1].copy().tobytes()
    assert int(st2.opt_state["step"]) == 3
    assert st2.mesh.shape["data"] == 4
    # the restore path of a re-shard: the checkpoint placed under new
    # placements
    mgr = CheckpointManager(str(tmp_path), interval=1)
    like = {"opt": opt, "params": params}
    mesh2 = _data_mesh(["cpu"] * 2)
    tree, step = mgr.restore(like, shardings=_row_placements(mesh2, like))
    assert step == 1 and len(tree["params"]["w"].blocks) == 2
    assert np.asarray(tree["params"]["w"]).tobytes() == BITS.tobytes()


def test_rescale_a_sharded_partition_state(tmp_path):
    """A vertex-sharded session's state through 4 → 2 → 4 equals itself."""
    g = tgen.make_graph("social", 70, 200, seed=3)
    s = tstream.interleaved_churn(g, warmup_frac=0.25, del_every=3, seed=4)
    part = Partitioner(EngineConfig(k_max=8, k_init=2), sharded=True,
                       window=32, shard_devices=["cpu"] * 4).feed(s)
    want = unshard_state(part.state)

    def vertices_mesh(devices):
        return make_vertices_mesh(devices=devices)

    def placements(mesh, tree):
        return tree_map(lambda x: Placement(
            mesh, "vertices" if isinstance(x, RowBlocks) or (
                np.ndim(x) >= 1 and np.shape(x)[0] == want.adj.shape[0])
            else None), tree)

    runner = ElasticRunner(vertices_mesh, placements,
                           CheckpointManager(str(tmp_path), interval=1))
    st0 = runner.place(["cpu"] * 4, part.state, {}, step=s.num_events)
    st1 = runner.rescale(st0, ["cpu"] * 2)
    st2 = runner.rescale(st1, ["cpu"] * 4)
    assert len(st2.params.adj.blocks) == 4
    got = unshard_state(st2.params)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f

"""Card-only checks of the port's CUDA kernels against their plain PyTorch
versions, bit for bit (both kernels are exact). Marked ``gpu``: they skip
where there is no CUDA card, and run on one with

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
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.ops import _prepare_window
from repro_torch.kernels.fused_chooser.ref import fused_window_choose_ref
from repro_torch.kernels.partition_affinity.partition_affinity import (
    partition_affinity,
)
from repro_torch.kernels.partition_affinity.ref import partition_affinity_ref

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

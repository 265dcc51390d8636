"""The port's kernel-variant choices, pure functions of shape, dtype and
alignment that the CPU can check (the kernels themselves run only on the
card: tests/test_torch_gpu.py), and the slices they open against the JAX
package: a session at k_max = 200 — past the fused chooser's lanes kernel —
bit for bit, and bags of 2,000 slots — past the earlier embedding_bag
kernel's 1,536 — against the Pallas kernel and JAX's oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Partitioner as JPartitioner
from repro.core import EngineConfig as JCfg
from repro.kernels.embedding_bag.embedding_bag import (
    embedding_bag as jembedding_bag,
)
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jbag_ref
from repro_torch.api import Partitioner
from repro_torch.core.config import EngineConfig
from repro_torch.kernels.embedding_bag.embedding_bag import (
    KERNELS, LOAD_WIDTHS, load_width,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.fused_chooser import fused_chooser as fk
from repro_torch.kernels.fused_chooser.window_prep import (
    prep_max_w, prep_smem_bytes,
)
from repro_torch.kernels.partition_affinity import partition_affinity as pa

from test_torch_engine import assert_same, churn_pair
from test_torch_partitioner import _feed_chunks
from test_torch_engine import release_jax_executables  # noqa: F401


# (D, element size, base address, width): the widest of 16, 8, 4 dividing
# both the row's bytes and the base, else the element's width
@pytest.mark.parametrize("d,elem,base,width", [
    (256, 2, 0, 16), (256, 4, 0, 16), (256, 2, 1 << 40, 16),
    (12, 2, 0, 8), (6, 4, 0, 8), (6, 2, 0, 4), (5, 2, 0, 2), (5, 4, 0, 4),
    (256, 2, 2, 2), (256, 2, 4, 4), (256, 2, 8, 8), (256, 2, 24, 8),
    (256, 4, 4, 4), (256, 4, 8, 8), (256, 4, 12, 4), (1, 2, 0, 2),
    (1, 4, 16, 4), (8, 2, 16, 16)])
def test_embedding_bag_load_width(d, elem, base, width):
    assert load_width(d, elem, base) == width
    assert f"load{width}" in KERNELS and width in LOAD_WIDTHS


def test_embedding_bag_load_width_divides_rows_and_base():
    rng = np.random.default_rng(0)
    for _ in range(500):
        d, elem = int(rng.integers(1, 600)), int(rng.choice([2, 4]))
        base = int(rng.integers(0, 64)) * elem
        w = load_width(d, elem, base)
        assert w >= elem and (d * elem) % w == 0 and base % w == 0
        wider = [x for x in LOAD_WIDTHS if x > w]
        assert all((d * elem) % x or base % x for x in wider)


@pytest.mark.parametrize("w,k,kernel", [
    (256, 1, "lanes"), (256, 16, "lanes"), (256, 192, "lanes"),
    (256, 193, "large"), (256, 200, "large"), (256, 1000, "large"),
    (256, 4096, "large"), (256, 9587, "large"), (1, 9629, "large"),
    (4096, 4096, "large")])
def test_fused_chooser_dispatch(w, k, kernel):
    assert fk.dispatch(w, k) == kernel


def test_fused_chooser_large_limit_is_shared_memory():
    assert fk.LANES_MAX_K == 192
    assert fk.large_max_k(256) == 9587 >= 4096
    for w in (1, 100, 256, 1000, 4096):
        k = fk.large_max_k(w)
        assert fk.large_smem_bytes(w, k) <= fk.SMEM_MAX \
            < fk.large_smem_bytes(w, k + 1)
    with pytest.raises(ValueError, match="above the 9587 partitions"):
        fk.dispatch(256, 9588)
    with pytest.raises(ValueError, match=">= 1"):
        fk.dispatch(256, 0)


def test_fused_chooser_launch_takes_cuda_tensors():
    """The uncounted launch has no plain version to fall back on: CPU
    tensors raise before any kernel is built."""
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.launch("lanes", *([t] * 10), policy="sdp", balance_guard="text",
                  autoscaling=True)


# the pure-ADD fixup: the lanes kernel to K = 192 while its shared memory,
# 4 (32 + W + 5 K + K (K + 1)) bytes, fits (W <= 20,064 at K = 192), the
# large kernel above
@pytest.mark.parametrize("w,k,kernel", [
    (256, 1, "lanes"), (256, 16, "lanes"), (256, 40, "lanes"),
    (256, 192, "lanes"), (1, 192, "lanes"), (20064, 192, "lanes"),
    (20065, 192, "large"), (256, 193, "large"), (256, 200, "large"),
    (256, 1000, "large"), (4096, 4096, "large")])
def test_add_window_dispatch(w, k, kernel):
    assert fk.add_dispatch(w, k) == kernel


def test_add_window_limits_are_shared_memory():
    for w in (1, 256, 4096, 20064):
        k = fk.add_max_k(w)
        assert fk.add_smem_bytes(w, k) <= fk.SMEM_MAX \
            < fk.add_smem_bytes(w, k + 1)
        assert fk.add_lanes_smem_bytes(w, fk.LANES_MAX_K) <= fk.SMEM_MAX
    assert fk.add_lanes_smem_bytes(20065, fk.LANES_MAX_K) > fk.SMEM_MAX
    with pytest.raises(ValueError, match=f"above the {fk.add_max_k(256)} "
                                         f"partitions"):
        fk.add_dispatch(256, fk.add_max_k(256) + 1)
    with pytest.raises(ValueError, match=">= 1"):
        fk.add_dispatch(256, 0)


def test_add_launch_takes_cuda_tensors():
    t = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.add_launch("lanes", *([t] * 12), policy="sdp",
                      balance_guard="text", autoscaling=True)


def test_window_prep_limit_is_shared_memory():
    """window_prep's tables — five (W,) arrays and a hash table of the
    least power of two >= 4 W entries, five arrays — fit to W = 2,048."""
    w = prep_max_w()
    assert w == 2048
    assert prep_smem_bytes(w) <= fk.SMEM_MAX < prep_smem_bytes(w + 1)
    assert prep_smem_bytes(256) == 4 * (5 * 256 + 5 * 1024)


def test_partition_affinity_limit():
    assert pa.MAX_K == 58_112 >= fk.large_max_k(1)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_session_k200_matches_jax(use_kernel):
    """k_max = 200 on a churn stream: the port's session (on the CPU, the
    kernels' plain versions) equals the JAX session leaf for leaf, with the
    kernels (use_kernel=True: the fused chooser in interpret mode) and
    without."""
    s_j, s_t = churn_pair(seed=5)
    kw = dict(k_max=200, max_cap=30, k_init=1, autoscale=True)
    jp = _feed_chunks(JPartitioner.from_stream(s_j, JCfg(**kw), window=32,
                                               use_kernel=use_kernel),
                      s_j, 45)
    tp = _feed_chunks(Partitioner.from_stream(s_t, EngineConfig(**kw),
                                              window=32, use_kernel=use_kernel,
                                              device="cpu"), s_t, 45)
    assert_same(jp.state, tp.state)
    assert int(tp.state.num_partitions) > 1
    assert tp.metrics()["kernel_windows"] == jp.metrics()["kernel_windows"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_plain_2000_slots_matches_jax(mode, dtype):
    """Bags of 2,000 slots: bit for bit the Pallas kernel (interpret mode),
    which adds the slots in order as the plain version and the CUDA kernel
    do; and JAX's oracle within the reorder bound of an f32 sum — its
    ``rows.sum(axis=1)`` is XLA's reduce, which over 2,000 terms does not
    run strictly left to right (|difference| <= (L - 1) 2^-24 Σ|terms|)."""
    rng = np.random.default_rng(2000)
    v, d, b, l = 40, 24, 3, 2000
    table32 = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    idx[0] = -1
    jtable = jnp.asarray(table32, dtype=getattr(jnp, dtype))
    pallas = np.asarray(jembedding_bag(jtable, jnp.asarray(idx), mode=mode,
                                       block_d=d))
    oracle = np.asarray(jbag_ref(jtable, jnp.asarray(idx), mode=mode))
    ttable = torch.from_numpy(table32).to(getattr(torch, dtype))
    got = embedding_bag_ref(ttable, torch.from_numpy(idx), mode=mode).numpy()
    np.testing.assert_array_equal(got, pallas)
    mag = embedding_bag_ref(ttable.abs(), torch.from_numpy(idx),
                            mode=mode).numpy()
    assert (np.abs(got - oracle) <= (l - 1) * 2.0 ** -24 * mag).all()

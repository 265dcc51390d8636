"""The port's segment_spmm slice against the JAX package on the same
inputs: the plain version (what the wrapper runs for CPU tensors) against
JAX's Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py
runs it) and JAX's ``segment_spmm_ref`` at tests/test_kernels.py's shapes
and tolerances, and ``ops.ell_aggregate``'s gradient against JAX's
``custom_vjp``. The kernel itself runs only on the card
(tests/test_torch_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_spmm.ops import ell_aggregate as jell_aggregate
from repro.kernels.segment_spmm.ref import segment_spmm_ref as jspmm_ref
from repro.kernels.segment_spmm.segment_spmm import (
    segment_spmm as jsegment_spmm,
)
from repro_torch.kernels.segment_spmm.ops import ell_aggregate
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm

# tests/test_kernels.py's shapes (N, Dmax, F, mode) and tolerances, plus a
# row wider than a 32-id tile of the kernel's slot loop
SHAPES = [(8, 1, 8, "sum"), (20, 6, 40, "sum"), (20, 6, 40, "mean"),
          (33, 9, 130, "sum"), (5, 3, 256, "mean"), (12, 70, 24, "mean")]
TOL_F32, TOL_BF16 = 1e-5, 2e-2


def _inputs(n, dmax, f, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(dtype)
    adj = rng.integers(-1, n, (n, dmax)).astype(np.int32)
    adj[0] = -1                                   # a row with no neighbour
    return x, adj


@pytest.mark.parametrize("n,dmax,f,mode", SHAPES)
def test_segment_spmm_matches_jax(n, dmax, f, mode):
    x, adj = _inputs(n, dmax, f, seed=n + dmax)
    want = np.asarray(jspmm_ref(x, adj, mode=mode))
    pallas = np.asarray(jsegment_spmm(x, adj, mode=mode, block_f=64))
    before = segment_spmm.launches
    got = segment_spmm(torch.from_numpy(x), torch.from_numpy(adj), mode=mode)
    assert segment_spmm.launches == before        # a CPU tensor: plain
    assert got.dtype == torch.float32 and got.shape == (n, f)
    assert not got[0].any()
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), other, rtol=TOL_F32,
                                   atol=TOL_F32)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_segment_spmm_bf16_matches_jax(mode):
    x, adj = _inputs(16, 4, 32, seed=1)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jspmm_ref(xj, adj, mode=mode))
    pallas = np.asarray(jsegment_spmm(xj, adj, mode=mode))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = segment_spmm(xt, torch.from_numpy(adj), mode=mode)
    assert got.dtype == torch.float32
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), other, rtol=TOL_BF16,
                                   atol=TOL_BF16)


def test_plain_version_adds_slots_in_order():
    """The slots are added in order into a zeroed f32 accumulator (the
    order the kernel keeps), which an f32 loop over the slots reproduces
    bit for bit; a -1 slot adds nothing."""
    x, adj = _inputs(10, 40, 12, seed=7)
    got = segment_spmm_ref(torch.from_numpy(x), torch.from_numpy(adj)).numpy()
    want = np.zeros((10, 12), np.float32)
    for s in range(40):
        valid = adj[:, s] >= 0
        want[valid] = want[valid] + x[adj[valid, s]]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_ell_aggregate_grad_matches_jax(mode):
    """tests/test_kernels.py's gradient case, both modes."""
    x, adj = _inputs(12, 5, 16, seed=2)

    def f(x):
        return jnp.sum(jell_aggregate(x, adj, mode, False) ** 2)

    want = np.asarray(jax.grad(f)(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = ell_aggregate(xt, torch.from_numpy(adj), mode)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=TOL_F32,
                               atol=TOL_F32)
    np.testing.assert_allclose(
        ell_aggregate(torch.from_numpy(x), torch.from_numpy(adj), mode,
                      False).numpy(),
        np.asarray(jell_aggregate(x, adj, mode, False)), rtol=TOL_F32,
        atol=TOL_F32)


def test_bad_mode_raises():
    x, adj = torch.zeros((4, 2)), torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        segment_spmm(x, adj, mode="max")

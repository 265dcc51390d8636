"""Differentiable ELL aggregation: the kernel forward, and the JAX
package's backward (``repro.kernels.segment_spmm.ops._bwd``, plain jnp
there) in plain PyTorch — the mean-scaled output gradient of each row
scattered into the rows it gathered, with ``index_add_``. JAX masks a
broadcast (N, Dmax, F) gradient; the port gathers only the valid slots'
rows (the same sums without the added zeros), since at twitter's
81,306 x 192 rows and F = 1433 that broadcast alone would take 89.5 GB."""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.kernels.segment_spmm.segment_spmm import segment_spmm


class _EllAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj_ell, mode, use_kernel):
        ctx.save_for_backward(adj_ell)
        ctx.mode, ctx.n_rows = mode, x.shape[0]
        fn = segment_spmm if use_kernel else segment_spmm_ref
        return fn(x, adj_ell, mode=mode)

    @staticmethod
    def backward(ctx, g):
        (adj_ell,) = ctx.saved_tensors
        valid = adj_ell >= 0
        if ctx.mode == "mean":
            cnt = torch.clamp(valid.sum(dim=1, keepdim=True,
                                        dtype=torch.int32), min=1)
            g = g / cnt.to(g.dtype)
        rows, slots = valid.nonzero(as_tuple=True)
        dx = torch.zeros((ctx.n_rows, g.shape[1]), dtype=g.dtype,
                         device=g.device)
        dx.index_add_(0, adj_ell[rows, slots].to(torch.int64), g[rows])
        return dx, None, None, None


def ell_aggregate(x, adj_ell, mode="sum", use_kernel=True):
    """(N, F) f32 aggregation of ``x`` over ``adj_ell``; ``use_kernel``
    takes ``segment_spmm`` (the kernel for CUDA tensors, the plain version
    for CPU ones), ``False`` the plain version on any device."""
    return _EllAggregate.apply(x, adj_ell, mode, use_kernel)

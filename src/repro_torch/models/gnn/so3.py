"""Self-contained SO(3) machinery for the equivariant GNN (NequIP): the
port's numpy copy of ``repro.models.gnn.so3``.

No e3nn offline — real spherical harmonics are written as explicit
polynomials (l ≤ 2), Wigner-D matrices are fit from them by least squares,
and Clebsch–Gordan coupling tensors are obtained as the rotation-averaged
fixed-point projector of D3 ⊗ (D1 ⊗ D2)ᵀ. Everything is computed once in
numpy at import, cached, and verified by the equivariance property tests
(residuals ~1e-12).

Convention: component order m = -l..l with the e3nn-style l=1 ordering
(y, z, x) so that D¹ equals the rotation matrix in that basis.
"""
from __future__ import annotations

import functools

import numpy as np

L_MAX = 2
DIMS = {0: 1, 1: 3, 2: 5}


def sh_np(l: int, r: np.ndarray) -> np.ndarray:
    """Real spherical harmonics of unit vectors r (..., 3), unnormalised
    (component normalisation ||Y_l||² = const per l, e3nn 'integral' not
    needed — any fixed scale is equivariance-preserving)."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    if l == 0:
        return np.ones(r.shape[:-1] + (1,))
    if l == 1:
        return np.stack([y, z, x], axis=-1)
    if l == 2:
        s3 = np.sqrt(3.0)
        return np.stack([
            s3 * x * y,
            s3 * y * z,
            0.5 * (3 * z**2 - 1.0),
            s3 * x * z,
            0.5 * s3 * (x**2 - y**2),
        ], axis=-1)
    raise NotImplementedError(l)


def _rand_rotations(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x**2 + z**2), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x**2 + y**2)], -1),
    ], axis=1)


def wigner_d(l: int, R: np.ndarray) -> np.ndarray:
    """D^l(R) (dim, dim): fit Y_l(R r) = D Y_l(r) by least squares over
    random unit vectors. Exact for polynomial SH (system is overdetermined
    and consistent)."""
    dim = DIMS[l]
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((4 * dim * dim, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    a = sh_np(l, pts)                       # (P, dim)   Y(r)
    b = sh_np(l, pts @ R.T)                 # (P, dim)   Y(Rr)
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    return d.T                               # b = Y(Rr) = D @ Y(r)


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Coupling tensor C (d1, d2, d3) with
    D3[n,n'] C[i',j',n'] = C[i,j,n] D1[i,i'] D2[j,j'] for all rotations —
    i.e. contracting two covariant inputs against C yields an l3-covariant
    output. Computed as the dominant fixed vector of the rotation average of
    the combined representation; normalised to ||C|| = 1."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((DIMS[l1], DIMS[l2], DIMS[l3]))
    d1, d2, d3 = DIMS[l1], DIMS[l2], DIMS[l3]
    dim = d1 * d2 * d3
    rots = _rand_rotations(8, seed=7)
    # C (as a vector of V1⊗V2⊗V3) is rotation-invariant:
    # (D1⊗D2⊗D3) c = c for every rotation — exact linear constraints.
    rows = []
    for R in rots:
        m1, m2, m3 = wigner_d(l1, R), wigner_d(l2, R), wigner_d(l3, R)
        big = np.einsum("ia,jb,nc->ijnabc", m1, m2, m3).reshape(dim, dim)
        rows.append(big - np.eye(dim))
    m = np.concatenate(rows, axis=0)
    _, sv, vt = np.linalg.svd(m)
    null = vt[sv.size - 1:] if sv[-1] < 1e-8 else vt[len(sv):]
    if null.shape[0] != 1:
        raise RuntimeError(
            f"CG null space for ({l1},{l2},{l3}) has dim {null.shape[0]}")
    c = null[0].reshape(d1, d2, d3)
    return c / np.linalg.norm(c)


def paths(l_max: int = L_MAX):
    """All (l_in, l_edge, l_out) couplings with every l ≤ l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out

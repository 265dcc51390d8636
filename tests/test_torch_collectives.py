"""The port's collectives (``repro_torch.runtime.collectives``) on meshes of
CPU entries: each operation's forward against the dense operation on the
whole tensor and its backward against the dense adjoint, at 1, 2 and 4
entries and over one axis or two, bit for bit (the sums run in rank
order, as the dense reference below sums them), and the backward against
autograd through the dense operation within f64 rounding (autograd sums
in its own order); and the wire counters against the JAX package's HLO
statistics (``repro.launch.hlo_stats``) for the same result bytes and
group size."""
import numpy as np
import pytest
import torch

from repro.launch import hlo_stats
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import collectives as C
from test_torch_engine import release_jax_executables  # noqa: F401

MESHES = {1: ((1,), ("x",)), 2: ((2,), ("x",)), 4: ((4,), ("x",)),
          "2x2": ((2, 2), ("a", "b"))}
AXES = {1: ["x"], 2: ["x"], 4: ["x"], "2x2": ["a", "b", ("a", "b")]}
CASES = [(k, ax) for k in MESHES for ax in AXES[k]]


def _mesh(key):
    dims, names = MESHES[key]
    return make_mesh(dims, names, devices=["cpu"] * int(np.prod(dims)))


def _inputs(n, shape, seed, grad=True):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=torch.float64)
            .requires_grad_(grad) for _ in range(n)]


def _rank_sum(parts):
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    return tot


def _dense(op, xs, mesh, axes, dim, split=0, concat=1):
    """What every entry should hold: the dense operation on its group,
    sums in rank order."""
    out = [None] * len(xs)
    for group in C.groups(mesh, axes):
        parts = [xs[i] for i in group]
        g = len(group)
        for r, i in enumerate(group):
            if op == "all_gather":
                out[i] = torch.cat(parts, dim)
            elif op == "all_reduce":
                out[i] = _rank_sum(parts)
            elif op == "reduce_scatter":
                out[i] = _rank_sum(parts).chunk(g, dim)[r]
            elif op == "all_to_all":
                out[i] = torch.cat([p.chunk(g, split)[r] for p in parts],
                                   concat)
            elif op == "copy_to":
                out[i] = xs[i]
    return out


def _call(op, xs, mesh, axes, dim):
    if op == "all_to_all":
        return C.all_to_all(xs, mesh, axes, 0, 1)
    if op in ("all_reduce", "copy_to"):
        return getattr(C, op)(xs, mesh, axes)
    return getattr(C, op)(xs, mesh, axes, dim)


OPS = ["all_gather", "all_reduce", "reduce_scatter", "all_to_all", "copy_to"]
# each operation's adjoint, as (op, split, concat) of _dense
ADJOINT = {"all_gather": ("reduce_scatter", 0, 1),
           "all_reduce": ("all_reduce", 0, 1),
           "reduce_scatter": ("all_gather", 0, 1),
           "all_to_all": ("all_to_all", 1, 0),
           "copy_to": ("all_reduce", 0, 1)}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("key,axes", CASES)
def test_forward_and_backward_match_dense(op, key, axes):
    """Forward bit-equal to the dense operation; backward bit-equal to the
    adjoint summed in rank order, and within f64 rounding of autograd
    through the dense operation (which sums in its own order); Megatron's
    copy backward is the all-reduce of the gradients."""
    mesh = _mesh(key)
    n = len(mesh.devices)
    dim = 1
    xs = _inputs(n, (4, 8), seed=n)
    got = _call(op, xs, mesh, axes, dim)
    ys = [x.detach().clone().requires_grad_(True) for x in xs]
    want = _dense(op, ys, mesh, axes, dim)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    cot = _inputs(n, got[0].shape, seed=100 + n, grad=False)
    ga = torch.autograd.grad(got, xs, cot)
    adj, split, concat = ADJOINT[op]
    for a, b in zip(ga, _dense(adj, cot, mesh, axes, dim, split, concat)):
        assert a.shape == b.shape and torch.equal(a, b)
    if op != "copy_to":
        gb = torch.autograd.grad(want, ys, cot)
        for a, b in zip(ga, gb):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_outputs_are_tensors_of_their_own():
    mesh = _mesh(4)
    xs = _inputs(4, (4, 8), seed=0, grad=False)
    for op in ("all_gather", "all_reduce", "reduce_scatter", "all_to_all"):
        out = _call(op, xs, mesh, "x", 1)
        ptrs = {o.untyped_storage().data_ptr() for o in out}
        assert len(ptrs) == 4, op
        assert not ptrs & {x.untyped_storage().data_ptr() for x in xs}, op
    one = _mesh(1)
    (y,) = C.all_reduce(xs[:1], one, "x")
    assert y.untyped_storage().data_ptr() != xs[0].untyped_storage().data_ptr()


def test_all_reduce_max():
    mesh = _mesh("2x2")
    xs = _inputs(4, (3, 5), seed=1, grad=False)
    for axes in ("a", "b", ("a", "b")):
        got = C.all_reduce_max(xs, mesh, axes)
        for group in C.groups(mesh, axes):
            want = torch.stack([xs[i] for i in group]).amax(0)
            for i in group:
                assert torch.equal(got[i], want)


def test_groups_are_row_major():
    mesh = _mesh("2x2")
    assert C.groups(mesh, "a") == [(0, 2), (1, 3)]
    assert C.groups(mesh, "b") == [(0, 1), (2, 3)]
    assert C.groups(mesh, ("a", "b")) == [(0, 1, 2, 3)]
    assert C.groups(mesh, ("b", "a")) == [(0, 2, 1, 3)]
    with pytest.raises(ValueError, match="axes"):
        C.groups(mesh, "c")


def test_wrong_device_and_count_raise():
    mesh = _mesh(2)
    xs = _inputs(2, (2, 2), seed=0, grad=False)
    with pytest.raises(ValueError, match="2 entries"):
        C.all_reduce(xs[:1], mesh, "x")
    meta = [xs[0], torch.empty((2, 2), device="meta")]
    with pytest.raises(ValueError, match="entry 1 lives on cpu"):
        C.all_gather(meta, mesh, "x", 0)


def _hlo_wire(op: str, nbytes: int, g: int, n_devices: int) -> float:
    """The JAX package's wire bytes for one HLO collective whose result is
    ``nbytes`` of f32, in groups of ``g`` of ``n_devices``."""
    hop = op.replace("_", "-")
    line = (f"  %x = f32[{nbytes // 4}] {hop}(f32[8] %p), "
            f"replica_groups=[{n_devices // g},{g}]<=[{n_devices}]")
    instr = hlo_stats.Instr("x", hop, f"f32[{nbytes // 4}]", line, line)
    got_op, got_bytes, wire = hlo_stats._collective_wire(instr, n_devices)
    assert (got_op, got_bytes) == (hop, nbytes)
    return wire


@pytest.mark.parametrize("op", ["all_gather", "all_reduce", "reduce_scatter",
                                "all_to_all"])
@pytest.mark.parametrize("key,axes", CASES)
def test_wire_bytes_match_hlo_stats(op, key, axes):
    mesh = _mesh(key)
    n = len(mesh.devices)
    xs = _inputs(n, (4, 8), seed=0, grad=False)
    xs = [x.float() for x in xs]
    C.reset_wire_bytes()
    out = _call(op, xs, mesh, axes, 1)
    g = len(C.groups(mesh, axes)[0])
    counted = C.wire_bytes()
    for i, o in enumerate(out):
        nbytes = o.numel() * o.element_size()
        want = _hlo_wire(op, nbytes, g, n)
        assert counted[op].get(i, 0.0) == want == C.ring_wire_bytes(
            op, nbytes, g)
    assert all(not v for k, v in counted.items() if k != op)


def test_backward_counts_the_adjoint():
    mesh = _mesh(4)
    xs = [x.float().requires_grad_(True)
          for x in _inputs(4, (4, 8), seed=0, grad=False)]
    out = C.all_gather(xs, mesh, "x", 1)
    C.reset_wire_bytes()
    torch.autograd.grad(out, xs, [torch.ones_like(o) for o in out])
    counted = C.wire_bytes()
    assert counted["reduce_scatter"] == {
        i: C.ring_wire_bytes("reduce_scatter", 4 * 8 * 4, 4) for i in range(4)}
    assert not counted["all_gather"]

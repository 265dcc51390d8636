"""Device meshes for one process that owns every device (the port's
counterpart of ``repro.launch.mesh``).

JAX drives a mesh from a single controller: one program, one array
sharded over the devices. The port does the same from one Python process:
a :class:`Mesh` is a named tuple of ``torch.device`` entries with axis
names, and a tensor is placed on it by a :class:`Placement` — either whole
on the lead device (``devices[0]``), or split into equal row blocks along a
named axis, one block on each entry of that axis (:class:`RowBlocks`), or
split over several dims and axes by a :class:`PartitionSpec`, as JAX's
``NamedSharding`` splits an array (:class:`SpecBlocks`; the parameter
rules of ``repro_torch.runtime.sharding`` give those specs). The
vertex-sharded session (``repro_torch.core.sharded_state``) and the
elastic runner (``repro_torch.runtime.elastic``) place their tensors in
row blocks.

A mesh's entries may repeat a device: ``make_vertices_mesh(devices=
["cpu"] * 4)`` or ``[torch.device("cuda", 0)] * 4`` gives four row blocks
on one device. That is the port's counterpart of the JAX tests'
``XLA_FLAGS=--xla_force_host_platform_device_count``: how the CPU tests and
a one-card machine run meshes wider than one block. It adds no feature —
the blocks are separate tensors either way.

Not ported: ``make_production_mesh`` and ``make_host_mesh`` (the TPU pod
slices' (data, model) meshes), ``make_mesh_compat`` and
``shard_map_compat`` (jax version shims), and ``make_lane_mesh`` (sweep
lanes over several cards are ROADMAP A23).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Mesh(NamedTuple):
    """Devices laid out on named axes: ``devices`` row-major over
    ``dims``, one size per name in ``axis_names``."""
    devices: tuple          # torch.device entries, row-major
    axis_names: tuple       # one name per axis
    dims: tuple             # one size per axis

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as JAX's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def lead(self) -> torch.device:
        """The device that holds every leaf that is not split."""
        return self.devices[0]

    def axis_devices(self, axis: str) -> tuple:
        """The devices along ``axis`` at index 0 of every other axis —
        the entries a tensor split on ``axis`` lives on."""
        grid = np.empty(self.dims, dtype=object)
        grid.reshape(-1)[:] = self.devices
        at = [0] * len(self.dims)
        i = self.axis_names.index(axis)
        at[i] = slice(None)
        return tuple(grid[tuple(at)])


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present — a mesh covers the CUDA cards by "
            "default; pass an explicit devices= sequence (e.g. "
            "['cpu'] * 4) to run row blocks on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_devices(devices) -> list:
    """The entries as ``torch.device``s, all of one type: a mesh is CUDA
    cards or the CPU, never both (a block's host reads would race its
    copies from a card, and the session dispatches by the lead's type)."""
    devices = [torch.device(d) for d in devices]
    types = sorted({d.type for d in devices})
    if len(types) > 1:
        raise ValueError(
            f"a mesh's devices must all be of one type, got {types} in "
            f"{[str(d) for d in devices]} — run row blocks on the CUDA "
            "cards or on the CPU, not on both")
    return devices


def make_vertices_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over axis "vertices" for vertex-sharded sessions: one
    session's per-vertex rows are laid out as one row block per entry.
    ``devices`` selects the entries explicitly (a device may repeat, see
    the module docstring; CUDA and CPU entries may not mix); otherwise the first ``n_devices`` CUDA cards
    (all of them when ``None``), raising past ``torch.cuda.device_count()``
    as JAX raises past ``jax.devices()``."""
    if devices is None:
        avail = _cuda_devices()
        if n_devices is None:
            n_devices = len(avail)
        if n_devices > len(avail):
            raise ValueError(
                f"make_vertices_mesh(n_devices={n_devices}) exceeds the "
                f"{len(avail)} local devices — pass an explicit devices= "
                "sequence (a device may repeat to give it several row "
                "blocks)")
        devices = avail[:n_devices]
    devices = _as_devices(devices)
    if not devices:
        raise ValueError("make_vertices_mesh needs at least one device")
    return Mesh(tuple(devices), ("vertices",), (len(devices),))


def resolve_vertices_mesh(devices, device=None) -> Mesh:
    """The vertices mesh a session or sweep names: ``devices`` None (every
    CUDA card, or ``[device]`` when the caller names a device), an int (the
    first N cards) or a device sequence (exactly those entries)."""
    if devices is None:
        if device is not None:
            return make_vertices_mesh(devices=[device])
        return make_vertices_mesh()
    if isinstance(devices, int):
        return make_vertices_mesh(devices)
    return make_vertices_mesh(devices=list(devices))


def make_grid_mesh(n_lanes: int, n_vertices: int, devices=None) -> Mesh:
    """2-D (lanes × vertices) mesh: sweep lanes on the first axis, each
    lane's vertex blocks on the second — the composition guard for the two
    1-D meshes: the product must fit the device budget or this raises with
    the arithmetic spelled out. ``devices`` defaults to every CUDA card."""
    if n_lanes < 1 or n_vertices < 1:
        raise ValueError(
            f"make_grid_mesh(n_lanes={n_lanes}, n_vertices={n_vertices}): "
            "both axis sizes must be >= 1")
    devices = _cuda_devices() if devices is None else _as_devices(devices)
    need = n_lanes * n_vertices
    if need > len(devices):
        raise ValueError(
            f"make_grid_mesh(n_lanes={n_lanes}, n_vertices={n_vertices}) "
            f"needs {need} devices but only {len(devices)} are available — "
            "shrink one axis, pass a longer devices= sequence (a device may "
            "repeat), or run lane-sharded and vertex-sharded work as "
            "separate sweeps")
    return Mesh(tuple(devices[:need]), ("lanes", "vertices"),
                (n_lanes, n_vertices))


class RowBlocks:
    """A tensor split into equal row blocks, block ``i`` on ``devices[i]``
    — the port's global array for a leaf split along a mesh axis. Its
    ``shape`` and ``dtype`` are the whole tensor's; ``np.asarray`` of it
    gathers the rows on the host (so checkpoints save it like a tensor)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = tuple(blocks)

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.blocks)

    @property
    def shape(self) -> torch.Size:
        b = self.blocks[0]
        return torch.Size((sum(x.shape[0] for x in self.blocks),
                           *b.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return self.blocks[0].ndim

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: block 0's device)."""
        dev = self.blocks[0].device if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in self.blocks])

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"RowBlocks(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"devices={[str(d) for d in self.devices]})")


def _spec_axes(entry) -> tuple:
    """The mesh axes a spec entry names: ``None`` none, a name one, a tuple
    several (their sizes multiply, read row-major)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per leading dim of a tensor —
    ``None`` (not split), a mesh axis name, or a tuple of names — as a
    tuple, normalised as JAX normalises it: ``()`` becomes ``None`` and a
    one-name tuple its name. Dims past the spec's length are not split."""

    def __new__(cls, *entries):
        def norm(e):
            axes = _spec_axes(e)
            if not axes:
                return None
            return axes[0] if len(axes) == 1 else axes
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class SpecBlocks:
    """A tensor split over a mesh as JAX's ``NamedSharding(mesh, spec)``
    splits an array: dim ``d`` into ``prod`` (sizes of ``spec[d]``'s axes)
    equal blocks; the mesh entry at coordinates ``c`` holds the block whose
    index along ``d`` is ``c`` over ``spec[d]``'s axes, read row-major, and
    axes the spec does not name hold copies. ``shards`` has one tensor per
    mesh entry, in the mesh's row-major order. ``shape`` and ``dtype`` are
    the whole tensor's; ``np.asarray`` of it gathers on the host."""

    __slots__ = ("mesh", "spec", "shape", "shards")

    def __init__(self, mesh: Mesh, spec, shape, shards: Sequence):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shape = torch.Size(shape)
        self.shards = tuple(shards)

    @property
    def devices(self) -> tuple:
        return tuple(b.device for b in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the lead entry's),
        each block read from the first entry that holds it."""
        dev = self.shards[0].device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for sl, shard in zip(_block_slices(self.mesh, self.spec, self.shape),
                             self.shards):
            key = tuple((x.start, x.stop) for x in sl)
            if key not in done:
                out[sl] = shard.to(dev)
                done.add(key)
        return out

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"SpecBlocks(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec!r}, mesh={self.mesh.shape})")


def _block_slices(mesh: Mesh, spec, shape) -> list:
    """Each mesh entry's block of a ``shape`` tensor under ``spec``, as a
    tuple of slices, in the mesh's row-major order. Raises where the spec
    is longer than the tensor's rank, names an axis the mesh lacks or
    twice, or a dim does not split evenly (JAX's even-sharding
    contract)."""
    spec = PartitionSpec(*spec)
    sizes = mesh.shape
    if len(spec) > len(shape):
        raise ValueError(f"{spec!r} has {len(spec)} entries for a tensor "
                         f"of rank {len(shape)}")
    named = [a for e in spec for a in _spec_axes(e)]
    unknown = [a for a in named if a not in sizes]
    if unknown or len(set(named)) != len(named):
        raise ValueError(f"{spec!r} names {named}: each at most once, and "
                         f"only axes of the mesh {sizes}")
    counts = [int(np.prod([sizes[a] for a in _spec_axes(e)], dtype=np.int64))
              for e in spec]
    for d, (n, c) in enumerate(zip(shape, counts)):
        if n % c:
            raise ValueError(
                f"dim {d} of a {tuple(shape)} tensor ({n}) does not split "
                f"evenly into {c} blocks under {spec!r} on the mesh {sizes}")
    out = []
    for coord in np.ndindex(*mesh.dims):
        at = dict(zip(mesh.axis_names, coord))
        sl = []
        for n, c, e in zip(shape, counts, spec):
            i = 0
            for a in _spec_axes(e):
                i = i * sizes[a] + at[a]
            r = n // c
            sl.append(slice(i * r, (i + 1) * r))
        sl += [slice(0, n) for n in shape[len(spec):]]
        out.append(tuple(sl))
    return out


def split_spec(x: torch.Tensor, mesh: Mesh, spec) -> SpecBlocks:
    """``x`` split over ``mesh`` as ``spec`` says (:class:`SpecBlocks`):
    each entry's block a contiguous copy on that entry's device, never a
    view of ``x``."""
    slices = _block_slices(mesh, spec, x.shape)
    return SpecBlocks(mesh, spec, x.shape, (
        x[sl].to(torch.device(d), copy=True,
                 memory_format=torch.contiguous_format)
        for sl, d in zip(slices, mesh.devices)))


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` over named axes, JAX's ``make_mesh``: the
    first ``prod(axis_shapes)`` of ``devices`` (default: every CUDA card)
    row-major. A device may repeat (see the module docstring); raises
    when there are too few."""
    dims = tuple(int(n) for n in axis_shapes)
    names = tuple(axis_names)
    if len(dims) != len(names) or min(dims, default=0) < 1:
        raise ValueError(f"make_mesh({dims}, {names}): one size >= 1 per "
                         "axis name")
    devices = _cuda_devices() if devices is None else _as_devices(devices)
    need = int(np.prod(dims))
    if need > len(devices):
        raise ValueError(
            f"make_mesh({dims}, {names}) needs {need} devices but only "
            f"{len(devices)} are available — pass a longer devices= "
            "sequence (a device may repeat)")
    return Mesh(tuple(devices[:need]), names, dims)


class Placement(NamedTuple):
    """Where a leaf lives on ``mesh``: ``axis=None`` whole on the lead
    device, else in equal row blocks along ``axis`` (:class:`RowBlocks`);
    with a ``spec``, split as JAX's ``NamedSharding(mesh, spec)``
    (:class:`SpecBlocks`, ``axis`` unused)."""
    mesh: Mesh
    axis: str | None = None
    spec: tuple | None = None


def split_rows(x: torch.Tensor, devices: Sequence) -> RowBlocks:
    """``x`` in ``len(devices)`` equal row blocks, block ``i`` a copy on
    ``devices[i]`` (never a view of ``x``, even on ``x``'s device: the
    blocks are updated in place). Raises unless the rows divide."""
    p = len(devices)
    n = x.shape[0]
    if n % p:
        raise ValueError(
            f"{n} rows do not split into {p} equal blocks — pad the rows "
            "to a multiple of the axis size first")
    r = n // p
    return RowBlocks(x[i * r:(i + 1) * r].to(torch.device(d), copy=True)
                     for i, d in enumerate(devices))


def place(x, placement: Placement):
    """``x`` (a tensor, a ``RowBlocks``, a ``SpecBlocks`` or a host array)
    placed as ``placement`` says: a tensor on the lead device,
    ``RowBlocks`` on the axis' entries, or ``SpecBlocks`` by its spec."""
    if isinstance(x, (RowBlocks, SpecBlocks)):
        x = x.gather()
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    if placement.spec is not None:
        return split_spec(x, placement.mesh, placement.spec)
    if placement.axis is None:
        return x.to(placement.mesh.lead, copy=True)
    return split_rows(x, placement.mesh.axis_devices(placement.axis))


def gather(x, device=None) -> torch.Tensor:
    """The whole of a placed leaf as one tensor on ``device`` (default:
    where it is, or its block 0's device)."""
    if isinstance(x, (RowBlocks, SpecBlocks)):
        return x.gather(device)
    return x if device is None else x.to(device)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested named tuples, dicts,
    lists and tuples; ``None`` an empty subtree; a ``RowBlocks`` is one
    leaf), with the matching entries of ``rest`` —
    trees of the same structure down to ``tree``'s leaves — as further
    arguments, as ``jax.tree.map``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def place_tree(tree, placements):
    """Every leaf of ``tree`` placed by the matching leaf of
    ``placements`` (``place``)."""
    return tree_map(place, tree, placements)

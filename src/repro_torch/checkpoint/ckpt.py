"""Pytree checkpointing in the JAX package's on-disk format (the port's
copy of ``repro.checkpoint.ckpt``): an ``.npz`` payload of the leaves
(``a0``, ``a1``, … in flattening order, plus ``x_<name>`` extras) and a
MessagePack ``.meta`` (``keys``, ``step``, ``geometry``, ``extras``), both
written under temporary names and renamed into place — a crash mid-save
never leaves a torn checkpoint. A checkpoint either package writes, the
other restores.

Trees are nested NamedTuples, dicts, lists and tuples of tensors or
arrays. They flatten as ``jax.tree_util`` flattens them (dict keys
sorted, ``None`` an empty subtree), and each leaf's key is the path JAX
prints for it: ``.field`` for a NamedTuple field, the key for a dict entry,
the index for a sequence entry, joined by ``/`` — a ``PartitionState``'s
keys are ``.assignment``, ``.present``, …, ``.key``, ``.cut_matrix``.
"""
from __future__ import annotations

import os
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.checkpoint import msgpack
from repro_torch.launch.mesh import RowBlocks, place_tree, split_rows

# numpy dtypes of the torch dtypes a state holds (torch.uint32 included)
_NP = {torch.bool: np.bool_, torch.int8: np.int8, torch.uint8: np.uint8,
       torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
       torch.uint32: np.uint32, torch.float16: np.float16,
       torch.float32: np.float32, torch.float64: np.float64}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: tuple, out: list) -> None:
    if tree is None:
        return
    if _is_namedtuple(tree):
        for f in tree._fields:
            _walk(getattr(tree, f), path + (f".{f}",), out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _walk(x, path + (str(i),), out)
    else:
        out.append(("/".join(path), tree))


def _rebuild(like, leaves):
    """``like``'s structure with its leaves replaced, in flattening order."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def to_numpy(leaf) -> np.ndarray:
    """A host array of ``leaf`` (a tensor on any device, an array, or a
    Python scalar)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree):
    pairs: list = []
    _walk(tree, (), pairs)
    return [k for k, _ in pairs], [to_numpy(v) for _, v in pairs]


def save_pytree(path: str, tree, *, step: int | None = None,
                geometry=None, extras=None) -> str:
    """Atomic save; returns the final path. ``geometry`` (a ``Geometry`` or
    a mapping with n / max_deg / k_max) is recorded in the metadata so a
    restorer can size its target without loading the payload; ``extras``
    is a ``{name: array}`` of session arrays that ride along outside the
    tree (read back with :func:`checkpoint_extras`)."""
    keys, vals = _flatten(tree)
    if geometry is not None and hasattr(geometry, "_asdict"):
        geometry = dict(geometry._asdict())
    extras = {str(k): to_numpy(v) for k, v in (extras or {}).items()}
    meta = {"keys": keys, "step": step, "geometry": geometry,
            "extras": sorted(extras)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{f"a{i}": v for i, v in enumerate(vals)},
                     **{f"x_{k}": v for k, v in extras.items()})
        with open(tmp + ".meta", "wb") as f:
            f.write(msgpack.packb(meta))
        os.replace(tmp, path)
        os.replace(tmp + ".meta", path + ".meta")
    finally:
        for t in (tmp, tmp + ".meta"):
            if os.path.exists(t):
                os.unlink(t)
    return path


def _read_meta(path: str) -> dict:
    with open(path + ".meta", "rb") as f:
        return msgpack.unpackb(f.read())


def restore_pytree(path: str, like, *, shardings=None,
                   fill_missing: bool = False, device=None):
    """Restore into the structure of ``like``: each leaf takes ``like``'s
    dtype and lands on ``device`` (default: where ``like``'s leaf lives —
    a ``RowBlocks`` leaf restores into blocks on the same devices), or,
    given ``shardings`` (a matching tree of ``launch.mesh.Placement``s),
    where its placement says — the elastic re-shard. ``fill_missing=True``
    aligns leaves by their saved keys instead of requiring the same leaf
    count: leaves of ``like`` absent from the checkpoint keep ``like``'s
    value — how a state that gained trailing fields (``cut_matrix``)
    restores from an older checkpoint."""
    meta = _read_meta(path)
    with np.load(path) as data:
        vals = [data[f"a{i}"] for i in range(len(meta["keys"]))]
    pairs: list = []
    _walk(like, (), pairs)
    flat_like = [v for _, v in pairs]
    if len(vals) != len(flat_like):
        if not fill_missing:
            raise ValueError(
                f"checkpoint has {len(vals)} leaves, target has "
                f"{len(flat_like)} (fill_missing=True aligns by key)")
        saved = dict(zip(meta["keys"], vals))
        vals = [saved.get(k, to_numpy(lv)) for k, lv in pairs]
    out = []
    for v, lv in zip(vals, flat_like):
        if isinstance(lv, (torch.Tensor, RowBlocks)):
            t = torch.from_numpy(np.array(v, dtype=_NP[lv.dtype],
                                          order="C"))
            if shardings is not None:
                out.append(t)
            elif isinstance(lv, RowBlocks) and device is None:
                out.append(split_rows(t, lv.devices))
            else:
                out.append(t.to(lv.device if device is None else device))
        else:
            out.append(np.asarray(v).astype(np.asarray(lv).dtype))
    tree = _rebuild(like, iter(out))
    return tree if shardings is None else place_tree(tree, shardings)


def checkpoint_extras(path: str) -> dict[str, np.ndarray]:
    """The ``extras`` arrays saved with a checkpoint (empty when none were
    recorded or the checkpoint predates the channel)."""
    try:
        names = _read_meta(path).get("extras") or []
    except FileNotFoundError:
        return {}
    if not names:
        return {}
    with np.load(path) as data:
        return {k: data[f"x_{k}"] for k in names}


def checkpoint_step(path: str) -> int | None:
    try:
        return _read_meta(path).get("step")
    except FileNotFoundError:
        return None


def _npy_header_shape(f) -> tuple:
    """Shape from an .npy member's header alone — no payload read."""
    version = np.lib.format.read_magic(f)
    read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                   else np.lib.format.read_array_header_2_0)
    shape, _, _ = read_header(f)
    return shape


def checkpoint_geometry(path: str):
    """The ``Geometry`` a checkpointed ``PartitionState`` was taken at: from
    the metadata when recorded, else inferred from the saved leaves' npy
    headers (assignment → n, adj → max_deg, edge_load → k_max). ``None``
    if the checkpoint is missing or not a partition state."""
    from repro_torch.core.geometry import Geometry
    try:
        meta = _read_meta(path)
    except FileNotFoundError:
        return None
    g = meta.get("geometry")
    if g:
        k = g.get("k_max")
        return Geometry(int(g["n"]), int(g["max_deg"]),
                        int(k) if k is not None else None)
    # NamedTuple key paths read ".assignment" — match bare field names
    idx = {k.rsplit("/", 1)[-1].lstrip("."): i
           for i, k in enumerate(meta.get("keys") or [])}
    try:
        with zipfile.ZipFile(path) as zf:
            def shape(field: str) -> tuple:
                with zf.open(f"a{idx[field]}.npy") as f:
                    return _npy_header_shape(f)
            return Geometry(int(shape("assignment")[0]),
                            int(shape("adj")[1]),
                            int(shape("edge_load")[0]))
    except (KeyError, IndexError, FileNotFoundError, ValueError,
            zipfile.BadZipFile):
        return None


def checkpoint_keys(path: str) -> list[str] | None:
    """Key paths of the saved leaves (a restorer tells an older, shorter
    ``PartitionState`` by them)."""
    try:
        return list(_read_meta(path)["keys"])
    except FileNotFoundError:
        return None

"""Flash attention (tiled online-softmax attention) — the CUDA kernels of
``csrc/flash_attention.cu`` and their wrapper.

For q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) in f32 or bf16 (H a multiple
of Hkv: GQA), the attention of ``ref.attention_ref``: causal, a sliding
``window`` (0 = none), a logit ``softcap`` (0 = none) and the query
position offset ``q_offset`` of a decode step; keys at positions >= Sk are
always masked. The output has ``q``'s dtype; the softmax is f32.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel, ``pl.pallas_call`` at ``flash_attention.py:133``). Every kernel
folds the GQA group's query heads into its rows, so a K/V tile is read
once per group. ``dispatch`` picks one of three by dtype and shape, never
on failure:

* **f32** — CUDA cores, f32 FMA chains (the f32 tolerance of
  ``tests/test_kernels.py``, 2e-5, needs full f32 arithmetic);
* **prefill** (bf16) — ``mma.sync`` bf16 tensor cores for Q·Kᵀ and P·V
  (P as bf16 hi + lo), K/V tiles through a two-stage ``cp.async`` ring;
* **split** (bf16, decode-shaped: at most ``SPLIT_ROWS`` folded rows and
  fewer (batch, kv head) tiles than SMs) — the visible keys cut into
  ``split_plan`` chunks, one CTA each, then a combine kernel.

Every tensor is addressed through its own strides with D contiguous, so
the model's (B, S, H, D) tensors and cache slices, seen as (B, H, S, D)
by ``transpose(1, 2)``, launch without a copy; the output is allocated
with ``q``'s memory layout.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.common import (
    check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_lse_ref, attention_ref, split_plan,
)

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
BF16_HEAD_DIM = 16   # a bf16 head dim is a multiple of the mma's depth
ROW_TILE = 64        # folded rows per CTA of the prefill kernel
SPLIT_ROWS = 8       # at most this many folded rows take the split kernel
KERNELS = ("f32", "prefill", "split")

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
         + [ctypes.c_int] * 3 + [ctypes.c_float] * 2)
_EXTRA = {"f32": [], "prefill": [],
          "split": [ctypes.c_void_p] + [ctypes.c_int] * 4}


def _lib(kernel: str):
    fn = getattr(load_kernel("flash_attention"),
                 f"flash_attention_{kernel}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGS + _EXTRA[kernel] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec(dtype: torch.dtype) -> int:
    """Elements per 16-byte load: the alignment the kernels need."""
    return 4 if dtype == torch.float32 else 8


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D: (B, H, Sq, D), (B, Hkv, Sk, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"GQA needs H % Hkv == 0, got H={h}, Hkv={k.shape[1]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    step = BF16_HEAD_DIM if q.dtype == torch.bfloat16 else _vec(q.dtype)
    if d % step or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"the {q.dtype} kernels take a head dim that is a "
                         f"multiple of {step} up to {MAX_HEAD_DIM}, got {d}")
    vec = _vec(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must have D contiguous, the other strides multiples "
                f"of {vec} and a base aligned to 16 bytes; got strides "
                f"{t.stride()}")


def dispatch(q, k, *, causal: bool = True, window: int = 0,
             q_offset: int = 0, lse: bool = False) -> dict:
    """Which kernel a CUDA call with these q (B, H, Sq, D) and k (B, Hkv,
    Sk, D) launches: ``{"kernel": "f32" | "prefill" | "split", "n_split":
    int | None, "plan": split_plan's (lo, hi, chunk, n_split) | None}``.
    Decided by dtype and shape alone (and the SM count of q's card, 132
    for a CPU tensor, the H100's). A bf16 call of at most ``SPLIT_ROWS``
    folded rows takes ``split`` where its (batch × kv head) CTAs leave the
    card room for splits, and with ``lse`` (which only the split kernel
    gives) whatever their count: the SM count decides speed, not what
    the kernel can do."""
    num_sms = _num_sms(q.device) if q.device.type == "cuda" else 132
    b, h, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rows = sq * (h // hkv)
    how = {"kernel": "prefill", "n_split": None, "plan": None}
    if q.dtype == torch.float32:
        how["kernel"] = "f32"
    elif rows <= SPLIT_ROWS and (lse or b * hkv * -(-rows // ROW_TILE)
                                 < num_sms):
        plan = split_plan(sq, sk, causal=causal, window=window,
                          q_offset=q_offset, pairs=b * hkv, num_sms=num_sms)
        return {"kernel": "split", "n_split": plan[3], "plan": plan}
    return how


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    lse: bool = False):
    """(B, H, Sq, D) attention output in ``q.dtype``; with ``lse``, also
    each row's log-sum-exp of its visible logits, (B, H, Sq) f32
    (``ref.attention_lse_ref``), which a sequence-sharded decode merges
    blocks by. On the card the log-sum-exp is read from the split kernel's
    per-split partials (m, l), so ``lse`` takes a bf16 call of at most
    ``SPLIT_ROWS`` folded rows (``dispatch`` then picks ``split``) and
    raises on any other.

    A CUDA tensor launches the kernel ``dispatch`` names (one count in
    ``flash_attention.launches`` and in ``flash_attention.kernel_launches``
    per call, the split kernel's combine step included); a CPU tensor runs
    the plain version.

    A query row that sees no key (possible only with a window, at a
    position ``window`` or more past the last key; serving never makes
    one) has no defined output here: ``attention_ref`` gives the mean of
    all of V there, as JAX's does, the split kernel 0 (as
    ``attention_split_ref``), and the f32 and prefill kernels an average
    of V over the key tiles they loaded for the other rows of their CTA.
    """
    if not on_cuda(q, k, v):
        fn = attention_lse_ref if lse else attention_ref
        return fn(q, k, v, causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)       # q's layout if dense, else contiguous
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("attention over zero keys")
    how = dispatch(q, k, causal=causal, window=window, q_offset=q_offset,
                   lse=lse)
    if lse and how["kernel"] != "split":
        raise ValueError(f"the log-sum-exp comes from the split kernel's "
                         f"partials; this call takes {how['kernel']!r} (a "
                         f"bf16 call of at most {SPLIT_ROWS} folded rows "
                         f"takes split)")
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
            int(window), int(q_offset), float(d) ** -0.5, float(softcap)]
    if how["kernel"] == "prefill" and -(-sq * (h // hkv) // ROW_TILE) > 65535:
        raise ValueError(f"the prefill kernel takes at most {65535 * ROW_TILE} "
                         f"folded rows (Sq * H / Hkv), got {sq * (h // hkv)}")
    if how["kernel"] == "split":
        lo, hi, chunk, n_split = how["plan"]
        part = torch.empty(b * hkv * n_split * sq * (h // hkv) * (d + 2),
                           dtype=torch.float32, device=q.device)
        args += [part.data_ptr(), lo, hi, chunk, n_split]
    err = _lib(how["kernel"])(*args, stream_ptr(q.device))
    check_launch(err, f"flash_attention ({how['kernel']})")
    flash_attention.launches += 1
    flash_attention.kernel_launches[how["kernel"]] += 1
    if not lse:
        return out
    return out, _split_lse(part, b, hkv, h // hkv, sq, d, n_split)


def _split_lse(part, b, hkv, group, sq, d, n_split) -> torch.Tensor:
    """(B, H, Sq) natural log-sum-exp from the split kernel's partials
    ``[b][hkv][split][row][m, l, acc...]`` (m in log2 units, l the sum of
    2^(logit - m)): the combine kernel's rescaling, kept in logs."""
    p = part.view(b, hkv, n_split, sq * group, d + 2)
    m, l = p[..., 0], p[..., 1]
    top = torch.amax(m, dim=2, keepdim=True)
    tot = torch.sum(l * torch.exp2(m - top), dim=2)
    lse2 = top[:, :, 0] + torch.log2(tot)           # (b, hkv, sq * group)
    lse2 = lse2.view(b, hkv, sq, group).permute(0, 1, 3, 2)
    return (lse2 * math.log(2.0)).reshape(b, hkv * group, sq)


flash_attention.launches = 0
flash_attention.kernel_launches = dict.fromkeys(KERNELS, 0)

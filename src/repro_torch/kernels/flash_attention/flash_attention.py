"""Flash attention (tiled online-softmax attention) — the CUDA kernel
``csrc/flash_attention.cu`` and its wrapper.

For q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) in f32 or bf16 (H a multiple
of Hkv: GQA), the attention of ``ref.attention_ref``: causal, a sliding
``window`` (0 = none), a logit ``softcap`` (0 = none) and the query
position offset ``q_offset`` of a decode step; keys at positions >= Sk are
always masked. The output has ``q``'s dtype; everything inside is f32.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel at ``flash_attention.py:90``). One CTA owns one (batch, kv head,
tile of query rows) with the GQA group's query heads folded into the rows,
loops over 32-key K/V tiles in shared memory with the running max,
denominator and accumulator in f32 registers, and skips tiles that the
causal diagonal or the window masks for all of its rows. Prefill is bound
by operations, decode by the bytes of the visible K/V rows; the source
says more.

Every tensor is addressed through its own strides with D contiguous, so
the model's (B, S, H, D) tensors and cache slices, seen as (B, H, S, D)
by ``transpose(1, 2)``, launch without a copy; the output is allocated
with ``q``'s memory layout.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_launch, load_kernel, on_cuda, stream_ptr,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
_VEC = 4          # the kernel moves 4 elements at a time along D


def _lib():
    fn = load_kernel("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    if d % _VEC or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head dim that is a multiple of "
                         f"{_VEC} up to {MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % _VEC for s in t.stride()[:3]) \
                or t.data_ptr() % (_VEC * t.element_size()):
            raise ValueError(
                f"{name} must have D contiguous, the other strides multiples "
                f"of {_VEC} and a base aligned to {_VEC} elements; got strides "
                f"{t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """(B, H, Sq, D) attention output in ``q.dtype``.

    A CUDA tensor launches the kernel (and counts the launch in
    ``flash_attention.launches``); a CPU tensor runs the plain version.
    """
    if not on_cuda(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    _check(q, k, v)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)       # q's layout if dense, else contiguous
    if out.numel() == 0:
        return out
    if sk == 0:
        raise ValueError("attention over zero keys")
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
                 int(window), int(q_offset), float(d) ** -0.5, float(softcap),
                 int(q.dtype == torch.bfloat16), stream_ptr(q.device))
    check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

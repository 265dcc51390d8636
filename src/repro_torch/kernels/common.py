"""What the port's kernels share (the counterpart of
``repro.kernels.common``):

* **label-histogram masking** (``label_histogram``): affinity scoring is a
  one-hot histogram over neighbour labels where ``-1`` means "no neighbour
  here" and matches no partition id. ``partition_affinity`` and the fused
  chooser score through it, so their masking cannot drift.
* **the CUDA build** (``load_kernel``): the ONE place that compiles
  ``repro_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into a shared
  library with a plain C interface and loads it with ``ctypes``. The build
  runs at first use, into ``build/repro_torch/`` of the checkout, under a
  file name that carries a hash of the source, so a changed source is
  rebuilt and an unchanged one is loaded.
* **dispatch** (``on_cuda``): a wrapper runs its kernel exactly when its
  tensors lie on a CUDA device and its plain version exactly when they lie
  on the CPU. A CUDA device that is not sm_90, or a kernel that does not
  build or launch, raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def label_histogram(labels: torch.Tensor, k_max: int):
    """(…, D) int32 labels → ((…, K) scores, (…,) degree): ``scores[…, k]``
    counts labels equal to k and ``degree`` counts labels ``>= 0``. Labels
    ``-1`` (absent / padding) match no k."""
    ks = torch.arange(k_max, dtype=torch.int32, device=labels.device)
    scores = (labels[..., None] == ks).sum(dim=-2, dtype=torch.int32)
    deg = (labels >= 0).sum(dim=-1, dtype=torch.int32)
    return scores, deg


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the kernel runs), False
    when they lie on the CPU (the plain version runs); anything else —
    mixed devices, another device type, a card that is not sm_90 —
    raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel inputs must all lie on one CUDA device or all on the "
            f"CPU, got {sorted({str(t.device) for t in tensors})}")
    cap = torch.cuda.get_device_capability(tensors[0].device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(tensors[0].device)} is "
            f"sm_{cap[0]}{cap[1]}")
    return True


def check_input(t: torch.Tensor, name: str, dtype: torch.dtype,
                shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    (a wrapper's check before it hands a pointer to a kernel)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc was not found (set CUDA_HOME): the port's "
                           "kernels are built from source at first use")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes()
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_kernels(names) -> dict[str, Path]:
    """Compile every named ``csrc/<name>.cu`` that has no up-to-date
    library yet, one ``nvcc`` per source, all started together. Returns
    the library paths; ``<library>.log`` keeps each compiler's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    jobs = []
    for name, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(lib.with_suffix(".log"), "w")
        jobs.append((name, lib, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (nvcc exit {rc}, see {lib.with_suffix('.log')}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return targets


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_kernels([name])[name]))
        _LIBS[name] = lib
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError "
                           f"{err}")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

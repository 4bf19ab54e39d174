"""Build the CUDA C++ kernels of ``npcd_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into ``npcd_tpu_torch/build/<name>-<hash>.so`` (the
hash covers the source text and the flags, so an edited kernel rebuilds),
then loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds, not minutes. The wrappers in this package pass device
pointers and the current CUDA stream as ``c_void_p`` and raise when the C
entry point returns a non-zero ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def so_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(names: Iterable[str]) -> None:
    """Compile the named sources that are not built yet, in parallel."""
    todo = [n for n in names if not so_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, so_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> list:
    """Compile every ``csrc/*.cu`` (the chip smoke run's build phase)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    _compile(names)
    for name in names:
        load(name)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        _compile([name])
        lib = ctypes.CDLL(str(so_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def route(what: str, *tensors) -> str:
    """'cpu' when every tensor lies on the CPU (the wrapper then runs its
    plain PyTorch version), 'cuda' when all lie on one GPU (the wrapper
    launches its kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type in ("cpu", "cuda"):
        return device.type
    raise ValueError(f"{what}: no kernel or plain version for device {device}")


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def require_f32_contiguous(what: str, aligned: bool = True, **tensors) -> None:
    """float32, contiguous and, where the kernel reads float4s, 16-byte
    aligned."""
    import torch

    require_contiguous(what, torch.float32, aligned, **tensors)


def require_contiguous(what: str, dtype, aligned: bool = True, **tensors) -> None:
    """Of ``dtype``, contiguous and, where the kernel reads 16-byte vectors,
    16-byte aligned."""
    for name, t in tensors.items():
        require(t.dtype == dtype, what, f"{name} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), what, f"{name} must be contiguous")
        require(not aligned or t.data_ptr() % 16 == 0, what,
                f"{name} must be 16-byte aligned")


def count_launch(wrapper, dtype) -> None:
    """One more launch on ``wrapper``'s counter: ``launches_bf16`` for a
    bf16 launch, ``launches`` for any other."""
    import torch

    name = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream

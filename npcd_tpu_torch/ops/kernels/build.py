"""Build the CUDA C++ kernels of ``npcd_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into ``npcd_tpu_torch/build/<name>-<hash>.so`` (the
hash covers the source text, every ``csrc/*.cuh`` header and the flags,
so an edited kernel or header rebuilds), then loaded with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds, not
minutes. The wrappers in this package pass device pointers and the
current CUDA stream as ``c_void_p`` and raise when the C entry point
returns a non-zero ``cudaError_t``. ``load_host`` does the same for a host
routine, ``csrc/<name>.cpp``, with the host C++ compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def so_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


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


def cxx_path() -> str:
    for cand in ("c++", "g++"):
        found = shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++) found: the host routines of "
                       "npcd_tpu_torch/csrc/*.cpp are built with one")


def host_so_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    digest.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_host(source: Path, target: Path) -> None:
    """``source`` (C++) -> the shared library ``target``, compiled to a
    temporary file in its directory and renamed into place, so that
    processes building it at once never load a partial file."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    proc = subprocess.run([cxx_path(), *HOST_FLAGS, "-o", tmp, str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"the host C++ compiler failed on {source.name}:\n{proc.stdout}")
    os.replace(tmp, target)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host routine ``csrc/<name>.cpp``, built on
    first use."""
    with _host_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = host_so_path(name)
            if not path.exists():
                compile_host(CSRC / f"{name}.cpp", path)
            lib = ctypes.CDLL(str(path))
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

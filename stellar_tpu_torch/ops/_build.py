"""Builds the port's native code at first use, loads it with ctypes and
launches its kernels.

CUDA sources (``csrc/*.cu``) go through ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers: a few seconds to build, where a
``torch.utils.cpp_extension`` build takes minutes), under ``build/`` in the
repo, which git ignores. A library is rebuilt when the hash of its sources
or of its command changes. A missing compiler, a failed build or a failed
launch raises; nothing falls back.

Every kernel library ``<name>`` exports the same plain-C interface:

* ``int <name>_launch(in..., out, int n, [int extra...,] int device,
  void* stream)``: launch on ``stream`` without synchronising; returns
  ``cudaGetLastError()``;
* ``const char* <name>_error_string(int)``;
* for a library with a ``__constant__`` block, ``int <name>_consts_bytes()``
  and ``int <name>_set_consts(const void* host, int device)``, filled once
  per device from :func:`stellar_tpu_torch.state.port_tables`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import torch

__all__ = ["build_library", "build_log", "nvcc_path", "library",
           "library_path", "check_operands", "launch", "LIBRARIES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
KERNEL_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _Spec(NamedTuple):
    sources: Tuple[str, ...]  # the .cu first, then every header it reads
    consts: Optional[str]     # key of its __constant__ block in port_tables
    inputs: int               # device pointers before ``out``
    extra_ints: int           # int arguments after ``n``


LIBRARIES = {
    "verify_cold": _Spec(("verify_cold.cu", "verify_lanes.cuh",
                          "ge25519_x4.cuh", "ge25519.cuh", "fe25519.cuh",
                          "launch.cuh"), "kernel_consts", 4, 1),
    "verify_hot": _Spec(("verify_hot.cu", "verify_hot.cuh",
                         "ge25519_x4.cuh", "ge25519.cuh", "fe25519.cuh",
                         "launch.cuh"), "hot_kernel_consts", 4, 1),
    "sha256": _Spec(("sha256.cu", "sha256.cuh", "launch.cuh"), None, 2, 1),
    "verify_r16": _Spec(("verify_r16.cu", "verify_lanes.cuh",
                         "ge25519_x4.cuh", "ge25519.cuh", "fe25519.cuh",
                         "launch.cuh"), "r16_kernel_consts", 4, 0),
}

_locks = {name: threading.Lock() for name in LIBRARIES}
_libs: dict = {}
_consts_uploaded: set = set()  # (library, device index)


def build_library(out_path: str, sources, command) -> str:
    """Run ``command + ["-o", tmp]`` to build ``out_path`` unless a build
    from the same sources and command is already there. Several processes
    may race here: the build holds a file lock and lands by rename. The
    compiler's output is kept beside the library (``<out>.log``). Returns
    ``out_path``."""
    digest = hashlib.sha256(repr(list(command)).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()
    stamp = out_path + ".sha256"
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out_path) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read() == digest:
                    return out_path
        tmp = f"{out_path}.tmp{os.getpid()}"
        proc = subprocess.run(list(command) + ["-o", tmp],
                              capture_output=True, text=True, timeout=600)
        with open(out_path + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(out_path)} failed "
                f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out_path)
        with open(stamp, "w") as f:
            f.write(digest)
    return out_path


def build_log(out_path: str) -> str:
    """The compiler output kept by :func:`build_library` for a library."""
    with open(out_path + ".log") as f:
        return f.read()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> str:
    return os.path.join(KERNEL_DIR, f"lib{name}.so")


def _load(name: str):
    spec = LIBRARIES[name]
    src = [os.path.join(CSRC, s) for s in spec.sources]
    path = build_library(library_path(name), src,
                         [nvcc_path()] + NVCC_FLAGS + [src[0]])
    lib = ctypes.CDLL(path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [vp] * (spec.inputs + 1) + [i32] * (1 + spec.extra_ints) \
        + [i32, vp]
    fn.restype = i32
    fn = getattr(lib, f"{name}_error_string")
    fn.argtypes = [i32]
    fn.restype = ctypes.c_char_p
    if spec.consts is not None:
        fn = getattr(lib, f"{name}_set_consts")
        fn.argtypes = [vp, i32]
        fn.restype = i32
        fn = getattr(lib, f"{name}_consts_bytes")
        fn.argtypes = []
        fn.restype = i32
    return lib


def _error_string(name: str, lib, err: int) -> str:
    return getattr(lib, f"{name}_error_string")(err).decode()


def library(name: str, device: torch.device):
    """Kernel library ``name``, built and loaded on first use, with its
    ``__constant__`` block copied to ``device`` once per device."""
    from stellar_tpu_torch import state
    spec = LIBRARIES[name]
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = _load(name)
        if spec.consts is not None and \
                (name, device.index) not in _consts_uploaded:
            consts = state.port_tables()[spec.consts].contiguous()
            have = consts.numel() * consts.element_size()
            want = getattr(lib, f"{name}_consts_bytes")()
            if have != want:
                raise RuntimeError(f"{name}: the constants are {want} bytes "
                                   f"in csrc, {have} in state.py")
            err = getattr(lib, f"{name}_set_consts")(
                ctypes.c_void_p(consts.data_ptr()), device.index)
            if err != 0:
                raise RuntimeError(f"copying the {name} constants failed: "
                                   f"{_error_string(name, lib, err)}")
            _consts_uploaded.add((name, device.index))
    return lib


def check_operands(fn_name: str, ops, shapes) -> Tuple[torch.device, int]:
    """Check a kernel wrapper's operands: one device, CPU or CUDA, and
    ``ops[i]`` of dtype and shape ``(batch,) + tail`` for ``shapes[i] =
    (dtype, tail)``. Returns ``(device, batch)``; raises ``ValueError``."""
    dev = ops[0].device
    n = ops[0].shape[0] if ops[0].dim() > 0 else -1
    for t, (dtype, tail) in zip(ops, shapes):
        if t.device != dev:
            raise ValueError(f"{fn_name} operands are on different "
                             f"devices: {t.device} and {dev}")
        if t.dtype != dtype or tuple(t.shape) != (n,) + tuple(tail):
            want = ", ".join(f"(batch, {', '.join(map(str, tl))}) {dt}"
                             for dt, tl in shapes)
            raise ValueError(f"{fn_name} takes {want}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    return dev, n


def launch(name: str, inputs, out: torch.Tensor, n: int, *ints) -> None:
    """Launch kernel library ``name`` over ``n`` rows of ``inputs`` into
    ``out`` on the current stream of ``out``'s card. Raises on a build or
    launch failure."""
    dev = out.device
    lib = library(name, dev)
    # the kernels read with 8- and 16-byte loads: a view that starts off
    # that alignment is copied first
    inputs = [t.contiguous() for t in inputs]
    inputs = [t.clone() if t.data_ptr() % 16 else t for t in inputs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, f"{name}_launch")(
        *(ctypes.c_void_p(t.data_ptr()) for t in inputs),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
        *(ctypes.c_int(v) for v in ints), ctypes.c_int(dev.index),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({_error_string(name, lib, err)})")

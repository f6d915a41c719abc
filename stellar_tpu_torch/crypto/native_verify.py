"""ctypes bridge to the threaded native batch ed25519 verifier
(``native/ed25519_batch_verify.cpp``) and the port's host oracle — the
port's own copy of ``stellar_tpu/crypto/native_verify.py`` and of
``keys._host_oracle_batch``.

The C++ source runs the system libcrypto's EVP one-shot (loaded with
``dlopen`` at run time, so it builds with ``-ldl`` alone) over threads:
the same ref10-derived cofactorless equation as the per-call oracle.
It is built with ``g++`` into ``build/torch_native/``, apart from the JAX
package's library. The libsodium policy gate stays in Python
(:func:`stellar_tpu_torch.crypto.ed25519_ref._policy_gate`).

:func:`host_verify` is the host verifier the engine uses for the sampled
audit: the gate, then the equation through the
native batch, or through the pure-Python oracle when libcrypto cannot be
loaded, as the reference does. :func:`backend` says which one serves.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from stellar_tpu_torch.crypto import ed25519_ref as ref
from stellar_tpu_torch.ops._build import REPO_ROOT, build_library

__all__ = ["available", "backend", "verify_eq_batch", "host_verify"]

_SRC = os.path.join(REPO_ROOT, "native", "ed25519_batch_verify.cpp")
_LIB = os.path.join(REPO_ROOT, "build", "torch_native",
                    "libed25519verify.so")

_lock = threading.Lock()
_lib = None
_loaded = False


def _load():
    """The library, built at first use; None when libcrypto cannot be
    loaded at run time. A failed build raises."""
    global _lib, _loaded
    with _lock:
        if not _loaded:
            build_library(_LIB, [_SRC], ["g++", "-O2", "-shared", "-fPIC",
                                         "-pthread", _SRC, "-ldl"])
            lib = ctypes.CDLL(_LIB)
            vp = ctypes.c_void_p
            lib.ed25519_verify_available.restype = ctypes.c_int
            lib.ed25519_verify_batch.argtypes = [
                vp, vp, vp, vp, vp, ctypes.c_uint64, ctypes.c_int, vp]
            lib.ed25519_verify_batch.restype = ctypes.c_int
            _lib = lib if lib.ed25519_verify_available() == 1 else None
            _loaded = True
        return _lib


def available() -> bool:
    """True when the native batch can run (libcrypto loaded)."""
    return _load() is not None


def backend() -> str:
    """The host oracle's equation backend: ``"native"`` or ``"python"``."""
    return "native" if available() else "python"


def verify_eq_batch(pks: Sequence[bytes], msgs: Sequence[bytes],
                    sigs: Sequence[bytes], nthreads: int = 0) -> np.ndarray:
    """The curve equation for n well-formed (32-byte pk, msg, 64-byte
    sig) items, threaded; the caller applies the policy gate."""
    n = len(pks)
    out = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out.astype(bool)
    lib = _load()
    if lib is None:
        raise RuntimeError("the native verifier cannot load libcrypto")
    pk_blob = np.frombuffer(b"".join(pks), dtype=np.uint8)
    sig_blob = np.frombuffer(b"".join(sigs), dtype=np.uint8)
    blob = b"".join(msgs)
    msg_blob = np.frombuffer(blob, dtype=np.uint8) if blob else \
        np.zeros(1, dtype=np.uint8)
    lens = np.fromiter((len(m) for m in msgs), dtype=np.uint64, count=n)
    offs = np.zeros(n, dtype=np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    rc = lib.ed25519_verify_batch(pk_blob.ctypes.data, sig_blob.ctypes.data,
                                  msg_blob.ctypes.data, offs.ctypes.data,
                                  lens.ctypes.data, n, nthreads,
                                  out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"ed25519_verify_batch failed ({rc})")
    return out.astype(bool)


def host_verify(items: Sequence[tuple]) -> np.ndarray:
    """libsodium's decision for each (pk, msg, sig) triple, on the host:
    the policy gate, then the equation for the rows that pass it through
    the native batch, or the pure-Python oracle when libcrypto cannot be
    loaded."""
    out = np.zeros(len(items), dtype=bool)
    if not available():
        for i, (pk, msg, sig) in enumerate(items):
            out[i] = ref.verify(pk, msg, sig)
        return out
    idx = [i for i, (pk, _m, sig) in enumerate(items)
           if ref._policy_gate(pk, sig)]
    if idx:
        out[idx] = verify_eq_batch([items[i][0] for i in idx],
                                   [items[i][1] for i in idx],
                                   [items[i][2] for i in idx])
    return out

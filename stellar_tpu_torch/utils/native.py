"""ctypes bridge to the C++ bucket-stream runtime
(``native/bucket_stream.cpp``): record-framed stream hashing, joining,
splitting, and the sorted merge plan behind bucket merges — the port's
own copy of ``stellar_tpu/utils/native.py``'s bridge.

It builds the C++ source with ``g++`` through
:func:`stellar_tpu_torch.ops._build.build_library` into
``build/torch_native/``, apart from the JAX package's library (the build
holds a file lock, so concurrent processes do not race). This is host
code, not a device kernel: every entry point keeps the reference's
pure-Python fallback for a machine with no toolchain, and a differential
test holds the two together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import threading
from typing import List, Sequence, Tuple

from stellar_tpu_torch.ops._build import REPO_ROOT, build_library

__all__ = ["available", "sha256", "hash_frames", "join_frames",
           "split_frames", "merge_plan"]

_SRC = os.path.join(REPO_ROOT, "native", "bucket_stream.cpp")
_LIB = os.path.join(REPO_ROOT, "build", "torch_native",
                    "libbucketstream.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            build_library(_LIB, [_SRC],
                          ["g++", "-O2", "-shared", "-fPIC", _SRC])
            lib = ctypes.CDLL(_LIB)
            lib.bs_sha256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_char_p]
            lib.bs_hash_frames.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_char_p]
            lib.bs_join_frames.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_char_p]
            lib.bs_join_frames.restype = ctypes.c_uint64
            lib.bs_count_frames.argtypes = [ctypes.c_char_p,
                                            ctypes.c_uint64]
            lib.bs_count_frames.restype = ctypes.c_uint64
            lib.bs_split_frames.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.bs_split_frames.restype = ctypes.c_uint64
            lib.bs_merge_plan.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64)]
            lib.bs_merge_plan.restype = ctypes.c_uint64
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def sha256(data: bytes) -> bytes:
    lib = _load()
    if lib is None:
        return hashlib.sha256(data).digest()
    out = ctypes.create_string_buffer(32)
    lib.bs_sha256(data, len(data), out)
    return out.raw


def _pack_lens(lens: Sequence[int]):
    return (ctypes.c_uint64 * len(lens))(*lens)


def hash_frames(frames: Sequence[bytes]) -> bytes:
    """SHA-256 of the record-marked stream of ``frames`` (the bucket
    content hash)."""
    lib = _load()
    if lib is None:
        h = hashlib.sha256()
        for f in frames:
            h.update(struct.pack(">I", 0x80000000 | len(f)))
            h.update(f)
        return h.digest()
    blob = b"".join(frames)
    out = ctypes.create_string_buffer(32)
    lib.bs_hash_frames(blob, _pack_lens([len(f) for f in frames]),
                       len(frames), out)
    return out.raw


def join_frames(frames: Sequence[bytes]) -> bytes:
    lib = _load()
    if lib is None:
        return b"".join(struct.pack(">I", 0x80000000 | len(f)) + f
                        for f in frames)
    blob = b"".join(frames)
    total = len(blob) + 4 * len(frames)
    out = ctypes.create_string_buffer(total)
    n = lib.bs_join_frames(blob, _pack_lens([len(f) for f in frames]),
                           len(frames), out)
    return out.raw[:n]


def split_frames(raw: bytes) -> List[bytes]:
    lib = _load()
    if lib is None:
        out = []
        pos = 0
        while pos < len(raw):
            (marked,) = struct.unpack_from(">I", raw, pos)
            n = marked & 0x7FFFFFFF
            pos += 4
            out.append(raw[pos:pos + n])
            pos += n
        return out
    count = lib.bs_count_frames(raw, len(raw))
    if count == ctypes.c_uint64(-1).value:
        raise ValueError("corrupt record framing")
    offs = (ctypes.c_uint64 * count)()
    lens = (ctypes.c_uint64 * count)()
    lib.bs_split_frames(raw, len(raw), offs, lens)
    return [raw[offs[i]:offs[i] + lens[i]] for i in range(count)]


def merge_plan(keys_old: Sequence[bytes], keys_new: Sequence[bytes]
               ) -> List[Tuple[int, int, int]]:
    """Sorted two-way merge plan: [(side, i_old, i_new)] with side
    0=old-only, 1=new-only, 2=equal keys. Inputs sorted ascending."""
    lib = _load()
    if lib is None:
        out = []
        i = j = 0
        while i < len(keys_old) and j < len(keys_new):
            if keys_old[i] < keys_new[j]:
                out.append((0, i, 0))
                i += 1
            elif keys_new[j] < keys_old[i]:
                out.append((1, 0, j))
                j += 1
            else:
                out.append((2, i, j))
                i += 1
                j += 1
        out.extend((0, k, 0) for k in range(i, len(keys_old)))
        out.extend((1, 0, k) for k in range(j, len(keys_new)))
        return out
    n_old, n_new = len(keys_old), len(keys_new)
    total = n_old + n_new
    sides = (ctypes.c_uint8 * max(1, total))()
    io = (ctypes.c_uint64 * max(1, total))()
    jn = (ctypes.c_uint64 * max(1, total))()
    w = lib.bs_merge_plan(
        b"".join(keys_old), _pack_lens([len(k) for k in keys_old]), n_old,
        b"".join(keys_new), _pack_lens([len(k) for k in keys_new]), n_new,
        sides, io, jn)
    return [(sides[k], io[k], jn[k]) for k in range(w)]

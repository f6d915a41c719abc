"""Batched SHA-256 (K3) — the port of ``stellar_tpu/ops/sha256.py``.

FIPS 180-4 SHA-256 over a batch of independent messages, one message a
row: the device half of :class:`stellar_tpu_torch.crypto.batch_hasher.
BatchHasher`. Padding and big-endian word packing are host work
(:func:`pack_messages`); the device gets fixed-shape word blocks and a
per-(message, block) ``active`` flag.

* :func:`sha256_kernel_plain` is the plain PyTorch version, the
  reference's round for round. PyTorch's ``uint32`` tensors have few
  operations, so it reinterprets the words as int32, computes in int64
  masked to 32 bits and reinterprets the result back: the same uint32
  word values.
* :func:`sha256_kernel` launches the hand-written CUDA kernel
  (``csrc/sha256.cu``) for CUDA tensors and takes the plain version only
  for CPU tensors. ``sha256_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from stellar_tpu_torch.ops import _build

__all__ = ["sha256_kernel", "sha256_kernel_plain", "pack_messages",
           "digest_words_to_bytes", "host_digest_words", "blocks_needed",
           "max_message_bytes", "K", "H0"]

# FIPS 180-4 constants: the first 32 bits of the fractional parts of the
# cube roots of the first 64 primes (K) and of the square roots of the
# first 8 primes (H0).
K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)

H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
      0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

_MASK32 = 0xFFFFFFFF


def blocks_needed(msg_len: int) -> int:
    """64-byte compression blocks after FIPS padding (0x80 + length)."""
    return (msg_len + 9 + 63) // 64


def max_message_bytes(max_blocks: int) -> int:
    """Longest message that fits ``max_blocks`` blocks after padding."""
    return max_blocks * 64 - 9


def _madd(*terms):
    """Masked mod-2^32 add as the reference's: the terms' 16-bit halves
    are summed apart (each half's sum stays under 2^19), then one carry
    and a recombine of disjoint pieces, so no intermediate reaches
    2^32."""
    lo = hi = None
    for t in terms:
        tl, th = t & 0xFFFF, t >> 16
        lo = tl if lo is None else lo + tl
        hi = th if hi is None else hi + th
    hi = hi + (lo >> 16)
    return ((hi & 0xFFFF) << 16) + (lo & 0xFFFF)


def _rotr(x, n: int):
    """rotr32 as the reference's: the left shift's operand is first
    masked to its low ``n`` bits, so no intermediate reaches 2^32."""
    return (x >> n) | ((x & ((1 << n) - 1)) << (32 - n))


def sha256_kernel_plain(words, active):
    """Plain PyTorch K3: (batch, max_blocks, 16) uint32 big-endian message
    words and (batch, max_blocks) bool -> (batch, 8) uint32 digest word
    values. Inactive blocks leave the state as it is, so a row with no
    active block returns H0. Each round as the reference's: the schedule
    comes from a rolling 16-word window, the message word for rounds
    below 16."""
    w = words.view(torch.int32).to(torch.int64) & _MASK32
    batch, blocks = w.shape[0], w.shape[1]
    state = [torch.full((batch,), v, dtype=torch.int64, device=w.device)
             for v in H0]
    for blk in range(blocks):
        win = [w[:, blk, i] for i in range(16)]
        a, b, c, d, e, f, g, h = state
        for i in range(64):
            if i < 16:
                w_i = win[0]
            else:
                s0 = _rotr(win[1], 7) ^ _rotr(win[1], 18) ^ (win[1] >> 3)
                s1 = _rotr(win[14], 17) ^ _rotr(win[14], 19) ^ \
                    (win[14] >> 10)
                w_i = _madd(win[0], s0, win[9], s1)
            win = win[1:] + [w_i]
            big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = g ^ (e & (f ^ g))
            t1 = _madd(h, big_s1, ch, K[i], w_i)
            big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            t2 = _madd(big_s0, maj)
            a, b, c, d, e, f, g, h = (_madd(t1, t2), a, b, c,
                                      _madd(d, t1), e, f, g)
        summed = [_madd(s, v) for s, v in
                  zip(state, (a, b, c, d, e, f, g, h))]
        state = [torch.where(active[:, blk], s, v)
                 for s, v in zip(summed, state)]
    # int64 -> int32 keeps the low 32 bits
    return torch.stack(state, dim=1).to(torch.int32).view(torch.uint32)


def sha256_kernel(words, active):
    """K3: (batch, max_blocks, 16) uint32 words, (batch, max_blocks) bool
    active -> (batch, 8) uint32 digest word values.

    CUDA tensors launch ``csrc/sha256.cu`` on the current stream (no
    synchronise); CPU tensors run :func:`sha256_kernel_plain`; any other
    device raises. A build or launch failure raises — nothing falls
    back."""
    blocks = words.shape[1] if words.dim() == 3 else -1
    dev, n = _build.check_operands(
        "sha256_kernel", (words, active),
        ((torch.uint32, (blocks, 16)), (torch.bool, (blocks,))))
    if dev.type == "cpu":
        return sha256_kernel_plain(words, active)
    out = torch.empty((n, 8), dtype=torch.uint32, device=dev)
    if n:
        _build.launch("sha256", (words, active), out, n, blocks)
        sha256_kernel.launches += 1
    return out


sha256_kernel.launches = 0


def pack_messages(msgs, max_blocks: int):
    """FIPS-pad and word-pack ``msgs`` for :func:`sha256_kernel`.

    Returns ``(words, active, fits)``: the kernel's inputs as numpy arrays
    plus a bool row mask, False where a message needs more than
    ``max_blocks`` blocks (such a row is hashed on the host; its words and
    active flags stay zero and give H0 on the device, which the caller
    discards)."""
    n = len(msgs)
    words = np.zeros((n, max_blocks, 16), dtype=np.uint32)
    active = np.zeros((n, max_blocks), dtype=bool)
    fits = np.ones(n, dtype=bool)
    for i, m in enumerate(msgs):
        nb = blocks_needed(len(m))
        if nb > max_blocks:
            fits[i] = False
            continue
        padded = (m + b"\x80" + b"\x00" * ((-(len(m) + 9)) % 64)
                  + (8 * len(m)).to_bytes(8, "big"))
        words[i, :nb] = np.frombuffer(padded, dtype=">u4").reshape(nb, 16)
        active[i, :nb] = True
    return words, active, fits


def digest_words_to_bytes(row: np.ndarray) -> bytes:
    """(8,) uint32 word values -> the canonical 32-byte digest."""
    return np.asarray(row, dtype=np.uint32).astype(">u4").tobytes()


def host_digest_words(msgs) -> np.ndarray:
    """hashlib digests as (n, 8) uint32 word values: the oracle in the
    kernel's output representation."""
    out = np.zeros((len(msgs), 8), dtype=np.uint32)
    for i, m in enumerate(msgs):
        out[i] = np.frombuffer(hashlib.sha256(m).digest(),
                               dtype=">u4").astype(np.uint32)
    return out

"""The batch ed25519 verify kernels — the port of
``stellar_tpu/ops/verify.py``.

Given a batch of rows with ``h = SHA512(R||A||M) mod L`` computed on the
host (:mod:`stellar_tpu_torch.crypto.batch_verifier`):

* K1, :func:`verify_kernel`, the cold path, on (A, R, s, h): the device
  bit is ``decompress_ok(A) AND encode(s*B + h*(-A)) == R`` bytewise;
* K2, :func:`verify_kernel_hot`, the hot-signer path, on (table of -A,
  R, s, h), the table being the signer-table cache's 128 affine cached
  multiples of -A: the bit is ``encode(s*B + h*(-A)) == R``, with no
  decompression (cache membership is its proof);
* K5, :func:`verify_kernel_r16`, K1's bit from the radix-16 arm (64
  signed digits, 8-entry projective cached tables): the composition the
  reference's radix sweep builds (``tools/kernel_cost.py``). Its top digit
  overflows for a scalar >= 9 * 2^252: the select then yields the zero
  point, the accumulator ends at (0, 0, 0), and the bit is
  ``decompress_ok(A) AND R == 0``, as in the reference;
* K4, :func:`verify_kernel_sharded`, K1 over a list of devices: the batch
  split into one shard a device, no cross-device traffic.

Both hold for every 32-byte pattern of each scalar operand; the host's
policy gate (canonical s and A, small-order R and A, lengths) is ANDed in
afterwards.

* ``*_plain`` are the plain PyTorch versions, op for op the JAX
  functions, so their limbs and bits match the reference exactly.
* :func:`verify_kernel`, :func:`verify_kernel_hot` and
  :func:`verify_kernel_r16` launch the hand-written CUDA kernels
  (``csrc/verify_cold.cu``, ``csrc/verify_hot.cu``, ``csrc/verify_r16.cu``)
  for CUDA tensors and take the plain versions only for CPU tensors. All
  three run four threads a row, one coordinate of the accumulator each,
  on the two-round parallel Edwards formulas of ``csrc/ge25519_x4.cuh``;
  K1 and K5 are one row function (``csrc/verify_lanes.cuh``) at 5 and 4
  bits a window.
  ``.launches`` on each counts its kernel launches; on
  :func:`verify_kernel_sharded` it counts the calls of its callables that
  launched K1 on the card.
"""

from __future__ import annotations

import contextlib

import torch

from stellar_tpu_torch.ops import _build
from stellar_tpu_torch.ops import edwards as ed
from stellar_tpu_torch.ops import field25519 as fe

__all__ = ["verify_kernel", "verify_kernel_plain", "signed_digits32",
           "verify_kernel_hot", "verify_kernel_hot_plain",
           "signed_digits256", "signed_digits16", "verify_kernel_r16",
           "verify_kernel_r16_plain", "verify_kernel_sharded"]


def _signed_window_carry_chain(e, window_bits: int):
    """Unsigned window values (windows, batch), LEAST significant first ->
    signed digits, MOST significant first, in [-half, half) except the top
    digit, which keeps the final carry unsigned so that
    sum(d_i * 2^(window_bits*i)) == s exactly. The carry into window i+1
    is generate_i | (propagate_i & carry_i), generate at e_i >= half,
    propagate at e_i == half - 1 — the recurrence the reference evaluates
    as an associative scan, here as a loop over the windows."""
    windows = e.shape[0]
    half = 1 << (window_bits - 1)
    gen = e >= half
    prop = e == half - 1
    carries = [torch.zeros_like(gen[0])]
    for i in range(windows):
        carries.append(gen[i] | (prop[i] & carries[i]))
    c = torch.stack(carries).to(torch.int32)  # c[i] = carry into window i
    carry_out = c[1:].clone()
    carry_out[-1] = 0  # the top window keeps its carry unsigned
    d = e + c[:-1] - (carry_out << window_bits)
    return d.flip(0)


def signed_digits16(b):
    """(batch, 32) uint8 little-endian scalars -> (64, batch) int32 signed
    radix-16 digits, most significant first: the nibbles are the windows.
    Digits lie in [-8, 8), the top digit in [0, 16] for EVERY 256-bit
    scalar: at most 8 for s < 9 * 2^252, above 8 beyond it."""
    x = b.to(torch.int32)
    e = torch.stack([x & 15, x >> 4], dim=2).reshape(b.shape[0], 64).T
    return _signed_window_carry_chain(e, 4)


def signed_digits32(b):
    """(batch, 32) uint8 little-endian scalars -> (52, batch) int32 signed
    radix-32 digits, most significant first. Digits lie in [-16, 16), the
    top digit in [0, 2], for EVERY 256-bit scalar."""
    nbatch = b.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = ((b[:, :, None].to(torch.int32) >> shifts) & 1).reshape(nbatch,
                                                                     256)
    bits = torch.cat([bits, torch.zeros_like(bits[:, :4])], dim=1)
    weights = torch.arange(5, dtype=torch.int32, device=b.device)
    e = (bits.reshape(nbatch, 52, 5) << weights).sum(-1, dtype=torch.int32)
    return _signed_window_carry_chain(e.T, 5)


def verify_kernel_plain(a_bytes, r_bytes, s_bytes, h_bytes):
    """Plain PyTorch K1 on four (batch, 32) uint8 tensors -> (batch,) bool."""
    ok, a = ed.decompress(a_bytes)
    rprime = ed.double_scalarmult(signed_digits32(s_bytes),
                                  signed_digits32(h_bytes), ed.negate(a))
    return ok & ed.compress_equals(rprime, r_bytes)


def signed_digits256(b):
    """(batch, 32) uint8 little-endian scalars -> (32, batch) int32 signed
    radix-256 digits, most significant first: the bytes are the windows.
    Digits lie in [-128, 128), the top digit in [0, 256], for EVERY 256-bit
    scalar; above 128 only when the top byte is 0x81 or more, or 0x80 with
    a carry into it."""
    return _signed_window_carry_chain(b.to(torch.int32).T, 8)


def verify_kernel_hot_plain(a_table, r_bytes, s_bytes, h_bytes):
    """Plain PyTorch K2: a (batch, 128, 3, 20) int16 table of -A and three
    (batch, 32) uint8 tensors -> (batch,) bool."""
    tab = a_table.movedim(0, -1)  # (128, 3, 20, batch)
    rprime = ed.double_scalarmult_hot(signed_digits256(s_bytes),
                                      signed_digits256(h_bytes), tab)
    return ed.compress_equals(rprime, r_bytes)


def verify_kernel_r16_plain(a_bytes, r_bytes, s_bytes, h_bytes):
    """Plain PyTorch K5 on four (batch, 32) uint8 tensors -> (batch,)
    bool: K1's composition with the radix-16 recode and loop."""
    ok, a = ed.decompress(a_bytes)
    rprime = ed.double_scalarmult(signed_digits16(s_bytes),
                                  signed_digits16(h_bytes), ed.negate(a))
    return ok & ed.compress_equals(rprime, r_bytes)


_ROW = (torch.uint8, (32,))
_COLD_SHAPES = (_ROW,) * 4
_HOT_SHAPES = ((torch.int16, (ed.TABLE_ENTRIES256, ed.AFFINE_COORDS,
                              fe.NLIMBS)),
               _ROW, _ROW, _ROW)


# K1's and K2's threads a block, four a row: the picks of chip_smoke.py's
# sweeps (K1 flat from 64 up; K2 fastest at 128, its staged B-table shared
# by 32 rows)
COLD_BLOCK_THREADS = 64
HOT_BLOCK_THREADS = 128


def _verify(name, wrapper, plain, ops, shapes, *ints):
    dev, n = _build.check_operands(wrapper.__name__, ops, shapes)
    if dev.type == "cpu":
        return plain(*ops)
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        _build.launch(name, ops, out, n, *ints)
        wrapper.launches += 1
    return out


def verify_kernel(a_bytes, r_bytes, s_bytes, h_bytes):
    """K1: (batch, 32) uint8 A, R, s, h -> (batch,) bool.

    CUDA tensors launch ``csrc/verify_cold.cu`` (four threads a row) on
    the current stream (no synchronise); CPU tensors run
    :func:`verify_kernel_plain`; any other device raises. A build or
    launch failure raises — nothing falls back."""
    return _verify("verify_cold", verify_kernel, verify_kernel_plain,
                   (a_bytes, r_bytes, s_bytes, h_bytes), _COLD_SHAPES,
                   COLD_BLOCK_THREADS)


def verify_kernel_hot(a_table, r_bytes, s_bytes, h_bytes):
    """K2: (batch, 128, 3, 20) int16 table of -A, (batch, 32) uint8 R, s,
    h -> (batch,) bool.

    CUDA tensors launch ``csrc/verify_hot.cu`` (four threads a row) on
    the current stream (no synchronise); CPU tensors run
    :func:`verify_kernel_hot_plain`; any other device raises. A build or
    launch failure raises — nothing falls back."""
    return _verify("verify_hot", verify_kernel_hot, verify_kernel_hot_plain,
                   (a_table, r_bytes, s_bytes, h_bytes), _HOT_SHAPES,
                   HOT_BLOCK_THREADS)


def verify_kernel_r16(a_bytes, r_bytes, s_bytes, h_bytes):
    """K5: (batch, 32) uint8 A, R, s, h -> (batch,) bool, K1's bit from
    the radix-16 arm.

    CUDA tensors launch ``csrc/verify_r16.cu`` (four threads a row) on
    the current stream (no synchronise); CPU tensors run
    :func:`verify_kernel_r16_plain`; any other device raises. A build or
    launch failure raises — nothing falls back."""
    return _verify("verify_r16", verify_kernel_r16, verify_kernel_r16_plain,
                   (a_bytes, r_bytes, s_bytes, h_bytes), _COLD_SHAPES)


def verify_kernel_sharded(devices):
    """K4: K1 split over ``devices`` (the counterpart of the reference's
    ``verify_kernel_sharded(mesh)``, K1 under ``shard_map`` over a 1-D
    mesh). Returns a callable with :func:`verify_kernel`'s signature. The
    batch must divide by the device count; shard j is copied to
    ``devices[j]`` and K1 runs there on that device's current stream (the
    plain version for a CPU device); the bits come back in order on
    ``devices[0]``. There is no collective: each device verifies its own
    rows. A device may be named more than once."""
    devs = [torch.device(d) for d in devices]
    if not devs or len({d.type for d in devs}) != 1:
        raise ValueError(f"verify_kernel_sharded takes a non-empty list of "
                         f"devices of one type; got {devices!r}")
    on_card = devs[0].type == "cuda"
    devs = [torch.device("cuda", d.index or 0) if on_card else d
            for d in devs]

    def sharded(a_bytes, r_bytes, s_bytes, h_bytes):
        ops = (a_bytes, r_bytes, s_bytes, h_bytes)
        _dev, n = _build.check_operands("verify_kernel_sharded", ops,
                                        _COLD_SHAPES)
        if n % len(devs):
            raise ValueError(f"verify_kernel_sharded: a batch of {n} rows "
                             f"does not divide over {len(devs)} devices")
        sub = n // len(devs)
        outs = []
        for j, dev in enumerate(devs):
            with torch.cuda.device(dev) if on_card \
                    else contextlib.nullcontext():
                shard = tuple(t[j * sub:(j + 1) * sub].to(
                    dev, non_blocking=True) for t in ops)
                outs.append(verify_kernel(*shard))
        out = torch.cat([o.to(devs[0], non_blocking=True) for o in outs])
        if on_card and n:
            verify_kernel_sharded.launches += 1
        return out

    return sharded


verify_kernel.launches = 0
verify_kernel_hot.launches = 0
verify_kernel_r16.launches = 0
verify_kernel_sharded.launches = 0

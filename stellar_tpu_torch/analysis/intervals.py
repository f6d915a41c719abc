"""Interval-domain abstract interpretation over the aten op stream.

The verify kernels' correctness rests on a range claim: with 13-bit limbs
bounded by ``LOOSE_MAX``, every schoolbook-product coefficient stays below
2^31 (``ops/field25519.py``). This module machine-checks it on the port's
plain PyTorch versions, op for op the reference's kernels: it runs a
stage eagerly on small CPU tensors under ``torch.func.functionalize(fn,
remove="mutations_and_views")`` — so an in-place slice-add such as
``acc[i:i + 20] += a[i] * b`` arrives as ``slice_copy``/``add``/
``slice_scatter`` — with a ``TorchDispatchMode`` that carries, beside
every tensor, per-element ``[lo, hi]`` intervals in exact integer
arithmetic and flags every op whose output interval escapes its dtype.

Design notes:

* **Eager, not traced.** No FX graph of a stage is built (a graph of the
  whole kernel costs minutes); the ops are interpreted as they run. The
  concrete values computed beside the intervals only drive the op stream:
  the plain versions do not branch on data, and a Python branch on a
  tensor's value (``is_nonzero``, ``item``) raises :class:`Unsupported`.
* **Exact integer intervals, saturated at 2^61.** Bounds are int64;
  products, shifts and sums are float64-guarded and saturate at ``SAT``
  rather than wrap, so an overflowed bound never launders itself back
  into range. Saturation only ever keeps a bound out of a <=32-bit dtype's
  range, and every op is checked at its own site. An op whose output is a
  64-bit integer (the SHA-256 plain version computes its words in int64)
  is interpreted in exact Python integers instead, so its fit is proven,
  not saturated.
* **Batch-collapsed storage.** Bounds are uniform along the batch axis,
  so abstract arrays store size-1 dims wherever the interval is uniform
  (numpy broadcasting does the rest): a proof at batch 1 covers every
  batch, while the limb axis keeps full per-limb resolution.
* **Repeated calls.** Every loop of the plain versions is unrolled
  Python, so the field and group functions run thousands of times with
  the same input intervals. :meth:`IntervalInterpreter.run` can take a
  list of such functions (:data:`MEMO_FUNCTIONS` by default): a call
  whose input intervals, shapes and other arguments equal an earlier
  call's gets that call's output intervals without re-running its ops.
  The op stream of these functions depends on their arguments' shapes
  only, so this is exactly the result re-interpretation would give — the
  counterpart of the reference's incremental scan-body evaluator.
* **Loud by construction.** Any op without a rule, a float dtype, or a
  tensor of unknown origin (neither an input, an op's output, nor a
  constant lifted into the function) raises :class:`Unsupported`: the
  prover refuses to claim a proof over code it did not model.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "AbsVal", "Violation", "Unsupported", "IntervalInterpreter",
    "interval_for_dtype", "numpy_dtype", "SAT", "MEMO_FUNCTIONS",
]

# Saturation bound for abstract values: far above any <=32-bit dtype,
# far below int64 wraparound even after one addition.
SAT = np.int64(1) << np.int64(61)

_ATTR = "_stellar_interval"
_aten = torch.ops.aten

# The field and group functions whose repeated calls are served from the
# interpreter's table (module, function name), in the port's ops.
MEMO_FUNCTIONS = (
    ("stellar_tpu_torch.ops.field25519", "mul"),
    ("stellar_tpu_torch.ops.field25519", "sqr"),
    ("stellar_tpu_torch.ops.field25519", "add"),
    ("stellar_tpu_torch.ops.field25519", "sub"),
    ("stellar_tpu_torch.ops.field25519", "neg"),
    ("stellar_tpu_torch.ops.field25519", "mul_small"),
    ("stellar_tpu_torch.ops.field25519", "canon"),
    ("stellar_tpu_torch.ops.edwards", "point_double"),
    ("stellar_tpu_torch.ops.edwards", "point_add_cached"),
    ("stellar_tpu_torch.ops.edwards", "table_select_affine"),
    ("stellar_tpu_torch.ops.sha256", "_rotr"),
)


class Unsupported(Exception):
    """The op stream uses an op or feature outside the verified subset."""


@dataclasses.dataclass
class Violation:
    """One op whose output interval escapes its dtype."""
    path: str          # the stage, e.g. "dsm"
    eqn_index: int     # the op's position in the stage's stream
    primitive: str     # the aten op, e.g. "mul"
    dtype: str
    lo: int
    hi: int
    dtype_min: int
    dtype_max: int
    where: str         # the port's source line that ran the op

    def describe(self) -> str:
        return (f"{self.path}[{self.eqn_index}] {self.primitive} -> "
                f"[{self.lo}, {self.hi}] escapes {self.dtype} "
                f"[{self.dtype_min}, {self.dtype_max}] at {self.where}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_TORCH_TO_NUMPY = {
    torch.bool: np.dtype(np.bool_), torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8), torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64),
    torch.uint16: np.dtype(np.uint16), torch.uint32: np.dtype(np.uint32),
    torch.uint64: np.dtype(np.uint64),
}


def numpy_dtype(dtype) -> np.dtype:
    """A torch or numpy integer dtype as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        got = _TORCH_TO_NUMPY.get(dtype)
        if got is None:
            raise Unsupported(f"non-integer dtype {dtype} in a checked op")
        return got
    return np.dtype(dtype)


def interval_for_dtype(dtype) -> Tuple[int, int]:
    dtype = numpy_dtype(dtype)
    if dtype == np.bool_:
        return 0, 1
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return int(info.min), int(info.max)
    raise Unsupported(f"non-integer dtype {dtype} in a checked op")


def _exact(a: np.ndarray) -> bool:
    return a.dtype == object


def _clamp(a: np.ndarray) -> np.ndarray:
    if _exact(a):
        return a
    return np.clip(a, -SAT, SAT)


def _safe_mul(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Exact int64 product, saturated where float64 says it would leave
    [-SAT, SAT] (float magnitude error is negligible at the 2^61 scale);
    exact Python integers for object arrays."""
    if _exact(x) or _exact(y):
        return np.asarray(x, dtype=object) * np.asarray(y, dtype=object)
    fx = x.astype(np.float64) * y.astype(np.float64)
    big = np.abs(fx) >= float(SAT)
    with np.errstate(over="ignore"):
        exact = x * y
    if not big.any():
        return exact
    return np.where(big, np.where(fx > 0, SAT, -SAT), exact)


def _safe_sum(a: np.ndarray, axis: int) -> np.ndarray:
    if _exact(a):
        return a.sum(axis=axis)
    f = a.astype(np.float64).sum(axis=axis)
    big = np.abs(f) >= float(SAT)
    exact = a.sum(axis=axis)
    if not big.any():
        return exact
    return np.where(big, np.where(f > 0, SAT, -SAT), exact)


def _bitmask_bound(hi: np.ndarray) -> np.ndarray:
    """Smallest all-ones mask covering ``hi`` (elementwise, hi >= 0):
    7 -> 7, 8 -> 15, 2^32-1 -> 2^32-1. The sound upper bound for OR/XOR
    of non-negative values — neither can set a bit above the highest bit
    of either operand."""
    if _exact(hi):
        return np.frompyfunc(
            lambda h: (1 << int(h).bit_length()) - 1 if h > 0 else 0,
            1, 1)(hi).astype(object)
    h = np.maximum(np.asarray(hi, dtype=np.int64), 0)
    out = np.zeros_like(h)
    nz = h > 0
    if nz.any():
        bits = np.ceil(np.log2(h[nz].astype(np.float64) + 1.0))
        cand = (np.int64(1) << bits.astype(np.int64)) - 1
        # float rounding safety: the mask must COVER hi
        short = cand < h[nz]
        cand = np.where(short, (cand << 1) | 1, cand)
        out[nz] = cand
    return _clamp(out)


class AbsVal:
    """Interval abstraction of one tensor.

    ``lo``/``hi`` are int64 arrays broadcast-compatible with the concrete
    ``shape``: any dim may be stored with size 1 when the bound is uniform
    along it (the batch axis always is).

    ``excl`` is a relational refinement: the set of axes along which AT
    MOST ONE element is nonzero (for every fixed index of the other axes).
    It is born at ``eq(pairwise-distinct constant, uniform)`` — the one-hot
    idiom — survives convert/broadcast/reshape/multiply, and is consumed
    by ``sum``, which then takes the union bound instead of the sum.
    Without it, a radix-16 window select's ``(table * onehot).sum(0)``
    would bound a selected limb at 8x an entry.

    ``vuni`` is the companion refinement that makes ``excl``'s birth
    sound: the set of axes along which the runtime VALUE is provably the
    same at every position. Only an expand (size-1 -> N), an inserted or
    size-1 axis, or a uniform constant establishes it — uniform *bounds*
    (stored-size-1) never do, because an input can vary within uniform
    bounds.

    ``unsigned`` is set on a narrowing integer conversion whose input fits
    the unsigned type of the target's width (``int64 -> int32`` of a
    word in [0, 2^32 - 1]): the target holds the word's bits, and a
    reinterpretation as that unsigned type recovers the exact interval."""

    __slots__ = ("lo", "hi", "shape", "dtype", "excl", "vuni", "unsigned",
                 "_key")

    def __init__(self, lo, hi, shape, dtype, excl=frozenset(),
                 vuni=frozenset(), unsigned=None):
        lo = np.asarray(lo)
        hi = np.asarray(hi)
        if lo.dtype != object:
            lo = lo.astype(np.int64, copy=False)
        if hi.dtype != object:
            hi = hi.astype(np.int64, copy=False)
        self.lo, self.hi = lo, hi
        self.shape = tuple(int(s) for s in shape)
        self.dtype = numpy_dtype(dtype)
        self.excl = frozenset(excl)
        self.vuni = frozenset(vuni)
        self.unsigned = unsigned
        self._key = None
        if lo.shape != hi.shape or lo.ndim != len(self.shape):
            raise AssertionError(
                f"stored {lo.shape}/{hi.shape} vs concrete {self.shape}")
        for stored, concrete in zip(lo.shape, self.shape):
            if stored not in (1, concrete):
                raise AssertionError(
                    f"stored {lo.shape} vs concrete {self.shape}")

    # ---------------- constructors ----------------

    @classmethod
    def from_concrete(cls, value, dtype=None) -> "AbsVal":
        """The exact interval of a known value (a constant)."""
        if isinstance(value, torch.Tensor):
            if value.dtype not in _TORCH_TO_NUMPY:
                raise Unsupported(f"constant of dtype {value.dtype}")
            dtype = value.dtype if dtype is None else dtype
            a = value.detach().cpu().numpy()
        else:
            a = np.asarray(value)
        if a.dtype.kind not in "biu":
            raise Unsupported(f"non-integer constant dtype {a.dtype}")
        ai = a.astype(np.int64)
        out = cls(ai, ai, a.shape, a.dtype if dtype is None else dtype
                  ).collapsed()
        # a constant's collapsed axes really are value-uniform (the exact
        # values are known: lo == hi)
        out.vuni = frozenset(ax for ax in range(out.lo.ndim)
                             if out.lo.shape[ax] == 1)
        return out

    @classmethod
    def from_range(cls, shape, dtype, lo: int, hi: int) -> "AbsVal":
        """Every element anywhere in ``[lo, hi]``, independently."""
        shape = tuple(shape)
        one = (1,) * len(shape)
        # only size-1 concrete extents are value-uniform: an input varies
        # freely within its (uniform) bounds
        return cls(np.full(one, lo, np.int64), np.full(one, hi, np.int64),
                   shape, dtype,
                   vuni=frozenset(ax for ax, s in enumerate(shape)
                                  if s == 1))

    @classmethod
    def top(cls, shape, dtype) -> "AbsVal":
        lo, hi = interval_for_dtype(dtype)
        return cls.from_range(shape, dtype, lo, hi)

    # ---------------- views ----------------

    def materialize(self, axes: Sequence[int]):
        """lo/hi broadcast to concrete size along the given axes."""
        tgt = list(self.lo.shape)
        for ax in axes:
            tgt[ax] = self.shape[ax]
        return (np.broadcast_to(self.lo, tgt), np.broadcast_to(self.hi, tgt))

    def full(self):
        return (np.broadcast_to(self.lo, self.shape),
                np.broadcast_to(self.hi, self.shape))

    def collapsed(self) -> "AbsVal":
        """Shrink every axis along which both bounds are uniform to 1."""
        lo, hi = self.lo, self.hi
        for ax in range(lo.ndim):
            if lo.shape[ax] > 1:
                l0 = np.take(lo, [0], axis=ax)
                h0 = np.take(hi, [0], axis=ax)
                if (lo == l0).all() and (hi == h0).all():
                    lo, hi = l0, h0
        return AbsVal(lo, hi, self.shape, self.dtype, self.excl,
                      self.vuni, self.unsigned)

    def bounds(self) -> Tuple[int, int]:
        if self.lo.size == 0:
            return 0, 0
        return int(self.lo.min()), int(self.hi.max())

    def max_abs(self) -> int:
        lo, hi = self.bounds()
        return max(abs(lo), abs(hi))

    def key(self) -> tuple:
        """Full abstract state (bounds, refinements, shape, dtype): the
        reuse criterion for repeated calls."""
        if self._key is None:
            self._key = (self.lo.shape, self.lo.tobytes(), self.hi.tobytes(),
                         self.shape, self.dtype.str, self.excl, self.vuni,
                         self.unsigned)
        return self._key

    def __repr__(self):
        lo, hi = self.bounds()
        return f"AbsVal([{lo}, {hi}] {self.dtype}{self.shape})"


def _lift(x: np.ndarray, nd: int) -> np.ndarray:
    return x.reshape((1,) * (nd - x.ndim) + x.shape)


def _binop_arrays(a: AbsVal, b: AbsVal, exact: bool = False):
    """Broadcast-aligned stored arrays for an elementwise binary op."""
    nd = max(a.lo.ndim, b.lo.ndim)
    arrs = (_lift(a.lo, nd), _lift(a.hi, nd), _lift(b.lo, nd),
            _lift(b.hi, nd))
    if exact:
        arrs = tuple(x.astype(object) for x in arrs)
    return arrs


def _corner_minmax(fn, alo, ahi, blo, bhi):
    c1, c2, c3, c4 = fn(alo, blo), fn(alo, bhi), fn(ahi, blo), fn(ahi, bhi)
    lo = np.minimum(np.minimum(c1, c2), np.minimum(c3, c4))
    hi = np.maximum(np.maximum(c1, c2), np.maximum(c3, c4))
    return lo, hi


def _dim(d: int, nd: int) -> int:
    return d + nd if d < 0 else d


_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def _where() -> str:
    """The innermost source line outside torch and this package that
    ran the current op."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path.startswith(_HERE) or path.startswith(_TORCH_DIR) or \
                "contextlib" in path:
            continue
        return f"{os.path.relpath(path)}:{frame.lineno}"
    return "<unknown>"


class _Mode(TorchDispatchMode):
    """Runs each op for real and hands it to the interpreter."""

    def __init__(self, interp: "IntervalInterpreter"):
        super().__init__()
        self.interp = interp

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.interp._silent:
            self.interp._on_op(func, args, kwargs, out)
        return out


class IntervalInterpreter:
    """Abstract interpreter: run with :meth:`run`, inspect ``violations``
    and ``max_abs`` afterwards. ``path`` names the stage in violation
    records."""

    def __init__(self, path: str = "stage"):
        self.path = path
        self.violations: List[Violation] = []
        self.max_abs: int = 0
        self.ops = 0
        self.memo_hits = 0
        self._seen_sites: set = set()
        self._silent = False
        self._interned: Dict[tuple, AbsVal] = {}
        self._memo: Dict[tuple, object] = {}
        self._handlers = self._build_handlers()

    # ---------------- public API ----------------

    def run(self, fn: Callable, inputs: Sequence,
            memo: Sequence[Tuple[str, str]] = MEMO_FUNCTIONS):
        """Interpret ``fn`` on ``inputs``: each input an :class:`AbsVal`
        (a tensor of its shape and dtype is made for it) or a nested
        tuple of them. Returns the outputs' AbsVals in ``fn``'s output
        structure."""
        tensors = [self._input_tensor(v) for v in inputs]
        with contextlib.ExitStack() as stack:
            for mod, name in memo:
                stack.enter_context(self._memoized(mod, name))
            stack.enter_context(_Mode(self))
            out = torch.func.functionalize(
                fn, remove="mutations_and_views")(*tensors)
        return self._outputs(out)

    # ---------------- plumbing ----------------

    def _input_tensor(self, v):
        if isinstance(v, (tuple, list)):
            return type(v)(self._input_tensor(x) for x in v)
        dtype = {d: t for t, d in _TORCH_TO_NUMPY.items()}[v.dtype]
        lo = int(v.lo.min()) if v.lo.size else 0
        t = torch.full(v.shape, lo, dtype=dtype)
        setattr(t, _ATTR, self._intern(v))
        return t

    def _outputs(self, out):
        if isinstance(out, (tuple, list)):
            return type(out)(self._outputs(o) for o in out)
        if isinstance(out, torch.Tensor):
            got = getattr(out, _ATTR, None)
            if got is None:
                got = getattr(self._inner(out), _ATTR, None)
            if got is None:
                raise Unsupported("a stage output of unknown origin")
            return got
        return out

    @staticmethod
    def _inner(t: torch.Tensor) -> torch.Tensor:
        """The value tensor the dispatch mode sees behind a functional
        tensor (synced first: a view regenerates from its base)."""
        if torch._is_functional_tensor(t):
            torch._sync(t)
            return torch._from_functional_tensor(t)
        return t

    def _intern(self, v: AbsVal) -> AbsVal:
        return self._interned.setdefault(v.key(), v)

    def _absval_of(self, t: torch.Tensor, func) -> AbsVal:
        got = getattr(t, _ATTR, None)
        if got is None:
            raise Unsupported(
                f"{self.path}: a tensor of unknown origin reaches {func} "
                f"at {_where()} (not an input, an op's output or a lifted "
                "constant)")
        return got

    # ---------------- repeated calls ----------------

    def _arg_key(self, a):
        if isinstance(a, torch.Tensor):
            v = getattr(self._inner(a), _ATTR, None)
            if v is None:
                return None
            return ("T", id(self._intern(v)), tuple(a.shape), a.dtype)
        if isinstance(a, (tuple, list)):
            parts = tuple(self._arg_key(x) for x in a)
            return None if None in parts else (type(a).__name__,) + parts
        if a is None or isinstance(a, (bool, int, str)):
            return ("V", a)
        return None

    def _capture(self, out):
        if isinstance(out, torch.Tensor):
            v = getattr(self._inner(out), _ATTR, None)
            if v is None:
                return None
            return (tuple(out.shape), out.dtype, self._intern(v))
        if isinstance(out, (tuple, list)):
            parts = [self._capture(o) for o in out]
            return None if any(p is None for p in parts) else \
                (type(out), parts)
        return None

    def _materialize(self, cap):
        if isinstance(cap[0], type):
            kind, parts = cap
            return kind(self._materialize(p) for p in parts)
        shape, dtype, v = cap
        self._silent = True
        try:
            t = torch.empty(shape, dtype=dtype)
        finally:
            self._silent = False
        setattr(self._inner(t), _ATTR, v)
        return t

    @contextlib.contextmanager
    def _memoized(self, module: str, name: str):
        import importlib
        mod = importlib.import_module(module)
        orig = getattr(mod, name)

        def wrapper(*args, **kwargs):
            key = self._arg_key((args, tuple(sorted(kwargs.items()))))
            if key is not None:
                hit = self._memo.get((module, name, key))
                if hit is not None:
                    self.memo_hits += 1
                    return self._materialize(hit)
            out = orig(*args, **kwargs)
            if key is not None:
                cap = self._capture(out)
                if cap is not None:
                    self._memo[(module, name, key)] = cap
            return out

        setattr(mod, name, wrapper)
        try:
            yield
        finally:
            setattr(mod, name, orig)

    # ---------------- one op ----------------

    def _on_op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        handler = self._handlers.get(func)
        if handler is None:
            handler = self._handlers.get(func._overloadpacket)
        if handler is None:
            raise Unsupported(
                f"{self.path}[{self.ops}]: no interval rule for {func} at "
                f"{_where()}")
        outs = out if isinstance(out, (tuple, list)) else (out,)
        exact = any(isinstance(o, torch.Tensor) and o.dtype in
                    (torch.int64, torch.uint64) for o in outs)
        self._exact_op = exact
        got = handler(func, args, kwargs, out)
        gots = got if isinstance(got, (tuple, list)) else (got,)
        for o, v in zip(outs, gots):
            if isinstance(o, torch.Tensor):
                v = self._check(func, o, v)
                setattr(o, _ATTR, self._intern(v))

    def _check(self, func, o: torch.Tensor, out: AbsVal) -> AbsVal:
        dlo, dhi = interval_for_dtype(o.dtype)
        vlo, vhi = out.bounds()
        if vlo < dlo or vhi > dhi:
            site = (func._overloadpacket.__name__, _where())
            if site not in self._seen_sites:
                self._seen_sites.add(site)
                self.violations.append(Violation(
                    path=self.path, eqn_index=self.ops,
                    primitive=site[0], dtype=str(numpy_dtype(o.dtype)),
                    lo=vlo, hi=vhi, dtype_min=dlo, dtype_max=dhi,
                    where=site[1]))
            # wrap semantics: a wrapped value can be anything in range
            # (zero wraps to zero and equal values wrap equally, so both
            # refinements survive the clamp)
            out = AbsVal(np.clip(out.lo, dlo, dhi), np.clip(out.hi, dlo, dhi),
                         out.shape, out.dtype, out.excl, out.vuni)
        if _exact(out.lo) or _exact(out.hi):
            out = AbsVal(out.lo.astype(np.int64), out.hi.astype(np.int64),
                         out.shape, out.dtype, out.excl, out.vuni,
                         out.unsigned)
        self.max_abs = max(self.max_abs, out.max_abs())
        return out

    # ---------------- handlers ----------------

    def _build_handlers(self) -> Dict:
        a = _aten
        h = {
            a.add: self._h_add, a.sub: self._h_sub, a.mul: self._h_mul,
            a.abs: self._h_abs, a.clamp: self._h_clamp,
            a.bitwise_and: self._h_and, a.bitwise_or: self._h_or,
            a.bitwise_xor: self._h_xor, a.bitwise_not: self._h_not,
            a.__lshift__: self._h_shift_left,
            a.bitwise_left_shift: self._h_shift_left,
            a.__rshift__: self._h_shift_right,
            a.eq: self._h_cmp, a.ne: self._h_cmp, a.lt: self._h_cmp,
            a.le: self._h_cmp, a.gt: self._h_cmp, a.ge: self._h_cmp,
            a.where: self._h_where, a.sum: self._h_sum, a.all: self._h_all,
            a._to_copy: self._h_convert,
            a.clone: self._h_identity, a.alias_copy: self._h_identity,
            a.lift_fresh: self._h_constant, a.zeros: self._h_constant,
            a.zeros_like: self._h_constant, a.full: self._h_constant,
            a.arange: self._h_constant, a.fill: self._h_fill,
            a.copy: self._h_copy,
            a.select_copy: self._h_select, a.slice_copy: self._h_slice,
            a.select_scatter: self._h_select_scatter,
            a.slice_scatter: self._h_slice_scatter,
            a.cat: self._h_cat, a.stack: self._h_stack,
            a.view_copy: self._h_view, a.expand_copy: self._h_expand,
            a.unsqueeze_copy: self._h_unsqueeze,
            a.permute_copy: self._h_permute,
            a.flip: self._h_flip, a.roll: self._h_roll,
            a._local_scalar_dense: self._h_branch,
            a.is_nonzero: self._h_branch,
        }
        return h

    # --- helpers ---

    def _val(self, x, func) -> AbsVal:
        """An operand: a tensor's interval, or a Python scalar's."""
        if isinstance(x, torch.Tensor):
            return self._absval_of(x, func)
        if isinstance(x, bool) or isinstance(x, int):
            v = np.array(int(x), dtype=np.int64)
            return AbsVal(v, v, (), np.int64, vuni=frozenset())
        raise Unsupported(f"{self.path}: operand {x!r} of {func}")

    def _arr(self, x):
        return x.astype(object) if self._exact_op else x

    def _big(self):
        """A bound beyond every dtype: SAT, or 2^64 in exact arithmetic."""
        return (1 << 64) if self._exact_op else SAT

    def _out(self, o, lo, hi, **kw) -> AbsVal:
        lo, hi = np.asarray(lo), np.asarray(hi)
        nd = len(o.shape)
        if lo.ndim < nd:
            lo, hi = _lift(lo, nd), _lift(hi, nd)
        shp = np.broadcast_shapes(lo.shape, hi.shape)
        lo, hi = np.broadcast_to(lo, shp), np.broadcast_to(hi, shp)
        return AbsVal(_clamp(lo), _clamp(hi), o.shape, o.dtype, **kw)

    def _bin(self, func, args):
        a = self._val(args[0], func)
        b = self._val(args[1], func)
        alo, ahi, blo, bhi = _binop_arrays(a, b, self._exact_op)
        return a, b, alo, ahi, blo, bhi

    # --- elementwise arithmetic ---

    def _alpha(self, kwargs, blo, bhi):
        alpha = kwargs.get("alpha", 1)
        if alpha == 1:
            return blo, bhi
        if not isinstance(alpha, int):
            raise Unsupported(f"{self.path}: non-integer alpha {alpha!r}")
        return _corner_minmax(_safe_mul, blo, bhi,
                              np.array(alpha), np.array(alpha))[0:2]

    def _h_add(self, func, args, kwargs, o):
        _, _, alo, ahi, blo, bhi = self._bin(func, args)
        blo, bhi = self._alpha(kwargs, blo, bhi)
        return self._out(o, alo + blo, ahi + bhi)

    def _h_sub(self, func, args, kwargs, o):
        _, _, alo, ahi, blo, bhi = self._bin(func, args)
        blo, bhi = self._alpha(kwargs, blo, bhi)
        return self._out(o, alo - bhi, ahi - blo)

    def _h_mul(self, func, args, kwargs, o):
        a, b, alo, ahi, blo, bhi = self._bin(func, args)
        lo, hi = _corner_minmax(_safe_mul, alo, ahi, blo, bhi)
        out = self._out(o, lo, hi)
        # a product is nonzero only where BOTH factors are: exclusivity
        # along an axis survives from either factor
        nd = out.lo.ndim
        out.excl = frozenset(
            {ax + (nd - a.lo.ndim) for ax in a.excl} |
            {ax + (nd - b.lo.ndim) for ax in b.excl})
        return out

    def _h_abs(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        alo, ahi = self._arr(a.lo), self._arr(a.hi)
        lo = np.where((alo <= 0) & (ahi >= 0), 0,
                      np.minimum(np.abs(alo), np.abs(ahi)))
        hi = np.maximum(np.abs(alo), np.abs(ahi))
        return self._out(o, lo, hi)

    def _h_clamp(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        mn = kwargs.get("min", args[1] if len(args) > 1 else None)
        mx = kwargs.get("max", args[2] if len(args) > 2 else None)
        lo, hi = self._arr(a.lo), self._arr(a.hi)
        for bound, fn in ((mn, np.maximum), (mx, np.minimum)):
            if bound is None:
                continue
            if isinstance(bound, torch.Tensor) or \
                    not isinstance(bound, int):
                raise Unsupported(f"{self.path}: clamp bound {bound!r}")
            lo, hi = fn(lo, bound), fn(hi, bound)
        return self._out(o, lo, hi)

    # --- bitwise ---

    def _h_and(self, func, args, kwargs, o):
        _, _, alo, ahi, blo, bhi = self._bin(func, args)
        if o.dtype == torch.bool:
            return self._out(o, np.minimum(alo, blo), np.minimum(ahi, bhi))
        a_nn, b_nn = alo >= 0, blo >= 0
        hi = np.where(a_nn & b_nn, np.minimum(ahi, bhi),
                      np.where(a_nn, ahi,
                               np.where(b_nn, bhi, np.maximum(ahi, bhi))))
        lo = np.where(a_nn | b_nn, np.zeros_like(alo),
                      np.full_like(alo, -self._big()))
        return self._out(o, lo, hi)

    def _h_or(self, func, args, kwargs, o):
        _, _, alo, ahi, blo, bhi = self._bin(func, args)
        if o.dtype == torch.bool:
            return self._out(o, np.maximum(alo, blo), np.maximum(ahi, bhi))
        both_nn = (alo >= 0) & (blo >= 0)
        # x|y >= min(x, y) in all sign cases (setting bits moves a
        # negative toward -1); >= max(x, y) when both non-negative.
        lo = np.where(both_nn, np.maximum(alo, blo), np.minimum(alo, blo))
        # x|y <= x + y for non-negative x, y; a possibly-negative operand
        # contributes 0 to the upper bound. Refinement: OR cannot set a
        # bit above the highest bit of either operand, so for
        # non-negative operands min in the all-ones ceiling of
        # max(ahi, bhi) — without it, full-range 32-bit words would
        # falsely escape.
        hi = _clamp(np.maximum(ahi, 0) + np.maximum(bhi, 0))
        hi = np.where(both_nn,
                      np.minimum(hi, _bitmask_bound(np.maximum(ahi, bhi))),
                      hi)
        return self._out(o, lo, hi)

    def _h_xor(self, func, args, kwargs, o):
        _, _, alo, ahi, blo, bhi = self._bin(func, args)
        if o.dtype == torch.bool:
            same = (alo == ahi) & (blo == bhi)
            lo = np.where(same, np.abs(alo - blo), 0)
            hi = np.where(same, np.abs(alo - blo), 1)
            return self._out(o, lo, hi)
        both_nn = (alo >= 0) & (blo >= 0)
        big = self._big()
        lo = np.where(both_nn, np.zeros_like(alo), np.full_like(alo, -big))
        # the same bit-ceiling refinement as OR
        hi = np.where(both_nn,
                      np.minimum(_clamp(ahi + bhi),
                                 _bitmask_bound(np.maximum(ahi, bhi))),
                      np.full_like(ahi, big))
        return self._out(o, lo, hi)

    def _h_not(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        alo, ahi = self._arr(a.lo), self._arr(a.hi)
        if o.dtype == torch.bool:
            return self._out(o, 1 - ahi, 1 - alo)
        if numpy_dtype(o.dtype).kind == "u":
            # unsigned bitwise-not is dtype_max - x, not -1 - x
            _dlo, dhi = interval_for_dtype(o.dtype)
            return self._out(o, dhi - ahi, dhi - alo)
        return self._out(o, -1 - ahi, -1 - alo)

    def _h_shift_left(self, func, args, kwargs, o):
        _, _, alo, ahi, slo, shi = self._bin(func, args)
        slo, shi = np.clip(slo, 0, 62), np.clip(shi, 0, 62)

        def shl(x, k):
            if _exact(x) or _exact(k):
                return np.asarray(x, dtype=object) * np.frompyfunc(
                    lambda e: 1 << int(e), 1, 1)(k)
            return _safe_mul(x, np.int64(1) << k)
        lo, hi = _corner_minmax(shl, alo, ahi, slo, shi)
        return self._out(o, lo, hi)

    def _h_shift_right(self, func, args, kwargs, o):
        # arithmetic for signed dtypes; for unsigned ones the value is
        # non-negative, where logical and arithmetic shifts agree
        _, _, alo, ahi, slo, shi = self._bin(func, args)
        slo, shi = np.clip(slo, 0, 63), np.clip(shi, 0, 63)
        lo, hi = _corner_minmax(np.right_shift, alo, ahi, slo, shi)
        return self._out(o, lo, hi)

    # --- comparisons ---

    def _h_cmp(self, func, args, kwargs, o):
        a, b, alo, ahi, blo, bhi = self._bin(func, args)
        name = func._overloadpacket.__name__
        if name in ("lt", "ge"):
            surely = ahi < blo          # a < b always
            never = alo >= bhi          # a < b never
            if name == "ge":
                surely, never = never, surely
        elif name in ("le", "gt"):
            surely = ahi <= blo
            never = alo > bhi
            if name == "gt":
                surely, never = never, surely
        elif name == "eq":
            surely = (alo == ahi) & (blo == bhi) & (alo == blo)
            never = (ahi < blo) | (bhi < alo)
        else:  # ne
            never = (alo == ahi) & (blo == bhi) & (alo == blo)
            surely = (ahi < blo) | (bhi < alo)
        out = self._out(o, np.where(surely, 1, 0), np.where(never, 0, 1))
        if name == "eq":
            out.excl = self._onehot_axes(a, b, out)
        return out

    @staticmethod
    def _onehot_axes(a: AbsVal, b: AbsVal, out: AbsVal) -> frozenset:
        """Axes along which eq(a, b) is one-hot: one side is a constant
        with pairwise-distinct values varying ONLY along that axis, the
        other side carrying the same runtime value at every position
        along it — the ``arange == digit[None]`` window-select idiom. At
        most one position can compare equal.

        Soundness hinges on the other side's *concrete* size being 1
        along the axis, or a tracked expand (``vuni``): uniform *bounds*
        (stored-size-1) would NOT be enough — a value-varying operand
        could match every position."""
        axes = set()
        nd = out.lo.ndim
        for x, y in ((a, b), (b, a)):
            if not np.array_equal(x.lo, x.hi):
                continue  # not a constant
            for ax in range(x.lo.ndim):
                oax = ax + (nd - x.lo.ndim)
                if x.lo.shape[ax] != x.shape[ax] or x.shape[ax] <= 1:
                    continue
                if any(x.lo.shape[d] != 1
                       for d in range(x.lo.ndim) if d != ax):
                    continue  # constant varies along more than one axis
                if np.unique(x.lo).size != x.lo.size:
                    continue  # values not pairwise distinct
                yax = oax - (nd - y.lo.ndim)
                if yax >= 0 and y.shape[yax] != 1 and yax not in y.vuni:
                    continue
                axes.add(oax)
        return frozenset(axes)

    def _h_where(self, func, args, kwargs, o):
        cond = self._val(args[0], func)
        a = self._val(args[1], func)
        b = self._val(args[2], func)
        nd = max(cond.lo.ndim, a.lo.ndim, b.lo.ndim)
        plo, phi = _lift(cond.lo, nd), _lift(cond.hi, nd)
        alo, ahi = _lift(self._arr(a.lo), nd), _lift(self._arr(a.hi), nd)
        blo, bhi = _lift(self._arr(b.lo), nd), _lift(self._arr(b.hi), nd)
        big = self._big()
        can_a, can_b = phi >= 1, plo <= 0
        lo = np.minimum(np.where(can_a, alo, np.full_like(alo, big)),
                        np.where(can_b, blo, np.full_like(blo, big)))
        hi = np.maximum(np.where(can_a, ahi, np.full_like(ahi, -big)),
                        np.where(can_b, bhi, np.full_like(bhi, -big)))
        return self._out(o, lo, hi)

    # --- reductions ---

    @staticmethod
    def _dims(arg, nd):
        if arg is None:
            return list(range(nd))
        if isinstance(arg, int):
            arg = [arg]
        return sorted({_dim(d, nd) for d in arg})

    def _h_all(self, func, args, kwargs, o):
        # AND over axes: true iff all true, so the min of either bound
        a = self._val(args[0], func)
        dims = self._dims(args[1] if len(args) > 1 else
                          kwargs.get("dim"), len(a.shape))
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        lo, hi = a.lo, a.hi
        for ax in sorted(dims, reverse=True):
            lo = lo.min(axis=ax, keepdims=keep)
            hi = hi.min(axis=ax, keepdims=keep)
        return AbsVal(lo, hi, o.shape, o.dtype)

    def _h_sum(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(a.shape)
        dims = self._dims(args[1] if len(args) > 1 else
                          kwargs.get("dim"), nd)
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        lo, hi = self._arr(a.lo), self._arr(a.hi)
        excl = set(a.excl)
        for ax in sorted(dims, reverse=True):
            n = a.shape[ax]
            if ax in excl:
                # at most one nonzero along ax: the sum is that single
                # element or zero — union bound, not an n-fold sum
                lo = np.minimum(lo.min(axis=ax, keepdims=True), 0)
                hi = np.maximum(hi.max(axis=ax, keepdims=True), 0)
            elif lo.shape[ax] == 1:
                lo = _clamp(_safe_mul(lo, np.int64(n)))
                hi = _clamp(_safe_mul(hi, np.int64(n)))
            else:
                lo = np.expand_dims(_clamp(_safe_sum(lo, ax)), ax)
                hi = np.expand_dims(_clamp(_safe_sum(hi, ax)), ax)
            if not keep:
                lo, hi = np.squeeze(lo, ax), np.squeeze(hi, ax)
                excl = {e - 1 if e > ax else e for e in excl if e != ax}
            else:
                excl.discard(ax)
        return AbsVal(lo, hi, o.shape, o.dtype, frozenset(excl))

    # --- conversions and constants ---

    def _h_convert(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        new = o.dtype
        if new not in _TORCH_TO_NUMPY:
            raise Unsupported(f"{self.path}: convert to {new} at {_where()}")
        if new == torch.bool:
            nonzero_sure = (a.lo > 0) | (a.hi < 0)
            zero_sure = (a.lo == 0) & (a.hi == 0)
            return AbsVal(np.where(nonzero_sure, 1, 0),
                          np.where(zero_sure, 0, 1), o.shape, new,
                          a.excl, a.vuni)
        dlo, dhi = interval_for_dtype(new)
        lo, hi = a.bounds()
        width = numpy_dtype(new).itemsize * 8
        if (lo < dlo or hi > dhi) and numpy_dtype(new).kind == "i" and \
                lo >= 0 and hi < (1 << width):
            # a narrowing conversion keeps the low bits: a value that
            # fits the unsigned type of the target's width is kept bit
            # for bit (the target holds the word's two's complement), so
            # it is a reinterpretation, not an overflow
            half = 1 << (width - 1)
            wlo = np.where(a.lo >= half, a.lo - (1 << width), a.lo)
            whi = np.where(a.hi >= half, a.hi - (1 << width), a.hi)
            crosses = (a.lo < half) & (a.hi >= half)
            return AbsVal(np.where(crosses, dlo, np.minimum(wlo, whi)),
                          np.where(crosses, dhi, np.maximum(wlo, whi)),
                          o.shape, new, a.excl, a.vuni,
                          unsigned=(np.dtype(f"uint{width}").str, lo, hi))
        # zero converts to zero and equal values convert equally: both
        # refinements survive
        return AbsVal(a.lo, a.hi, o.shape, new, a.excl, a.vuni)

    def _h_identity(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        return AbsVal(a.lo, a.hi, o.shape, o.dtype, a.excl, a.vuni,
                      a.unsigned)

    def _h_constant(self, func, args, kwargs, o):
        # a factory's (or a lifted constant's) output is a constant of
        # the code: its exact value is its interval
        return AbsVal.from_concrete(o)

    def _h_fill(self, func, args, kwargs, o):
        v = args[1]
        if isinstance(v, torch.Tensor):
            f = self._val(v, func)
            return self._out(o, f.lo, f.hi)
        return AbsVal.from_concrete(o)

    def _h_copy(self, func, args, kwargs, o):
        # copy(self, src): src's values in self's shape and dtype
        src = self._val(args[1], func)
        return self._out(o, self._arr(src.lo), self._arr(src.hi))

    def _h_branch(self, func, args, kwargs, o):
        raise Unsupported(
            f"{self.path}: {func} reads a tensor's value on the host (a "
            f"Python branch on an interval's value) at {_where()}")

    # --- structural ---

    def _h_select(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(a.shape)
        d = _dim(args[1], nd)
        idx = args[2] % a.shape[d]
        sl = [slice(None)] * nd
        sl[d] = 0 if a.lo.shape[d] == 1 else idx
        lo, hi = a.lo[tuple(sl)], a.hi[tuple(sl)]

        def remap(axes):
            return frozenset(x - 1 if x > d else x for x in axes if x != d)
        return AbsVal(lo, hi, o.shape, o.dtype, remap(a.excl),
                      remap(a.vuni))

    def _h_slice(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(a.shape)
        d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
        start = args[2] if len(args) > 2 else kwargs.get("start")
        end = args[3] if len(args) > 3 else kwargs.get("end")
        step = args[4] if len(args) > 4 else kwargs.get("step", 1)
        sl = [slice(None)] * nd
        if a.lo.shape[d] == 1:
            sl[d] = slice(0, 1)
        else:
            sl[d] = slice(start, end, step)
        lo, hi = a.lo[tuple(sl)], a.hi[tuple(sl)]
        if lo.shape[d] not in (1, o.shape[d]):
            raise Unsupported(f"{self.path}: slice bounds at {_where()}")
        # a sub-range along an axis keeps at-most-one-nonzero and value
        # uniformity
        return AbsVal(lo, hi, o.shape, o.dtype, a.excl, a.vuni)

    def _scatter(self, func, base: AbsVal, src: AbsVal, d: int, index, o):
        nd = len(base.shape)
        lo, hi = base.materialize([d])
        lo, hi = np.array(lo), np.array(hi)
        tgt = list(lo.shape)
        sel = [slice(None)] * nd
        sel[d] = index
        region = lo[tuple(sel)].shape
        slo, shi = np.asarray(src.lo), np.asarray(src.hi)
        if isinstance(index, int):
            slo = np.expand_dims(slo, d) if slo.ndim < nd else slo
            shi = np.expand_dims(shi, d) if shi.ndim < nd else shi
            sel[d] = slice(index, index + 1)
            region = lo[tuple(sel)].shape
        # grow the stored base wherever the source varies
        for ax in range(nd):
            if ax != d and slo.shape[ax] > tgt[ax]:
                tgt[ax] = slo.shape[ax]
        lo = np.array(np.broadcast_to(lo, tgt))
        hi = np.array(np.broadcast_to(hi, tgt))
        region = lo[tuple(sel)].shape
        lo[tuple(sel)] = np.broadcast_to(slo, region)
        hi[tuple(sel)] = np.broadcast_to(shi, region)
        return AbsVal(lo, hi, o.shape, o.dtype).collapsed()

    def _h_slice_scatter(self, func, args, kwargs, o):
        base = self._val(args[0], func)
        src = self._val(args[1], func)
        nd = len(base.shape)
        d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0), nd)
        start = args[3] if len(args) > 3 else kwargs.get("start")
        end = args[4] if len(args) > 4 else kwargs.get("end")
        step = args[5] if len(args) > 5 else kwargs.get("step", 1)
        return self._scatter(func, base, src, d, slice(start, end, step), o)

    def _h_select_scatter(self, func, args, kwargs, o):
        base = self._val(args[0], func)
        src = self._val(args[1], func)
        nd = len(base.shape)
        d = _dim(args[2], nd)
        return self._scatter(func, base, src, d, args[3] % base.shape[d], o)

    def _h_cat(self, func, args, kwargs, o):
        vals = [self._val(t, func) for t in args[0]]
        nd = len(o.shape)
        d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
        common = [1] * nd
        for v in vals:
            for ax in range(nd):
                if ax != d:
                    common[ax] = max(common[ax], v.lo.shape[ax])
        los, his = [], []
        for v in vals:
            lo, hi = v.materialize([d])
            tgt = list(common)
            tgt[d] = lo.shape[d]
            los.append(np.broadcast_to(lo, tgt))
            his.append(np.broadcast_to(hi, tgt))
        return AbsVal(np.concatenate(los, axis=d),
                      np.concatenate(his, axis=d), o.shape,
                      o.dtype).collapsed()

    def _h_stack(self, func, args, kwargs, o):
        vals = [self._val(t, func) for t in args[0]]
        nd = len(o.shape)
        d = _dim(args[1] if len(args) > 1 else kwargs.get("dim", 0), nd)
        common = [1] * (nd - 1)
        for v in vals:
            for ax in range(nd - 1):
                common[ax] = max(common[ax], v.lo.shape[ax])
        los = [np.expand_dims(np.broadcast_to(v.lo, common), d) for v in vals]
        his = [np.expand_dims(np.broadcast_to(v.hi, common), d) for v in vals]
        return AbsVal(np.concatenate(los, axis=d),
                      np.concatenate(his, axis=d), o.shape,
                      o.dtype).collapsed()

    def _h_view(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        if len(args) > 1 and isinstance(args[1], torch.dtype):
            return self._bitcast(a, o)
        return self._reshape(a, o)

    def _bitcast(self, a: AbsVal, o) -> AbsVal:
        src, dst = a.dtype, numpy_dtype(o.dtype)
        if src.itemsize != dst.itemsize:
            raise Unsupported(f"{self.path}: a width-changing dtype view "
                              f"{src} -> {dst} at {_where()}")
        if a.unsigned is not None and a.unsigned[0] == dst.str:
            _kind, lo, hi = a.unsigned
            return AbsVal.from_range(o.shape, dst, lo, hi) if lo != hi \
                else AbsVal(np.full(a.lo.shape, lo), np.full(a.lo.shape, hi),
                            o.shape, dst)
        dlo, dhi = interval_for_dtype(dst)
        if a.lo.size and int(a.lo.min()) >= dlo and int(a.hi.max()) <= dhi:
            return AbsVal(a.lo, a.hi, o.shape, dst, a.excl, a.vuni)
        # the bits reinterpret: a value out of the target's range maps
        # anywhere in it
        return AbsVal.top(o.shape, dst)

    def _reshape(self, a: AbsVal, o) -> AbsVal:
        new_shape = tuple(o.shape)
        groups = self._reshape_groups(a.shape, new_shape)
        out_stored: Optional[List[int]] = [] if groups is not None else None
        excl, vuni = set(), set()
        if groups is not None:
            for in_dims, out_dims in groups:
                stored = [a.lo.shape[d] for d in in_dims]
                concrete = [a.shape[d] for d in in_dims]
                if len(in_dims) == 1 and len(out_dims) == 1:
                    if in_dims[0] in a.excl:
                        excl.add(out_dims[0])
                    if in_dims[0] in a.vuni:
                        vuni.add(out_dims[0])
                elif not in_dims:
                    vuni.update(out_dims)  # inserted size-1 axes
                if stored == concrete:
                    out_stored.extend(new_shape[d] for d in out_dims)
                elif all(s == 1 for s in stored):
                    out_stored.extend(1 for _ in out_dims)
                else:
                    out_stored = None  # mixed group: fall back
                    break
        if out_stored is None:
            lo, hi = a.full()
            return AbsVal(lo.reshape(new_shape), hi.reshape(new_shape),
                          new_shape, o.dtype).collapsed()
        return AbsVal(a.lo.reshape(out_stored), a.hi.reshape(out_stored),
                      new_shape, o.dtype, frozenset(excl), frozenset(vuni))

    @staticmethod
    def _reshape_groups(old: Tuple[int, ...], new: Tuple[int, ...]):
        """Factor a reshape into (old_dims, new_dims) groups with equal
        products, or None if the greedy factorization fails."""
        groups = []
        i = j = 0
        while i < len(old) or j < len(new):
            gi, gj = [i], [j]
            if i >= len(old) or j >= len(new):
                while i < len(old):
                    if old[i] != 1:
                        return None
                    groups.append(([i], []))
                    i += 1
                while j < len(new):
                    if new[j] != 1:
                        return None
                    groups.append(([], [j]))
                    j += 1
                break
            pi, pj = old[i], new[j]
            i += 1
            j += 1
            while pi != pj:
                if pi < pj:
                    if i >= len(old):
                        return None
                    pi *= old[i]
                    gi.append(i)
                    i += 1
                else:
                    if j >= len(new):
                        return None
                    pj *= new[j]
                    gj.append(j)
                    j += 1
            groups.append((gi, gj))
        return groups

    def _h_expand(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(o.shape)
        lead = nd - len(a.shape)
        lo, hi = _lift(a.lo, nd), _lift(a.hi, nd)
        # new leading axes and size-1 -> N expansions replicate ONE value
        vuni = set(range(lead))
        for i, s in enumerate(a.shape):
            if i in a.vuni or s == 1:
                vuni.add(i + lead)
        return AbsVal(lo, hi, o.shape, o.dtype,
                      frozenset(ax + lead for ax in a.excl), frozenset(vuni))

    def _h_unsqueeze(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        d = _dim(args[1], len(a.shape) + 1)

        def remap(axes):
            return {x + 1 if x >= d else x for x in axes}
        return AbsVal(np.expand_dims(a.lo, d), np.expand_dims(a.hi, d),
                      o.shape, o.dtype, frozenset(remap(a.excl)),
                      frozenset(remap(a.vuni) | {d}))

    def _permute(self, a: AbsVal, perm, o) -> AbsVal:
        perm = [_dim(p, len(a.shape)) for p in perm]

        def remap(axes):
            return frozenset(perm.index(x) for x in axes)
        return AbsVal(np.transpose(a.lo, perm), np.transpose(a.hi, perm),
                      o.shape, o.dtype, remap(a.excl), remap(a.vuni))

    def _h_permute(self, func, args, kwargs, o):
        return self._permute(self._val(args[0], func), args[1], o)

    def _h_flip(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(a.shape)
        dims = [d for d in self._dims(args[1], nd) if a.lo.shape[d] > 1]
        lo, hi = a.lo, a.hi
        if dims:
            lo, hi = np.flip(lo, axis=tuple(dims)), np.flip(hi,
                                                            axis=tuple(dims))
        return AbsVal(lo, hi, o.shape, o.dtype)

    def _h_roll(self, func, args, kwargs, o):
        a = self._val(args[0], func)
        nd = len(a.shape)
        shifts = args[1] if len(args) > 1 else kwargs.get("shifts")
        dims = args[2] if len(args) > 2 else kwargs.get("dims", [])
        shifts = [shifts] if isinstance(shifts, int) else list(shifts)
        dims = [dims] if isinstance(dims, int) else list(dims)
        if not dims:
            raise Unsupported(f"{self.path}: roll of a flattened tensor")
        lo, hi = a.lo, a.hi
        for s, d in zip(shifts, dims):
            d = _dim(d, nd)
            if lo.shape[d] > 1:
                lo, hi = np.roll(lo, s, axis=d), np.roll(hi, s, axis=d)
        return AbsVal(lo, hi, o.shape, o.dtype)

"""Static analysis for the port's verify and hash kernels and their host
dispatch layer.

The provers and lints, one CLI (``python -m stellar_tpu_torch.tools.
analyze``), and the tests that gate them (``tests/test_torch_analysis.py``,
``tests/test_torch_intervals.py``):

* :mod:`stellar_tpu_torch.analysis.intervals` /
  :mod:`stellar_tpu_torch.analysis.overflow` — abstract interpretation
  with an interval domain over the aten op stream of the kernels' plain
  PyTorch versions, proving every integer intermediate fits its dtype
  with the carry headroom the limb layout assumes. The proven per-stage
  envelope is committed as ``stellar_tpu_torch/analysis/limb_bounds.json``
  and ``sha256_bounds.json`` so kernel changes diff the proof, not just a
  pass/fail bit.
* :mod:`stellar_tpu_torch.analysis.hotpath` — AST lint for host<->device
  sync hazards in the kernel wrappers and plain versions, and for
  per-call kernel setup in the dispatch layer.
* :mod:`stellar_tpu_torch.analysis.locks` — AST lint for shared mutable
  state mutated outside a ``with <lock>`` block in the threaded modules.
* :mod:`stellar_tpu_torch.analysis.lockorder` — the whole-program
  lock-order prover (cycles, and blocking work under a lock).
* :mod:`stellar_tpu_torch.analysis.nondet` — the consensus
  nondeterminism lint over the consensus packages and the crypto
  host-oracle modules.
* :mod:`stellar_tpu_torch.analysis.coverage` — every registered kernel
  variant maps to a proven stage of a committed golden.

Every finding is fixed or carries a written safety argument in its
module's ``ALLOWLIST``; an allowlist entry that matches nothing fails the
gate too.
"""

from stellar_tpu_torch.analysis.lint_base import Finding  # noqa: F401

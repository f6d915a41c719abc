"""The port's static-analysis gates: the AST lints (hot path, locks,
lock order, nondeterminism), the proof-coverage gate, the analysis CLI
and the device probe.

* ``lint_base`` is a copy of the reference's, and ``locks``, ``nondet``,
  ``lockorder`` and ``coverage`` are partial copies (``_torch_port.
  PARTIAL``: their scopes, allowlists, the lock-order prover's device
  waits and the coverage gate's goldens are the port's).
* Every synthetic source of the reference's ``tests/test_analysis.py``
  and ``tests/test_nondet_lint.py`` goes through the port's lint and the
  reference's: the same findings, rule, line and key, the package name
  mapped. The reference's lint tests are ported one by one below.
* Each lint is clean on the port's tree, its scope is pinned, and stale
  allowlist entries fail; mutants (an unlocked write, an untimed wait
  under a lock, a two-module lock cycle, an unmapped Workload, a sync in
  a kernel wrapper) fail their gate.
* ``python -m stellar_tpu_torch.tools.analyze --json`` exits 0 with JAX
  and the reference's package blocked from import.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from stellar_tpu.analysis import lockorder as ref_lockorder
from stellar_tpu.analysis import locks as ref_locks
from stellar_tpu.analysis import nondet as ref_nondet
from stellar_tpu_torch.analysis import (
    coverage, hotpath, lockorder, locks, nondet,
)
from stellar_tpu_torch.analysis.lint_base import (
    Allowlist, finish_report, repo_root,
)
from stellar_tpu_torch.tools import device_probe
from tests._torch_port import PARTIAL, REPLACED, ROOT, check_copy

_WORD = re.compile(r"\bstellar_tpu\b")


def _port_text(text: str) -> str:
    """A source or path naming the reference's package, naming the
    port's."""
    return _WORD.sub("stellar_tpu_torch", text)


# ---------------- the copies ----------------

@pytest.mark.parametrize("rel", ["analysis/lint_base.py",
                                 "analysis/locks.py", "analysis/nondet.py",
                                 "analysis/lockorder.py",
                                 "analysis/coverage.py"])
def test_copy_equals_reference(rel):
    check_copy(rel, strings=rel != "analysis/lint_base.py")


@pytest.mark.parametrize("rel", ["analysis/locks.py", "analysis/nondet.py",
                                 "analysis/lockorder.py",
                                 "analysis/coverage.py"])
def test_partial_names_exactly_what_differs(rel):
    """Every name a partial copy's PARTIAL entry leaves out does differ
    from the reference's: without it the copy check fails."""
    assert rel in REPLACED
    full = PARTIAL[rel]
    try:
        for name in sorted(full):
            PARTIAL[rel] = full - {name}
            with pytest.raises(AssertionError):
                check_copy(rel, strings=True)
    finally:
        PARTIAL[rel] = full


# ---------------- synthetic sources against the reference ----------------

_UNLOCKED_DOUBLE = textwrap.dedent("""
    import threading

    class StatsDouble:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self.events = []

        def record(self, n):
            self.count += n
            self.events.append(n)
""")

_LOCKED_DOUBLE = textwrap.dedent("""
    import threading

    class StatsDouble:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self.events = []

        def record(self, n):
            with self._lock:
                self.count += n
                self.events.append(n)
""")

_INDIRECT = textwrap.dedent("""
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = []
            self.a = 0
            self.b = 0

        def bad(self):
            self.a, self.b = 1, 2
            item = self._q.pop(0)
            self.a = item
""")

_HEADS = textwrap.dedent("""
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._q = []

        def bad(self):
            if self._q.pop(0):
                return 1
            while self._q.pop():
                pass
            return 0
""")

_GLOBAL = textwrap.dedent("""
    import threading
    _lock = threading.Lock()
    STATE = 0

    def bump():
        global STATE
        STATE += 1

    def bump_guarded():
        global STATE
        with _lock:
            STATE += 1
""")

_INPLACE_GLOBAL = textwrap.dedent("""
    import threading
    _lock = threading.Lock()
    _CACHE = {}
    _EVENTS = []

    def record(k, v):
        _CACHE[k] = v
        _EVENTS.append(v)

    def record_guarded(k, v):
        with _lock:
            _CACHE[k] = v
            _EVENTS.append(v)

    def local_ok(k, v):
        _CACHE = {}        # local shadow, not the module global
        _CACHE[k] = v
""")

_OLD_WORKERS = textwrap.dedent("""
    import threading
    _pool = None
    _lock = threading.Lock()
    _background = True

    def set_background(enabled):
        global _background
        _background = enabled

    def shutdown():
        global _pool
        with _lock:
            if _pool is not None:
                _pool.shutdown(wait=True)
                _pool = None
""")

_CYCLE_A = textwrap.dedent("""
    import threading
    import modb
    _la = threading.Lock()

    def fa():
        with _la:
            modb.fb()

    def fa2():
        with _la:
            pass
""")

_CYCLE_B = textwrap.dedent("""
    import threading
    import moda
    _lb = threading.Lock()

    def fb():
        with _lb:
            pass

    def fb2():
        with _lb:
            moda.fa2()
""")

_HELPER_HOP = textwrap.dedent("""
    import threading
    import time
    _l = threading.Lock()

    def helper():
        time.sleep(1.0)

    def outer():
        with _l:
            helper()
""")

_PAIR = textwrap.dedent("""
    import threading

    class Pair:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def fwd(self):
            with self._a:
                with self._b:
                    pass

        def rev(self):
            with self._b:
                with self._a:
                    pass
""")

_PARK = textwrap.dedent("""
    import threading

    class W:
        def __init__(self):
            self._cv = threading.Condition()

        def park(self):
            with self._cv:
                self._cv.wait()

        def poll(self):
            with self._cv:
                self._cv.wait(0.05)
""")

_DRAIN = textwrap.dedent("""
    import threading
    _l = threading.Lock()

    def drain(q, t):
        with _l:
            q.get()
            t.join()

    def drain_bounded(q, t):
        with _l:
            q.get(timeout=1.0)
            t.join(1.0)
""")

_DEFERRED = textwrap.dedent("""
    import threading
    import time
    _l = threading.Lock()

    def schedule(pool):
        with _l:
            def later():
                time.sleep(1.0)
            pool.submit(later)
""")

LOCK_SOURCES = {
    "unlocked_double": (_UNLOCKED_DOUBLE, "double.py"),
    "locked_double": (_LOCKED_DOUBLE, "double.py"),
    "indirect": (_INDIRECT, "c.py"),
    "heads": (_HEADS, "c.py"),
    "global": (_GLOBAL, "mod.py"),
    "inplace_global": (_INPLACE_GLOBAL, "mod.py"),
    "old_workers": (_OLD_WORKERS, "workers.py"),
}

LOCKORDER_SOURCES = {
    "cycle": {"moda.py": _CYCLE_A, "modb.py": _CYCLE_B},
    "one_way": {"moda.py": _CYCLE_A,
                "modb.py": _CYCLE_B.replace("moda.fa2()", "pass")},
    "helper_hop": {"mod.py": _HELPER_HOP},
    "helper_unheld": {"mod.py": _HELPER_HOP.replace(
        "with _l:\n        helper()", "helper()")},
    "pair": {"pair.py": _PAIR},
    "pair_fixed": {"pair.py": _PAIR.replace(
        "with self._b:\n            with self._a:",
        "with self._a:\n            with self._b:")},
    "park": {"w.py": _PARK},
    "drain": {"m.py": _DRAIN},
    "deferred": {"m.py": _DEFERRED},
    "old_workers": {"workers.py": _OLD_WORKERS},
}

NONDET_SOURCES = {
    "utils_tracing": ("from stellar_tpu.utils import tracing\n", "x.py"),
    "import_tracing": ("import stellar_tpu.utils.tracing\n", "x.py"),
    "flight_recorder": (
        "from stellar_tpu.utils.tracing import flight_recorder\n", "x.py"),
    "span_totals": (
        "from stellar_tpu.utils.tracing import span_totals\n", "x.py"),
    "paren_tracing": ("from stellar_tpu.utils import (\n    faults,\n"
                      "    tracing,\n)\n", "x.py"),
    "paren_clean": ("from stellar_tpu.utils import (\n    faults,\n)\n",
                    "x.py"),
    "backslash_names": ("from stellar_tpu.utils.tracing import zone, \\\n"
                        "    span_totals\n", "x.py"),
    "backslash_module": ("from stellar_tpu.utils import faults, \\\n"
                         "    tracing\n", "x.py"),
    "sanctioned_paren": ("from stellar_tpu.utils.tracing import (\n"
                         "    LogSlowExecution, frame_mark, zone,\n)\n",
                         "x.py"),
    "sanctioned": ("from stellar_tpu.utils.tracing import zone\n", "x.py"),
    "perf_counter": ("t0 = time.perf_counter()\n", "x.py"),
    "clock_and_hash": ("import time\nx = time.time()\ny = hash(b'k')\n"
                       "# time.time() in a comment is fine\n",
                       "stellar_tpu/ledger/bad.py"),
    "hash_in_string": ('import time\nx = ("#", time.time())\n',
                       "stellar_tpu/ledger/bad.py"),
    "dunder_hash": ("class K:\n    def __hash__(self):\n"
                    "        return hash(self.raw)\n",
                    "stellar_tpu/ledger/k.py"),
}


def _keys(findings, map_paths=False):
    return [(f.rule, f.line, f.key,
             _port_text(f.file) if map_paths else f.file)
            for f in findings]


@pytest.mark.parametrize("name", sorted(LOCK_SOURCES))
def test_locks_finds_what_the_reference_finds(name):
    src, rel = LOCK_SOURCES[name]
    assert _keys(locks.lint_source(src, rel)) == \
        _keys(ref_locks.lint_source(src, rel))


@pytest.mark.parametrize("name", sorted(LOCKORDER_SOURCES))
def test_lockorder_finds_what_the_reference_finds(name):
    sources = LOCKORDER_SOURCES[name]
    got, graph = lockorder.run_sources(sources)
    want, ref_graph = ref_lockorder.run_sources(sources)
    assert _keys(got) == _keys(want)
    assert graph == ref_graph


@pytest.mark.parametrize("name", sorted(NONDET_SOURCES))
def test_nondet_finds_what_the_reference_finds(name):
    src, rel = NONDET_SOURCES[name]
    got = nondet.lint_source(_port_text(src), _port_text(rel))
    assert _keys(got) == _keys(ref_nondet.lint_source(src, rel),
                               map_paths=True)


def test_lockorder_device_waits_are_the_ports():
    """The one rule the port's prover changes: its device waits are
    ``torch.cuda.synchronize()``, ``Event.synchronize()``, ``.cpu()`` and
    ``.item()`` (the reference's were JAX's fetches)."""
    src = textwrap.dedent("""
        import threading
        import torch
        _l = threading.Lock()

        def sync_all():
            with _l:
                torch.cuda.synchronize()

        def wait_event(ev):
            with _l:
                ev.synchronize()

        def fetch(t):
            with _l:
                return t.cpu(), t.item()

        def outside(ev, t):
            ev.synchronize()
            return t.cpu()
    """)
    got, _ = lockorder.run_sources({"m.py": src})
    assert sorted(f.key for f in got) == [
        "hold-and-block:fetch.device-fetch",  # .cpu()
        "hold-and-block:fetch.device-fetch",  # .item()
        "hold-and-block:sync_all.device-fetch",
        "hold-and-block:wait_event.device-fetch"]
    assert ref_lockorder.run_sources({"m.py": src})[0] == []


# ---------------- lock lint (the reference's units) ----------------

def test_mutant_unlocked_write_caught():
    findings = locks.lint_source(_UNLOCKED_DOUBLE, "double.py")
    assert sorted(f.key for f in findings) == [
        "unlocked-attr:StatsDouble.record.count",
        "unlocked-attr:StatsDouble.record.events"]
    assert not locks.lint_source(_LOCKED_DOUBLE, "double.py")


def test_lock_lint_catches_indirect_mutations():
    keys = sorted(f.key for f in locks.lint_source(_INDIRECT, "c.py"))
    assert keys == ["unlocked-attr:C.bad._q", "unlocked-attr:C.bad.a",
                    "unlocked-attr:C.bad.a", "unlocked-attr:C.bad.b"]


def test_lock_lint_sees_mutators_in_statement_heads():
    keys = [f.key for f in locks.lint_source(_HEADS, "c.py")]
    assert keys == ["unlocked-attr:C.bad._q", "unlocked-attr:C.bad._q"]


def test_mutant_unlocked_global_caught():
    assert [f.key for f in locks.lint_source(_GLOBAL, "mod.py")] == \
        ["unlocked-global:bump.STATE"]


def test_lock_lint_catches_inplace_global_mutations():
    keys = sorted(f.key for f in locks.lint_source(_INPLACE_GLOBAL,
                                                   "mod.py"))
    assert keys == ["unlocked-global:record._CACHE",
                    "unlocked-global:record._EVENTS"]


def test_engine_mutations_under_the_stats_lock():
    """The fault the lock lint found in the port's engine: ``_prepare``
    added to ``_prepared`` and ``_convict`` to ``convicted`` outside
    ``_stats_lock``, while ``health_snapshot`` iterates ``convicted``
    under it from another thread. The old spelling trips the lint; the
    shipped engine's only findings are the argued configure_dispatch
    stores."""
    old = textwrap.dedent("""
        import threading

        class BatchEngine:
            def __init__(self, devs):
                self._devs = devs
                self.convicted = set()
                self._prepared = set()
                self._stats_lock = threading.Lock()

            def _prepare(self, plugin):
                for dev in self._devs:
                    key = (type(plugin), dev)
                    if key not in self._prepared:
                        plugin.prepare(dev)
                        self._prepared.add(key)

            def _convict(self, part):
                self.convicted.add(part.dev)

            def health_snapshot(self):
                with self._stats_lock:
                    return sorted(self.convicted)
    """)
    assert sorted(f.key for f in locks.lint_source(old, "e.py")) == [
        "unlocked-attr:BatchEngine._convict.convicted",
        "unlocked-attr:BatchEngine._prepare._prepared"]
    rel = "stellar_tpu_torch/parallel/batch_engine.py"
    shipped = locks.lint_source((repo_root() / rel).read_text(), rel)
    assert {f.key for f in shipped} == set(locks.ALLOWLIST._entries[rel])
    assert all(k.startswith("unlocked-global:configure_dispatch.")
               for k in locks.ALLOWLIST._entries[rel])


# ---------------- hot-path lint (the port's rules) ----------------

def test_hotpath_flags_sync_and_branch():
    src = textwrap.dedent("""
        import numpy as np

        def kernel(x):
            y = np.asarray(x)       # a copy to the host
            if x.sum() > 0:         # a branch on a tensor's value
                y = x.item()        # another sync
            z = x.cpu()
            w = x.tolist()
            for _ in range(x):      # data-dependent trip count
                y = y + 1
            return y, z, w
    """)
    keys = {f.key for f in hotpath.lint_source(src, "k.py")}
    assert {"host-sync:kernel.np.asarray", "host-sync:kernel.item",
            "host-sync:kernel.cpu", "host-sync:kernel.tolist",
            "traced-branch:kernel.x"} <= keys


def test_hotpath_flags_device_waits_everywhere():
    """``torch.cuda.synchronize()`` and ``Event.synchronize()`` are
    flagged in device files and dispatch files alike; value reads only in
    device files."""
    src = textwrap.dedent("""
        import torch

        def launch(x, ev):
            out = torch.empty_like(x)
            torch.cuda.synchronize()
            ev.synchronize()
            return out.cpu()
    """)
    dev = {f.key for f in hotpath.lint_source(src, "k.py")}
    host = {f.key for f in hotpath.lint_source(src, "k.py",
                                               device_file=False)}
    assert dev == {"host-sync:launch.synchronize", "host-sync:launch.cpu"}
    assert host == {"host-sync:launch.synchronize"}


def test_hotpath_taint_propagates_through_long_chains():
    src = textwrap.dedent("""
        import numpy as np

        def kernel(x):
            a = x + 1
            b = a + 1
            c = b + 1
            d = c + 1
            if d > 0:
                return np.asarray(d)
            return d
    """)
    keys = {f.key for f in hotpath.lint_source(src, "k.py")}
    assert "traced-branch:kernel.d" in keys
    assert "host-sync:kernel.np.asarray" in keys


def test_hotpath_shape_branches_are_static():
    src = textwrap.dedent("""
        def kernel(x, flag=True):
            if x.ndim > 1:          # shape: static
                x = x + 1
            if x.dim() == 2 and x.size(0) and x.numel():
                x = x + 1
            if x.device.type == "cpu":
                x = x + 1
            if flag:                # config default: static
                x = x + 2
            if x is None:           # structural guard
                return None
            n = len(x.shape)
            for i in range(n):      # laundered through len/.shape
                x = x + i
            return x
    """)
    assert hotpath.lint_source(src, "k.py") == []


def test_hotpath_flags_setup_in_func():
    """A kernel library loaded or a function compiled in a function body:
    per call unless a module-level cache keeps it (the counterpart of the
    reference's jit-in-func)."""
    src = textwrap.dedent("""
        import ctypes
        import torch
        from stellar_tpu_torch.ops import _build

        def dispatch(x, dev):
            lib = _build.library("verify_cold", dev)
            so = ctypes.CDLL("libx.so")
            f = torch.compile(lambda v: v + 1)
            g = torch.jit.script(lambda v: v - 1)

            @torch.compile
            def h(v):
                return v + 2
            return lib, so, f(x), g(x), h(x)
    """)
    keys = {f.key for f in hotpath.lint_source(src, "d.py",
                                               device_file=False)}
    assert keys == {"setup-in-func:dispatch._build.library",
                    "setup-in-func:dispatch.ctypes.CDLL",
                    "setup-in-func:dispatch.torch.compile",
                    "setup-in-func:dispatch.jit.script",
                    "setup-in-func:dispatch.h.torch.compile"}
    top = textwrap.dedent("""
        import torch

        @torch.compile
        def kernel(v):
            return v + 1
    """)
    assert hotpath.lint_source(top, "k.py", device_file=False) == []


@pytest.mark.parametrize("inject,key", [
    ("    ops[0].sum().item()\n", "host-sync:_verify.item"),
    ("    torch.cuda.synchronize()\n", "host-sync:_verify.synchronize"),
    ("    ops = [o.cpu() for o in ops]\n", "host-sync:_verify.cpu"),
])
def test_mutant_sync_in_kernel_wrapper_caught(inject, key):
    """A sync put into the verify wrappers' shared body (the wrappers
    promise to launch on the current stream with no synchronise) fails
    the gate."""
    rel = "stellar_tpu_torch/ops/verify.py"
    src = (repo_root() / rel).read_text()
    anchor = "    dev, n = _build.check_operands(wrapper.__name__, ops, " \
             "shapes)\n"
    assert anchor in src
    mutant = src.replace(anchor, anchor + inject)
    findings = hotpath.lint_source(mutant, rel)
    assert key in {f.key for f in findings}
    rep = finish_report("hotpath", 1, findings, hotpath.ALLOWLIST)
    assert key in {f.key for f in rep.findings} and not rep.ok


# ---------------- clean tree, scopes, allowlists ----------------

@pytest.mark.parametrize("lint", [hotpath, locks, nondet, lockorder],
                         ids=["hotpath", "locks", "nondet", "lockorder"])
def test_lint_clean_on_tree(lint):
    rep = lint.run()
    assert rep.ok, "\n" + rep.describe()


def test_allowlist_requires_written_reason():
    with pytest.raises(ValueError):
        Allowlist({"f.py": {"rule:sym": ""}})
    with pytest.raises(ValueError):
        Allowlist({"f.py": {"rule:sym": "ok"}})  # too short to argue


def test_stale_allowlist_fails_every_family():
    stale = Allowlist({"ghost.py": {"rule:gone": "a written reason for "
                                    "code that no longer exists"}})
    rep = finish_report("locks", 1, [], stale)
    assert rep.stale_allowlist == ["ghost.py:rule:gone"]
    assert not rep.ok
    for lint in (hotpath, locks, nondet, lockorder):
        assert not lint.run(Allowlist({
            "ghost.py": {"rule:gone": "a written reason for code that "
                                      "no longer exists"}})).ok


def _in_port(rel: str) -> bool:
    return rel.startswith("stellar_tpu/") and \
        os.path.exists(os.path.join(ROOT, _port_text(rel)))


def _ref_scope_in_port(scope):
    """The reference's scope entries the port has, named as the port's."""
    return {_port_text(rel) for rel in scope if _in_port(rel)}


def test_scope_sets_pinned():
    """Both scope sets, exactly: every file of the reference's scope that
    the port has, plus the port's own (the kernel build; the traffic
    vectors). Growing a scope is routine; shrinking one is how a lint dies
    in place."""
    assert set(locks.SCOPE) == \
        _ref_scope_in_port(ref_locks.SCOPE) | \
        {"stellar_tpu_torch/ops/_build.py"}
    assert len(locks.SCOPE) == len(set(locks.SCOPE)) == 28
    # the reference's device watcher is a tool of a later slice
    assert [r for r in ref_locks.SCOPE if not _in_port(r)] == \
        ["tools/device_watch.py"]
    assert set(nondet.HOST_ORACLE_FILES) == \
        _ref_scope_in_port(ref_nondet.HOST_ORACLE_FILES) | \
        {"stellar_tpu_torch/crypto/vectors.py"}
    assert [r for r in ref_nondet.HOST_ORACLE_FILES
            if not _in_port(r)] == ["tools/perf_sentinel.py"]
    assert nondet.CONSENSUS_DIRS == [
        _port_text(d) for d in ref_nondet.CONSENSUS_DIRS]
    assert locks.DRIFT_ROOTS == ["stellar_tpu_torch"]
    assert nondet.DRIFT_ROOTS == ["stellar_tpu_torch/crypto"]
    assert hotpath.SCOPE_DEVICE == ["stellar_tpu_torch/ops"]
    assert set(hotpath.SCOPE_HOST) == {
        "stellar_tpu_torch/crypto/batch_verifier.py",
        "stellar_tpu_torch/crypto/batch_hasher.py",
        "stellar_tpu_torch/parallel/batch_engine.py",
        "stellar_tpu_torch/ops/_build.py"}


@pytest.mark.parametrize("mod", [
    "crypto/tenant.py", "crypto/controller.py", "crypto/fleet.py",
    "crypto/ingress.py", "utils/wire.py", "utils/journal.py",
    "crypto/audit.py", "parallel/residency.py", "parallel/signer_tables.py",
    "utils/transfer_ledger.py", "crypto/nacl_box.py", "ops/sha256.py",
    "crypto/batch_hasher.py", "crypto/vectors.py"])
def test_nondet_scoped_without_allowlist(mod):
    """The modules the reference holds clock- and RNG-free with no
    allowlist entry are scoped so in the port too."""
    rel = f"stellar_tpu_torch/{mod}"
    assert rel in nondet.HOST_ORACLE_FILES
    assert rel not in nondet.ALLOWLIST._entries


def test_allowlists_pinned():
    """Every allowlist entry, by file and key: each argues the port's own
    code, and anything new must argue its case here."""
    def keys(al):
        return {rel: sorted(k) for rel, k in al._entries.items()}
    assert keys(locks.ALLOWLIST) == {
        "stellar_tpu_torch/main/command_handler.py":
            ["scope-drift:lock-ctor"],
        "stellar_tpu_torch/utils/timer.py": ["scope-drift:lock-ctor"],
        "stellar_tpu_torch/parallel/batch_engine.py": [
            "unlocked-global:configure_dispatch.AUDIT_RATE",
            "unlocked-global:configure_dispatch.DEADLINE_MS",
            "unlocked-global:configure_dispatch.DISPATCH_RETRIES"]}
    assert keys(lockorder.ALLOWLIST) == {
        "stellar_tpu_torch/utils/resilience.py":
            ["hold-and-block:WatchdogPool._loop.wait-untimed"],
        "stellar_tpu_torch/utils/native.py":
            ["hold-and-block:_load.build_library.subprocess"],
        "stellar_tpu_torch/crypto/native_prep.py":
            ["hold-and-block:_load.build_library.subprocess"],
        "stellar_tpu_torch/crypto/native_verify.py":
            ["hold-and-block:_load.build_library.subprocess"],
        "stellar_tpu_torch/soroban/native_wasm.py":
            ["hold-and-block:_load._build_lib.subprocess",
             "hold-and-block:_load_ext._build_lib.subprocess"]}
    assert keys(nondet.ALLOWLIST) == {
        "stellar_tpu_torch/crypto/keys.py":
            ["nondet:clock", "nondet:os.urandom", "nondet:random"],
        "stellar_tpu_torch/crypto/curve25519.py": ["nondet:os.urandom"],
        "stellar_tpu_torch/crypto/shorthash.py": ["nondet:os.urandom"],
        "stellar_tpu_torch/crypto/verify_service.py": ["nondet:clock"],
        "stellar_tpu_torch/crypto/batch_verifier.py":
            ["nondet:clock", "nondet:tracing-import"],
        "stellar_tpu_torch/parallel/batch_engine.py":
            ["nondet:clock", "nondet:tracing-import"]}
    # real safety arguments, not rubber stamps: a clock or RNG read in a
    # scoped module says what it never decides
    for entries in nondet.ALLOWLIST._entries.values():
        for reason in entries.values():
            assert "never" in reason or "only" in reason, reason
    assert coverage.ALLOWLIST._entries == {}


def test_nondet_fences_tracing_and_clocks():
    assert "stellar_tpu_torch/utils/tracing.py" not in \
        nondet.HOST_ORACLE_FILES
    assert "stellar_tpu_torch/utils/timeline.py" not in \
        nondet.HOST_ORACLE_FILES
    assert any(f.symbol == "clock" for f in nondet.lint_source(
        "t0 = time.perf_counter()\n", "x.py"))


def test_lockorder_graph_covers_scope():
    """The acquisition graph covers every module in locks.SCOPE, and the
    port's seams are live: the fleet router reaches the service cv, the
    service cv the SLO, tenant and metrics tier and the engines'
    registry."""
    graph = lockorder.build_graph()
    assert set(graph["modules"]) == set(locks.SCOPE)
    edges = graph["edges"]
    assert "verify_service.VerifyService._cv" in \
        edges["fleet.FleetRouter._lock"]
    for lock in ("metrics.MetricsRegistry._lock",
                 "verify_service.SloMonitor._lock",
                 "tenant.TenantSloMonitor._lock",
                 "batch_engine._engines_lock"):
        assert lock in edges["verify_service.VerifyService._cv"], lock
    assert lockorder.RECEIVER_HINTS == {
        k: (_port_text(v[0]), v[1])
        for k, v in ref_lockorder.RECEIVER_HINTS.items()}


def test_scope_drift_catches_unscoped_lock_owner():
    pruned = [s for s in locks.SCOPE if not s.endswith("workers.py")]
    hits = [f for f in locks.drift_findings(scope=pruned)
            if f.file == "stellar_tpu_torch/utils/workers.py"]
    assert len(hits) == 1 and hits[0].key == "scope-drift:lock-ctor"
    assert sorted({f.file for f in locks.drift_findings()}) == [
        "stellar_tpu_torch/main/command_handler.py",
        "stellar_tpu_torch/utils/timer.py"]


def test_nondet_scope_drift_catches_oracle_composition():
    pruned = [s for s in nondet.HOST_ORACLE_FILES
              if not s.endswith("batch_verifier.py")]
    hits = [f for f in nondet.drift_findings(scope=pruned)
            if f.file == "stellar_tpu_torch/crypto/batch_verifier.py"]
    assert len(hits) == 1
    assert hits[0].key == "scope-drift:host-oracle-import"
    assert nondet.drift_findings() == []


def test_workers_shutdown_regression():
    """The reference's worker pool fault (pool.shutdown(wait=True) under
    the submission lock, set_background's store outside it): the old
    spelling trips both lints; the port's shipped module is clean."""
    held, _ = lockorder.run_sources({"workers.py": _OLD_WORKERS})
    assert "hold-and-block:shutdown.executor-shutdown" in \
        [f.key for f in held]
    assert "unlocked-global:set_background._background" in \
        [f.key for f in locks.lint_source(_OLD_WORKERS, "workers.py")]
    rel = "stellar_tpu_torch/utils/workers.py"
    shipped = (repo_root() / rel).read_text()
    assert locks.lint_source(shipped, rel) == []
    assert lockorder.run_sources({rel: shipped})[0] == []


def test_mutant_lock_cycle_and_untimed_wait_fail_the_gate():
    for sources, rule in ((LOCKORDER_SOURCES["cycle"], "lock-cycle"),
                          (LOCKORDER_SOURCES["pair"], "lock-cycle"),
                          (LOCKORDER_SOURCES["park"], "hold-and-block")):
        findings, _ = lockorder.run_sources(sources)
        assert rule in {f.rule for f in findings}
        assert not finish_report("lockorder", 1, findings,
                                 lockorder.ALLOWLIST).ok


# ---------------- proof coverage ----------------

def test_proof_coverage_clean_on_tree():
    cov = coverage.run()
    assert cov["ok"], cov
    assert cov["proven"] == 3
    assert {k["class"] for k in cov["kernels"]} == {
        "Ed25519Workload", "Ed25519HotWorkload", "Sha256Workload"}
    assert {(k["golden"], k["stage"]) for k in cov["kernels"]} == {
        ("stellar_tpu_torch/analysis/limb_bounds.json", "kernel_total"),
        ("stellar_tpu_torch/analysis/limb_bounds.json", "kernel_hot_total"),
        ("stellar_tpu_torch/analysis/sha256_bounds.json", "sha256_kernel")}


def test_proof_coverage_ignores_test_fixture_workloads():
    from stellar_tpu_torch.parallel import batch_engine

    class _FixtureWorkload(batch_engine.Workload):  # noqa: unused
        metrics_ns = "test.fixture"
        variant_name = None

    names = {c for _ns, _v, c in coverage.enumerate_kernels()}
    assert "_FixtureWorkload" not in names
    assert coverage.run()["ok"]


def test_proof_coverage_unmapped_variant_fails():
    """A new Workload plugin with no PROOF_STAGES mapping fails the gate:
    as a row, and as a registered subclass of the port's engine."""
    findings, rows = coverage.check(
        [("crypto.bls", "msm", "BlsMsmWorkload")], {})
    assert [f.key for f in findings] == ["proof-coverage:crypto.bls:msm"]
    assert rows[0]["proven"] is False
    assert not finish_report("proof_coverage", 1, findings,
                             Allowlist({})).ok
    from stellar_tpu_torch.parallel import batch_engine
    kernels = coverage.enumerate_kernels() + [
        ("crypto.bls", "msm", "BlsMsmWorkload")]
    found, _ = coverage.check(kernels, coverage._load_goldens(repo_root()))
    assert [f.key for f in found] == ["proof-coverage:crypto.bls:msm"]
    assert batch_engine.Workload in type.mro(
        coverage.importlib.import_module(
            "stellar_tpu_torch.crypto.batch_verifier").Ed25519Workload)


def test_proof_coverage_missing_stage_fails():
    rel = "stellar_tpu_torch/analysis/limb_bounds.json"
    stages = {("crypto.verify", None): (rel, "kernel_total")}
    findings, rows = coverage.check(
        [("crypto.verify", None, "Ed25519Workload")], {rel: {"stages": {}}},
        proof_stages=stages)
    assert [f.key for f in findings] == ["proof-coverage:crypto.verify:cold"]
    assert "stellar_tpu_torch.tools.analyze --write-golden" in \
        findings[0].message
    assert not rows[0]["proven"]
    findings, rows = coverage.check(
        [("crypto.verify", None, "Ed25519Workload")],
        {rel: {"stages": {"kernel_total": {"max_abs": 7}}}},
        proof_stages=stages)
    assert findings == [] and rows[0]["proven"]


# ---------------- the CLI and the probe ----------------

def test_analyze_json_with_jax_blocked():
    """The whole gate in a fresh interpreter in which importing jax or
    the reference's package fails: exit 0, every family clean, and each
    proven envelope's hash equal to its committed golden's."""
    code = "\n".join([
        "import runpy, sys",
        "sys.modules['jax'] = None",
        "sys.modules['stellar_tpu'] = None",
        "sys.argv = ['analyze', '--json']",
        "runpy.run_module('stellar_tpu_torch.tools.analyze', "
        "run_name='__main__')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"]
    assert set(out["lints"]) == {"hotpath", "locks", "nondet", "lockorder"}
    assert all(rep["ok"] for rep in out["lints"].values())
    assert out["proof_coverage"]["proven"] == 3
    for key in ("overflow", "overflow_sha256"):
        assert out[key]["golden"] == "match"
        assert out[key]["envelope_sha256"] == out[key]["golden_sha256"]


def test_analyze_lint_only_fails_on_an_open_finding(monkeypatch, capsys):
    from stellar_tpu_torch.tools import analyze
    monkeypatch.setattr(hotpath, "ALLOWLIST", Allowlist({}))
    assert analyze.main(["--lint-only"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] lint:hotpath" in out and "ANALYSIS_FAIL" in out
    monkeypatch.undo()
    assert analyze.main(["--lint-only", "--json"]) == 0


def test_device_probe_records_no_card_and_fails(monkeypatch, tmp_path):
    """Here there is no card: the probe records ok False with no device
    (it never probes the CPU in the card's place), appends its line to its
    own log, and exits nonzero."""
    log = tmp_path / "probes.jsonl"
    monkeypatch.setattr(device_probe, "LOG", str(log))
    assert device_probe.main(["120"]) == 3
    rec = json.loads(log.read_text().splitlines()[-1])
    assert rec["ok"] is False and rec["devices"] == []
    assert rec["platform"] is None and rec["n_devices"] == 0
    assert os.path.basename(device_probe.LOG) == "probes.jsonl"
    monkeypatch.undo()
    assert device_probe.LOG == os.path.join(
        ROOT, "build", "torch_device_probes.jsonl")

"""The port's node (``stellar_tpu_torch.scp``, ``herder.herder``,
``herder.transaction_queue``, ``quorum_tracker``, ``quorum_intersection``,
``main.config``, ``main.maintainer``, ``main.application``,
``simulation.simulation``, ``utils.toml_compat``, ``utils.logging``)
against the reference's.

The copies are held to the reference's source (``_torch_port.check_copy``);
``main/application.py`` is the one partial copy: its
``_apply_global_config`` and ``_verify_health`` are the port's own, and the
rest of ``_apply_global_config`` equals the reference's statement for
statement; where a card answers, it puts the card behind ``verify_sig``
whatever the worker pool. Networks of the port's ``Application`` s (two nodes at
threshold 2, ``core4``, and 16 validators for two ledgers) close the same
header hashes, ledger by ledger, and exchange the same SCP statements,
slot by slot, as the reference's from the same seeds. ``Config`` loads the
same TOML into the same fields. Each ``VERIFY_*`` group of
``_apply_global_config`` reaches the port's own owner of that state, and
``_verify_health`` reads the port's per-engine dispatch state.
``chip_smoke.py``'s config 4 pins are checked by a ``slow`` test.

Both packages verify through their pure-Python oracles, and the port
hashes through ``hash_many`` on the CPU. No JAX program is compiled.
"""

import ast
import dataclasses
import importlib
import re

import pytest

from stellar_tpu_torch.crypto import batch_hasher as pbh
from stellar_tpu_torch.main import application as papp
from stellar_tpu_torch.parallel import (batch_engine, device_health,
                                        residency, signer_tables)

from tests._torch_node import Side, apps, authenticated, closes
from tests._torch_port import (ROOT, chip_smoke_constants, check_copy,
                               module_paths, normalized)

PORT, REF = Side("stellar_tpu_torch"), Side("stellar_tpu")


def _mod(side, rel):
    return importlib.import_module(f"{side.package}.{rel}")

MODULES = ["scp/__init__.py", "scp/quorum.py", "scp/driver.py",
           "scp/nomination.py", "scp/ballot.py", "scp/slot.py",
           "scp/scp.py", "herder/transaction_queue.py",
           "herder/quorum_tracker.py", "herder/quorum_intersection.py",
           "herder/herder.py", "utils/toml_compat.py", "utils/logging.py",
           "main/__init__.py", "main/config.py", "main/maintainer.py",
           "main/application.py", "simulation/__init__.py",
           "simulation/simulation.py"]

# the Config knobs the reference hands to one ``configure_dispatch``
# (``stellar_tpu/main/application.py:216-244``)
DISPATCH_KNOBS = (
    "VERIFY_DEVICE_DEADLINE_MS", "VERIFY_BREAKER_FAILURE_THRESHOLD",
    "VERIFY_BREAKER_BACKOFF_MIN_S", "VERIFY_BREAKER_BACKOFF_MAX_S",
    "VERIFY_DISPATCH_RETRIES", "VERIFY_AUDIT_RATE",
    "VERIFY_DEVICE_FAILURE_THRESHOLD", "VERIFY_DEVICE_BACKOFF_MIN_S",
    "VERIFY_DEVICE_BACKOFF_MAX_S", "VERIFY_DONATE_BUFFERS",
    "VERIFY_RESIDENT_CACHE_BYTES", "VERIFY_RESIDENT_MAX_ITEM_BYTES",
    "VERIFY_RESIDENT_CONSTANTS", "VERIFY_SIGNER_TABLE_BYTES",
    "VERIFY_SIGNER_TABLE_ENABLED")


def _cpu_hash_many(blobs, device=None):
    return _REAL_HASH_MANY(blobs, device="cpu")


_REAL_HASH_MANY = pbh.hash_many


@pytest.fixture(autouse=True)
def oracles(monkeypatch):
    """Both packages verify with their oracles and flush their caches
    around each case; the port hashes on the CPU."""
    saved = (REF.keys._backend, PORT.keys._backend)
    REF.keys.set_verifier_backend(REF.ref.verify)
    PORT.keys.set_verifier_backend(PORT.ref.verify)
    for side in (PORT, REF):
        side.keys.flush_verify_cache()
    monkeypatch.setattr(pbh, "hash_many", _cpu_hash_many)
    yield
    REF.keys.set_verifier_backend(saved[0])
    PORT.keys.set_verifier_backend(saved[1])
    for side in (PORT, REF):
        side.keys.flush_verify_cache()


@pytest.mark.parametrize("rel", MODULES)
def test_copy_equals_reference(rel):
    check_copy(rel)


def _method(tree, cls, name):
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and m.name == name:
                    return m
    raise KeyError(name)


def test_apply_global_config_is_the_reference_but_for_dispatch():
    """The port's ``_apply_global_config`` is the reference's statement
    for statement once every statement that names a dispatch knob (the
    reference's one ``configure_dispatch`` block, the port's blocks per
    owner) is taken out of both, and the one statement that installs the
    device batch verifier: the reference's installs it only with a worker
    pool, the port's wherever a card answers."""
    ref_path, port_path = module_paths("main/application.py")
    bodies, installs = [], []
    for path in (ref_path, port_path):
        fn = _method(normalized(path), "Application", "_apply_global_config")
        install = [st for st in fn.body
                   if "default_verifier" in ast.dump(st)]
        kept = [st for st in fn.body if st not in install and
                not any(k in ast.dump(st) for k in DISPATCH_KNOBS)]
        bodies.append([ast.dump(st) for st in kept])
        installs.append(install)
    assert bodies[0] == bodies[1]
    assert len(bodies[0]) > 20
    assert [len(i) for i in installs] == [1, 1]
    assert "WORKER_THREADS" in ast.dump(installs[0][0].test)
    assert "WORKER_THREADS" not in ast.dump(installs[1][0].test)


@pytest.mark.parametrize("workers,backend", [
    (0, "device-batch"), (2, "device-batch+trickle")])
def test_application_puts_the_card_behind_verify_sig_by_default(
        monkeypatch, workers, backend):
    """Wherever a card answers the probe, the port's ``Application``
    installs the device batch verifier as ``verify_sig``'s backend with
    the default configuration, behind a trickle window only with a
    worker pool; with no card it installs nothing. Nothing launches: the
    probe's answer is patched, the verifier is one on the CPU and no
    signature is checked."""
    from stellar_tpu_torch.crypto import batch_verifier
    verifier = batch_verifier.BatchVerifier(device="cpu")
    monkeypatch.setattr(batch_verifier, "default_verifier",
                        lambda device=None: verifier)
    PORT.keys.set_verifier_backend(None)
    cfg = PORT.config.Config()
    cfg.WORKER_THREADS = workers
    monkeypatch.setattr(batch_verifier, "device_available", lambda: False)
    papp.Application(cfg)
    assert PORT.keys._backend is None
    monkeypatch.setattr(batch_verifier, "device_available", lambda: True)
    papp.Application(cfg)
    assert PORT.keys.get_verifier_backend_name() == backend
    owner = PORT.keys._backend.__self__
    assert getattr(owner, "_verifier", owner) is verifier


def _network_run(side, n, threshold, ledgers):
    sim = side.network(n, threshold=threshold)
    sim.start_all_nodes()
    assert authenticated(sim)
    assert sim.crank_until_ledger(ledgers, timeout=300)
    assert sim.in_consensus()
    return sim


@pytest.mark.parametrize("n,threshold", [(2, 2), (4, None)],
                         ids=["pair", "core4"])
def test_network_equals_reference(n, threshold):
    """The same validators from the same seeds close the same header
    hashes, ledger by ledger, and record the same statements, slot by
    slot, in both packages."""
    got = {}
    for side in (PORT, REF):
        sim = _network_run(side, n, threshold, 5)
        got[side.package] = (
            {seq: closes(sim, seq) for seq in range(2, 6)},
            {seq: side.statement_digest(sim, seq) for seq in range(2, 6)},
            side.statements(sim))
    port, ref = got["stellar_tpu_torch"], got["stellar_tpu"]
    assert all(len(h) == 1 for h in port[0].values())
    assert port == ref


def test_config4_two_ledgers_equal_reference():
    """``BASELINE.json`` config 4's network, 16 validators at threshold
    11, cut to two ledgers: the same ledger 3 and the same statements."""
    got = {}
    for side in (PORT, REF):
        sim = _network_run(side, 16, None, 3)
        got[side.package] = (closes(sim, 3), side.statement_digest(sim),
                             side.statements(sim))
    assert got["stellar_tpu_torch"] == got["stellar_tpu"]
    assert len(got["stellar_tpu"][0]) == 1


@pytest.mark.slow
def test_config4_pin_is_the_reference():
    """``chip_smoke.py``'s ``NET_LEDGER_HASH`` and
    ``NET_STATEMENT_DIGEST`` are the reference's run of config 4: 16
    validators, 5 ledgers after the mesh authenticated."""
    const = chip_smoke_constants()
    n, rounds = const["NET_VALIDATORS"], const["NET_ROUNDS"]
    sim = REF.network(n)
    sim.start_all_nodes()
    assert authenticated(sim)
    last = apps(sim)[0].lm.ledger_seq + rounds
    assert sim.crank_until_ledger(last, timeout=600)
    assert closes(sim, last) == {const["NET_LEDGER_HASH"]}
    assert REF.statement_digest(sim) == const["NET_STATEMENT_DIGEST"]


def test_quorum_tracker_equals_reference():
    """After core4 closes its ledgers, each node's ``QuorumTracker``
    analysis and the intersection check agree across the packages."""
    got = {}
    for side in (PORT, REF):
        sim = _network_run(side, 4, None, 3)
        qt = _mod(side, "herder.quorum_tracker")
        qi = _mod(side, "herder.quorum_intersection")
        out = []
        for app in apps(sim):
            tracker = qt.QuorumTracker(app.herder)
            qmap = tracker.node_qset_map()
            out.append((sorted(qmap), tracker.analyze(),
                        qi.QuorumIntersectionChecker(
                            qmap).network_enjoys_quorum_intersection()))
        got[side.package] = out
    assert got["stellar_tpu_torch"] == got["stellar_tpu"]


# ---------------- Config ----------------

def _example_toml():
    raw = (ROOT / "docs" / "stellar_tpu_example.cfg").read_text()
    return re.sub(r'NODE_SEED\s*=\s*"[^"]*"',
                  'NODE_SEED = "torch-port-example"', raw)


def _plain(side, value):
    """A Config field's value as plain data: XDR values as their bytes,
    keys as their seeds."""
    if isinstance(value, side.keys.SecretKey):
        return ("seed", value.seed)
    if isinstance(value, side.xscp.SCPQuorumSet):
        return ("qset", side.rt.to_bytes(side.xscp.SCPQuorumSet, value))
    if isinstance(value, (list, tuple)):
        return [_plain(side, v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(side, v) for k, v in value.items()}
    return value


def test_config_load_equals_reference(tmp_path):
    """The annotated example config, loaded by each package's
    ``Config.from_toml``, gives equal fields (XDR by bytes); the TOML
    readers agree with ``tomllib``."""
    import tomllib
    path = tmp_path / "example.cfg"
    path.write_text(_example_toml())
    got = {}
    for side in (PORT, REF):
        cfg = side.config.Config.from_toml(str(path))
        got[side.package] = {f.name: _plain(side, getattr(cfg, f.name))
                             for f in dataclasses.fields(cfg)}
        got[side.package]["network_id"] = cfg.network_id()
    assert got["stellar_tpu_torch"] == got["stellar_tpu"]
    assert len(got["stellar_tpu"]) > 100
    text = path.read_text()
    ptc = _mod(PORT, "utils.toml_compat")
    rtc = _mod(REF, "utils.toml_compat")
    assert ptc.loads(text) == rtc.loads(text) == tomllib.loads(text)


# ---------------- the port's _apply_global_config ----------------

def _app(**knobs):
    cfg = PORT.config.Config()
    cfg.NODE_SEED = PORT.keys.SecretKey.from_seed_str("apply-config")
    cfg.QUORUM_INTERSECTION_CHECKER = False
    for name, value in knobs.items():
        setattr(cfg, name, value)
    timer = _mod(PORT, "utils.timer")
    return papp.Application(cfg, clock=timer.VirtualClock(timer.VIRTUAL_TIME))


class _Engine:
    """A stand-in default engine: one device whose breaker is open, its
    health the port's ``DeviceHealth``."""

    def __init__(self, convicted=()):
        self.health = device_health.DeviceHealth()
        self.convicted = set(convicted)
        self._devs = ["cuda:0", "cuda:1"]

    def health_snapshot(self):
        return {"devices": self._devs, "convicted": sorted(self.convicted),
                "device_health": self.health.snapshot()}


@pytest.fixture
def dispatch_state():
    """The dispatch knobs the port's ``_apply_global_config`` may move,
    put back after the case, and a stand-in engine registered as a
    default one."""
    saved = (batch_engine.DEADLINE_MS, batch_engine.DISPATCH_RETRIES,
             batch_engine.AUDIT_RATE, dict(vars(batch_engine._probe_breaker)),
             device_health.DEFAULT_FAILURE_THRESHOLD,
             device_health.DEFAULT_BACKOFF_MIN_S,
             device_health.DEFAULT_BACKOFF_MAX_S,
             residency.resident_cache.snapshot(),
             residency.resident_cache.enabled,
             signer_tables.signer_table_cache.snapshot()["max_bytes"],
             signer_tables.signer_table_cache.enabled)
    eng = _Engine()
    batch_engine.register_default_engine("verify:stand-in", eng)
    yield eng
    with batch_engine._engines_lock:
        batch_engine._default_engines.pop("verify:stand-in", None)
    (batch_engine.DEADLINE_MS, batch_engine.DISPATCH_RETRIES,
     batch_engine.AUDIT_RATE) = saved[:3]
    vars(batch_engine._probe_breaker).update(saved[3])
    (device_health.DEFAULT_FAILURE_THRESHOLD,
     device_health.DEFAULT_BACKOFF_MIN_S,
     device_health.DEFAULT_BACKOFF_MAX_S) = saved[4:7]
    residency.resident_cache.configure(
        max_bytes=saved[7]["max_bytes"],
        max_item_bytes=saved[7]["max_item_bytes"], enabled=saved[8])
    signer_tables.signer_table_cache.configure(max_bytes=saved[9],
                                               enabled=saved[10])


def _dispatch(eng):
    br = batch_engine._probe_breaker.snapshot()
    return {"deadline_ms": batch_engine.DEADLINE_MS,
            "retries": batch_engine.DISPATCH_RETRIES,
            "audit_rate": batch_engine.AUDIT_RATE,
            "failure_threshold": br["failure_threshold"]}


def _device(eng):
    br = eng.health.breaker(0).snapshot()
    return {"defaults": (device_health.DEFAULT_FAILURE_THRESHOLD,
                         device_health.DEFAULT_BACKOFF_MIN_S,
                         device_health.DEFAULT_BACKOFF_MAX_S),
            "engine": (br["failure_threshold"], eng.health._backoff_min,
                       eng.health._backoff_max)}


def _resident(eng):
    snap = residency.resident_cache.snapshot()
    return {"max_bytes": snap["max_bytes"],
            "max_item_bytes": snap["max_item_bytes"],
            "enabled": residency.resident_cache.enabled}


def _signer(eng):
    return {"max_bytes":
            signer_tables.signer_table_cache.snapshot()["max_bytes"],
            "enabled": signer_tables.signer_table_cache.enabled}


GROUPS = {
    "dispatch": ({"VERIFY_DEVICE_DEADLINE_MS": 1234,
                  "VERIFY_DISPATCH_RETRIES": 5, "VERIFY_AUDIT_RATE": 0.25,
                  "VERIFY_BREAKER_FAILURE_THRESHOLD": 7}, _dispatch,
                 {"deadline_ms": 1234.0, "retries": 5, "audit_rate": 0.25,
                  "failure_threshold": 7}),
    "device": ({"VERIFY_DEVICE_FAILURE_THRESHOLD": 6,
                "VERIFY_DEVICE_BACKOFF_MIN_S": 2.5,
                "VERIFY_DEVICE_BACKOFF_MAX_S": 30.0}, _device,
               {"defaults": (6, 2.5, 30.0), "engine": (6, 2.5, 30.0)}),
    "resident": ({"VERIFY_RESIDENT_CACHE_BYTES": 1 << 20,
                  "VERIFY_RESIDENT_MAX_ITEM_BYTES": 1 << 12,
                  "VERIFY_RESIDENT_CONSTANTS": False}, _resident,
                 {"max_bytes": 1 << 20, "max_item_bytes": 1 << 12,
                  "enabled": False}),
    "signer_table": ({"VERIFY_SIGNER_TABLE_BYTES": 1 << 21,
                      "VERIFY_SIGNER_TABLE_ENABLED": False}, _signer,
                     {"max_bytes": 1 << 21, "enabled": False}),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_verify_knobs_reach_the_port(group, dispatch_state):
    """A node whose Config changes a ``VERIFY_*`` group pushes it to the
    port's owner of that state: the process-wide dispatch knobs, every
    default engine's per-device breakers (and the defaults of engines
    built later), the resident cache, the signer-table cache."""
    knobs, read, want = GROUPS[group]
    before = read(dispatch_state)
    assert before != want
    _app(**knobs)
    assert read(dispatch_state) == want


def test_donate_buffers_is_refused(dispatch_state):
    """``VERIFY_DONATE_BUFFERS`` has no counterpart in the port: a changed
    value raises, naming the divergence; the default passes."""
    _app()
    with pytest.raises(ValueError, match="VERIFY_DONATE_BUFFERS"):
        _app(VERIFY_DONATE_BUFFERS="1")


def test_verify_health_reads_the_engines(dispatch_state):
    """``_verify_health`` (and ``info()``) over a default engine whose
    device 1 breaker is open: the degraded status line names the engine,
    the device and the state; with every breaker closed, a convicted
    device gives the quarantined line; then no line."""
    app = _app()
    eng = dispatch_state
    status = _mod(PORT, "utils.status")
    cat = status.StatusCategory.VERIFY_DEVICE
    health = app._verify_health()
    assert "verify:stand-in" in health["engines"]
    assert health["backend"] == PORT.keys.get_verifier_backend_name()
    assert app.status_manager.get_status(cat) == ""
    eng.health.breaker(0)
    eng.health.breaker(1).trip()
    info = app.info()
    line = app.status_manager.get_status(cat)
    assert "degraded" in line and "verify:stand-in device 1" in line
    assert "open" in line
    assert info["verify"]["engines"]["verify:stand-in"][
        "device_health"]["quarantined"] == [1]
    eng.health = device_health.DeviceHealth()
    eng.convicted = {0}
    app._verify_health()
    line = app.status_manager.get_status(cat)
    assert "quarantined" in line and "verify:stand-in:0" in line
    eng.convicted = set()
    app._verify_health()
    assert app.status_manager.get_status(cat) == ""

"""The port's node verify cache (``stellar_tpu_torch.crypto.keys``)
against the reference's (``stellar_tpu.crypto.keys``).

The same sequence of ``verify_sig``, ``seed_verify_cache``,
``cached_verify_sig``, ``seed_cache_assume_valid``,
``batch_verify_into_cache`` and ``flush_verify_cache`` calls gives the
same verdicts and the same ``get_verify_cache_stats()`` in both: the
reference with its pure-Python oracle as the backend, the port with a CPU
``BatchVerifier`` at bucket 16 installed (``BatchVerifier.install``), so
its prefetch of at least ``MIN_DEVICE_BATCH`` rows rides the verifier's
``verify_batch``. With no backend and no card the port's prefetch raises,
where the reference verifies on the host (ROADMAP.md, divergences).
"""

import numpy as np
import pytest
import torch

from stellar_tpu.crypto import ed25519_ref as jref
from stellar_tpu.crypto import keys as jkeys
from stellar_tpu_torch.crypto import keys as pkeys
from stellar_tpu_torch.crypto import vectors
from stellar_tpu_torch.crypto.batch_verifier import BatchVerifier


@pytest.fixture(autouse=True)
def clean_caches():
    saved = (jkeys._backend, pkeys._backend)
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()
    yield
    jkeys.set_verifier_backend(saved[0])
    pkeys.set_verifier_backend(saved[1])
    jkeys.flush_verify_cache()
    pkeys.flush_verify_cache()


def _items():
    """50 triples: good ones, tampered messages, and edge rows (a
    small-order key, a non-canonical s, bad lengths)."""
    rng = np.random.default_rng(71)
    items = vectors.valid_items(rng, 44)
    for i in range(0, 44, 7):
        pk, msg, sig = items[i]
        items[i] = (pk, msg + b"!", sig)
    edge = vectors.edge_corpus(rng)
    items += [edge[1], edge[3], edge[-9], edge[-4], edge[0], edge[-1]]
    return items


def _sequence(keys, items):
    out = []

    def stats(tag):
        out.append((tag, keys.get_verify_cache_stats()))

    keys.batch_verify_into_cache(items[:40])   # >= MIN_DEVICE_BATCH
    stats("prefetched")
    out.append([keys.verify_sig(*it) for it in items[:40]])
    stats("hits")
    out.append([keys.verify_sig(*it) for it in items[40:42]])
    stats("misses")
    keys.seed_verify_cache([it + (jref.verify(*it),)
                            for it in items[42:45]])
    out.append([keys.cached_verify_sig(*it) for it in items[42:47]])
    out.append(keys.seed_cache_assume_valid(items[46:48]))
    out.append([keys.verify_sig(*it) for it in items[45:48]])
    stats("seeded")
    keys.batch_verify_into_cache(items[:3] + items[48:50])
    out.append([keys.cached_verify_sig(*it) for it in items[48:50]])
    stats("small prefetch")
    keys.flush_verify_cache()
    stats("flushed")
    out.append(keys.verify_sig(*items[1]))
    stats("after flush")
    return out


def test_cache_sequence_equals_reference():
    items = _items()
    want = [jref.verify(*it) for it in items]
    assert 6 <= want.count(False) <= 12
    jkeys.set_verifier_backend(jref.verify)
    v = BatchVerifier(device="cpu", bucket_sizes=(16,)).install()
    assert pkeys.get_verifier_backend_name() == "device-batch"
    served = v.served["device"]
    ours, theirs = _sequence(pkeys, items), _sequence(jkeys, items)
    assert ours == theirs
    # the prefetch rode the verifier: every gate-passing row of the 40
    assert v.served["device"] - served >= 30
    assert ours[1] == want[:40] and ours[3] == want[40:42]


def test_small_prefetch_without_backend_equals_reference():
    """Below MIN_DEVICE_BATCH with no backend installed both packages
    verify with their oracle, row by row."""
    items = _items()[:5] + _items()[-3:]
    for keys in (jkeys, pkeys):
        keys.set_verifier_backend(None)
        keys.batch_verify_into_cache(items)
    assert pkeys.get_verify_cache_stats() == jkeys.get_verify_cache_stats()
    got = [pkeys.cached_verify_sig(*it) for it in items]
    assert got == [jkeys.cached_verify_sig(*it) for it in items]
    assert got == [jref.verify(*it) if len(it[0]) == 32 and
                   len(it[2]) == 64 else False for it in items]
    assert pkeys.get_verifier_backend_name().startswith("auto(host<32,")


def test_large_prefetch_without_backend_needs_a_card():
    items = _items()[:40]
    pkeys.set_verifier_backend(None)
    if torch.cuda.is_available():
        pkeys.batch_verify_into_cache(items)
        assert pkeys.get_verify_cache_stats()["size"] == 40
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pkeys.batch_verify_into_cache(items)
        assert pkeys.get_verify_cache_stats()["size"] == 0


def test_install_with_trickle_window():
    items = _items()[:3]
    v = BatchVerifier(device="cpu", bucket_sizes=(16,))
    v.install(trickle_window_ms=1.0)
    assert pkeys.get_verifier_backend_name() == "device-batch+trickle"
    assert pkeys._backend.__self__._verifier is v
    assert [pkeys.verify_sig(*it) for it in items] == \
        [jref.verify(*it) for it in items]
    assert pkeys._backend.__self__.dispatches == 3

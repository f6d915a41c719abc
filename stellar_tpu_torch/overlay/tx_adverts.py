"""Pull-mode transaction flooding (reference ``src/overlay/TxAdverts.h``
/ ``.cpp`` + ``TxDemandsManager.cpp``).

Instead of pushing full transactions to every peer, a node floods
FLOOD_ADVERT messages carrying tx *hashes*; peers that don't know a
hash send FLOOD_DEMAND back to ONE advertiser at a time, which answers
with the TRANSACTION message. This turns O(peers) tx bandwidth into
O(peers) hash bandwidth + O(1) tx transfers, and is why byte-level flow
control matters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from stellar_tpu_torch.xdr.overlay import (
    FloodAdvert, FloodDemand, MAX_TX_ADVERT_VECTOR, MessageType,
    StellarMessage,
)

__all__ = ["TxAdverts", "TxDemandsManager"]

ADVERT_FLUSH_SIZE = 50          # reference batches up to ~max/2
DEMAND_RETRY_LEDGERS = 1        # re-demand from another peer next close
MAX_RETAINED_ADVERTS = 10_000


class TxAdverts:
    """Per-peer outgoing advert queue + incoming advert memory
    (reference ``TxAdverts``)."""

    def __init__(self):
        # id(peer) -> [hashes to advertise]
        self.outgoing: Dict[int, List[bytes]] = {}
        # id(peer) -> set of hashes that peer advertised to us
        self.incoming: Dict[int, set] = {}

    # per-peer outgoing queue byte cap (reference
    # OUTBOUND_TX_QUEUE_BYTE_LIMIT; 32 bytes per queued hash); set by
    # the Application from Config
    queue_byte_limit = 1024 * 1024 * 3

    def queue_advert(self, peer, tx_hash: bytes) -> int:
        """Queue one advert; returns that peer's queue depth so the
        caller can force a flush on a half-full queue. Overflowing
        queues shed their OLDEST adverts (stale hashes are the least
        likely to still be demandable)."""
        q = self.outgoing.setdefault(id(peer), [])
        q.append(tx_hash)
        max_len = max(1, self.queue_byte_limit // 32)
        if len(q) > max_len:
            del q[:len(q) - max_len]
        return len(q)

    def flush(self, peers_by_id: Dict[int, object],
              force: bool = False, quotas=None, lane_of=None):
        """Send queued adverts; small queues flush immediately at sim
        scale (the reference flushes on a timer or when half-full).

        ``quotas`` ({lane: count} per peer, with ``lane_of(hash)``)
        rate-limits how many adverts leave per call (reference
        FLOOD_*_RATE/PERIOD pacing); hashes over quota stay queued."""
        for pid, hashes in list(self.outgoing.items()):
            if not hashes:
                continue
            if not force and len(hashes) < 1:
                continue
            peer = peers_by_id.get(pid)
            if peer is None:
                del self.outgoing[pid]
                continue
            if quotas is not None and lane_of is not None:
                budget = dict(quotas)
                batch, rest = [], []
                for h in hashes:
                    lane = lane_of(h)
                    if len(batch) < MAX_TX_ADVERT_VECTOR and \
                            budget.get(lane, 0) > 0:
                        budget[lane] -= 1
                        batch.append(h)
                    else:
                        rest.append(h)
                self.outgoing[pid] = rest
            else:
                batch, self.outgoing[pid] = \
                    hashes[:MAX_TX_ADVERT_VECTOR], \
                    hashes[MAX_TX_ADVERT_VECTOR:]
            if batch:
                peer.send(StellarMessage.make(
                    MessageType.FLOOD_ADVERT,
                    FloodAdvert(txHashes=batch)))

    def note_incoming(self, peer, hashes: List[bytes]):
        s = self.incoming.setdefault(id(peer), set())
        s.update(hashes)
        if len(s) > MAX_RETAINED_ADVERTS:
            self.incoming[id(peer)] = set(list(s)[-MAX_RETAINED_ADVERTS:])

    def advertisers_of(self, tx_hash: bytes) -> List[int]:
        return [pid for pid, s in self.incoming.items() if tx_hash in s]

    def forget_peer(self, peer):
        self.outgoing.pop(id(peer), None)
        self.incoming.pop(id(peer), None)


class TxDemandsManager:
    """Outstanding demands with rotation across advertisers (reference
    ``TxDemandsManager``)."""

    def __init__(self, backoff_s: float = 0.0,
                 retry_period_s: float = 0.0):
        # tx hash -> [id(peer) demanded from, asked set, age, started]
        self.pending: Dict[bytes, list] = {}
        # minimum seconds before re-demanding from another peer
        # (reference FLOOD_DEMAND_BACKOFF_DELAY_MS) and the base
        # re-demand cadence (reference FLOOD_DEMAND_PERIOD_MS)
        self.backoff_s = backoff_s
        self.retry_period_s = retry_period_s

    def start_demand(self, tx_hash: bytes, peer,
                     now: float = 0.0) -> bool:
        """True if a demand should be sent to this peer now."""
        rec = self.pending.get(tx_hash)
        if rec is not None:
            return False  # already demanded from someone
        self.pending[tx_hash] = [id(peer), {id(peer)}, 0, now]
        return True

    def fulfilled(self, tx_hash: bytes):
        self.pending.pop(tx_hash, None)

    def age_and_retry(self, adverts: TxAdverts,
                      peers_by_id: Dict[int, object],
                      now: float = 0.0) -> int:
        """Called at ledger close: rotate stuck demands to another
        advertiser; returns number of retries sent."""
        retries = 0
        for h, rec in list(self.pending.items()):
            rec[2] += 1
            if rec[2] < DEMAND_RETRY_LEDGERS:
                continue
            wait = max(self.backoff_s, self.retry_period_s)
            if wait and now and now - rec[3] < wait:
                continue  # too soon to pester another advertiser
            candidates = [pid for pid in adverts.advertisers_of(h)
                          if pid not in rec[1] and pid in peers_by_id]
            if not candidates:
                del self.pending[h]  # nobody left to ask
                continue
            pid = candidates[0]
            rec[0], rec[2], rec[3] = pid, 0, now
            rec[1].add(pid)
            peers_by_id[pid].send(StellarMessage.make(
                MessageType.FLOOD_DEMAND, FloodDemand(txHashes=[h])))
            retries += 1
        return retries

"""Peer connection pool (the src/peer_pool.zig equivalent; the port's copy
of ``zest_tpu/p2p/pool.py``).

Connections are keyed by (host, port) and reused across xorbs whose swarms
land on the same peer. Discipline mirrors the reference (peer_pool.zig:49-95):
connect + handshake happen *outside* the lock (slow I/O must not serialize
the pool), with a re-check on insert — the loser of a connect race closes
its duplicate. Broken connections are removed so the next attempt
reconnects; at ``max_peers`` the least-recently-used *idle* entry is
evicted (every pool access touches its key, so iteration order IS
recency order).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from zest_tpu_torch.p2p.peer import BtPeer


class PeerPool:
    def __init__(self, max_peers: int = 50):
        self.max_peers = max_peers
        self._peers: OrderedDict[tuple[str, int], BtPeer] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._peers)

    def get_or_connect(
        self,
        host: str,
        port: int,
        info_hash: bytes,
        peer_id: bytes,
        listen_port: int | None = None,
    ) -> BtPeer:
        return self.lease(host, port, info_hash, peer_id, listen_port)[0]

    def lease(
        self,
        host: str,
        port: int,
        info_hash: bytes,
        peer_id: bytes,
        listen_port: int | None = None,
        connect_timeout: float | None = None,
        io_timeout: float | None = None,
    ) -> tuple[BtPeer, bool]:
        """``(peer, reused)`` — ``reused`` tells the caller whether the
        connection predates this request. A reused socket can be stale
        (evicted mid-lease, idle-closed by the remote): an IO failure on
        it warrants one fresh-reconnect retry before the peer itself is
        blamed, which the swarm implements on top of this flag."""
        key = (host, port)
        with self._lock:
            existing = self._peers.get(key)
            if existing is not None:
                self._peers.move_to_end(key)  # LRU touch
                return existing, True

        # Slow path outside the lock.
        kwargs = {}
        if connect_timeout is not None:
            kwargs["connect_timeout"] = connect_timeout
        if io_timeout is not None:
            kwargs["io_timeout"] = io_timeout
        peer = BtPeer.connect(host, port, info_hash, peer_id, listen_port,
                              **kwargs)

        with self._lock:
            raced = self._peers.get(key)
            if raced is not None:
                # Lost the race; keep the established one.
                self._peers.move_to_end(key)
                loser = peer
                peer = raced
                reused = True
            else:
                if len(self._peers) >= self.max_peers:
                    self._evict_one_locked()
                self._peers[key] = peer
                loser = None
                reused = False
        if loser is not None:
            loser.close()
        return peer, reused

    def remove(self, host: str, port: int) -> None:
        with self._lock:
            peer = self._peers.pop((host, port), None)
        if peer is not None:
            peer.close()

    def close_all(self) -> None:
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for p in peers:
            p.close()

    def _evict_one_locked(self) -> None:
        # True LRU among idle peers: the OrderedDict iterates least-
        # recently-touched first (get_or_connect touches on every hit),
        # so the first idle entry is the coldest connection — evicting
        # an arbitrary (insertion-ordered) entry used to throw away hot
        # peers while week-old idle sockets survived. Only a peer whose
        # stream lock is free is evicted — closing a socket another
        # thread is mid-request on turns healthy transfers into
        # spurious failures. (A thread that fetched the peer but hasn't
        # locked yet can still lose it; that surfaces as one retried
        # request, which the waterfall absorbs.) All busy -> soft cap:
        # admit the newcomer and let the pool shrink on future evictions.
        for key, peer in self._peers.items():
            if not peer.lock.locked():
                self._peers.pop(key).close()
                return

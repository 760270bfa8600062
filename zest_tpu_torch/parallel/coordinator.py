"""Peer discovery through the process group's key-value store.

The counterpart of ``zest_tpu/parallel/coordinator.py``. Inside one job
every process already shares a coordination service — here the
``torch.distributed`` store (a ``TCPStore`` behind the default process
group), where the JAX package uses the ``jax.distributed`` KV client — so
discovery is a key per process, not a routing table:

    zest/avail/{info_hash_hex}/{process_id} -> "host:port"

``announce`` writes this process's endpoint under each xorb it can serve;
``find_peers`` reads every other process's key. Both registries satisfy
the swarm's peer-source surface (``find_peers``/``announce``), and the
in-memory one backs single-process runs and tests.
"""

from __future__ import annotations

import threading
from datetime import timedelta


def kv_store():
    """The default process group's key-value store, or None when
    ``torch.distributed`` is not initialized (the JAX package's
    ``_kv_client``)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return None
    return dist.distributed_c10d._get_default_store()


class InMemoryRegistry:
    """Process-local peer source; also the fake for loopback tests."""

    def __init__(self) -> None:
        self._avail: dict[bytes, dict[str, tuple[str, int]]] = {}
        self._lock = threading.Lock()
        self.self_addr: tuple[str, int] | None = None

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        with self._lock:
            items = list(self._avail.get(info_hash, {}).items())
        # Never our own announce: dialing ourselves would fake peer bytes.
        return [addr for key, addr in items
                if key != "self" and addr != self.self_addr]

    def announce(self, info_hash: bytes, port: int) -> None:
        host = self.self_addr[0] if self.self_addr else "127.0.0.1"
        with self._lock:
            self._avail.setdefault(info_hash, {})["self"] = (host, port)

    def add(self, info_hash: bytes, host: str, port: int,
            peer_key: str | None = None) -> None:
        key = peer_key if peer_key is not None else f"{host}:{port}"
        with self._lock:
            self._avail.setdefault(info_hash, {})[key] = (host, port)


class CoordinatorRegistry:
    """Peer source over a ``torch.distributed`` store: by default the
    default process group's, which ``init_process_group`` must have set
    up. Announces are idempotent sets; lookups read one key per
    process."""

    PREFIX = "zest/avail"

    def __init__(self, advertise_host: str, process_id: int | None = None,
                 store=None, world_size: int | None = None):
        import torch.distributed as dist

        if store is None or process_id is None or world_size is None:
            if not dist.is_initialized():
                raise RuntimeError(
                    "torch.distributed is not initialized; use "
                    "InMemoryRegistry or call init_process_group() first")
        self.advertise_host = advertise_host
        self.process_id = (dist.get_rank() if process_id is None
                           else process_id)
        self.world_size = (dist.get_world_size() if world_size is None
                           else world_size)
        self._store = kv_store() if store is None else store

    def _prefix(self, info_hash: bytes) -> str:
        return f"{self.PREFIX}/{info_hash.hex()}"

    def announce(self, info_hash: bytes, port: int) -> None:
        self._store.set(f"{self._prefix(info_hash)}/{self.process_id}",
                        f"{self.advertise_host}:{port}")

    def find_peers(self, info_hash: bytes) -> list[tuple[str, int]]:
        out: list[tuple[str, int]] = []
        for pid in range(self.world_size):
            key = f"{self._prefix(info_hash)}/{pid}"
            if pid == self.process_id or not self._store.check([key]):
                continue  # never ourselves; a process that never announced
            host, _, port = self._store.get(key).decode().rpartition(":")
            if host and port.isdigit():
                out.append((host, int(port)))
        return out

    def barrier(self, name: str, timeout_s: float = 60.0) -> None:
        """A store barrier: every process calls it with the same
        ``name``; each returns once all have arrived."""
        key = f"zest/barrier/{name}"
        if self._store.add(key, 1) == self.world_size:
            self._store.set(f"{key}/done", "1")
        self._store.wait([f"{key}/done"], timedelta(seconds=timeout_s))

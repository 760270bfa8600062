"""The daemon's HTTP API: publisher, control and serving routes on stdlib
``http.server``.

The counterpart of ``zest_tpu/api/http_api.py``'s routes that the port
runs. The publisher surface answers a second node's unmodified pull from
:class:`~zest_tpu_torch.transfer.push.PublisherIndex`:

    GET  /api/models/{org}/{name}/revision/{rev}       -> {"sha", "siblings"}
    POST /api/models/{org}/{name}/paths-info/{rev}     -> [{"path", "size", "xetHash"?}]
    GET  /api/models/{org}/{name}/xet-read-token/{rev} -> {"casUrl", "accessToken"}
    GET  /v1/reconstructions/{file_hex}                -> terms + fetch_info (Range-paged)
    GET  /xorbs/{xorb_hex}                             -> frame bytes (Range)
    GET  /{org}/{name}/resolve/{rev}/{file}            -> file bytes (Range)

the continuous fan-out of pushed revisions:

    POST /v1/push   {"repo", "revision", "parent"?, "xorbs"?, ...} -> {"ok", "watchers", "delivered"}
    POST /v1/watch  {"repos": [...]}  -> SSE: hello, then revision events, ping keepalives

and the control, pull and serving routes of :class:`HttpApi`:

    GET  /v1/health   -> {"status": "ok"}
    GET  /v1/status   -> node, seeding, swarm, telemetry, kernels, pulls,
                         ``tenancy``, ``timeline``, ``remediation`` and
                         ``hbm_pool`` blocks
    GET  /v1/models   -> {"models": [...], "resident": [...]}
    GET  /v1/metrics  -> Prometheus text; ``?scope=pod`` sums it with every
                         pod peer's (``Config.pod_peers``)
    GET  /v1/trace    -> the live tracer as Chrome trace JSON
    GET  /v1/debug?tail=N -> recorder tail, telemetry, trace context,
                         faults, coop/collective and landing blocks,
                         quarantined peers
    POST /v1/pull     {"repo_id", "revision"?, "device"?, "tenant"?}
                      -> SSE: start, [log...], done | cancelled | error;
                         429 + Retry-After before the stream when the
                         admission queue is full
    GET  /v1/pulls    -> {"active", "recent", "capacity", "tenancy"?}
    GET  /v1/pulls/{id}         -> one session, with stages and stats
    GET  /v1/pulls/{id}/events  -> SSE: start, [progress...], done | error
    DELETE /v1/pulls/{id}       -> 202 cancelling | 404 | 409
    GET  /v1/timeline?since=&series= -> cursor-paged series + anomalies;
                         ``?scope=pod`` merges every pod peer's onto this
                         host's clock (``timeline.merge_timelines``)
    GET  /v1/remediations?limit=N -> the engine's state and decision log
    POST /v1/remediations {"dry_run": bool} -> {"dry_run"}
    GET  /            -> the dashboard (status, pulls, timelines, pool)
    POST /v1/generate {"repo_id", "ids" | "prompt", "steps", ...}
                      -> SSE: start, pulled, [token...], done | error
    POST /v1/stop     -> {"status": "stopping"}

A pull's ``device`` follows the JAX package: absent, the pull writes the
snapshot's files and lands nothing; ``"cuda"`` lands on ``cuda:0`` and
``"cpu"`` on the CPU (no request lands on the CPU unless it asks to).
The stream's ``done`` event carries ``snapshot_dir`` and the pull's
stats. A client that disconnects from the stream cancels its pull.

``/v1/generate`` pulls the repo through the node's swarm (memoized for
30 s, see :meth:`HttpApi._pull_memo`) and decodes on the daemon's device
(``cuda`` unless the daemon was started with ``device="cpu"``): Llama
family and Mixtral models from the serving pool
(:mod:`~zest_tpu_torch.models.hbm_pool`), whose facts the ``done`` event
carries as ``pool``; GPT-2, and every model with ``ZEST_HBM_POOL=0``,
from a per-snapshot generator. Any failure of the pull, the landing or
the decode reaches the client as an ``error`` event.

``/v1/watch`` answers 404 when ``Config.watch_enabled`` is off
(``ZEST_WATCH=0``); a push then notifies no one. A ``/v1/push`` carrying
``xorbs`` ([[hex, size], ...]) also makes them seedable at once: they
enter the daemon's ``XorbRegistry``, its swarm announces them, and its
gossip node puts ``repo@revision`` on the gossip plane (each
best-effort), and its ``new_xorb_bytes`` and ``dedup_ratio`` are posted
to the timeline as ``push.new_xorb_bytes`` / ``push.dedup_ratio``. The
daemon runs the timeline sampler from :meth:`PublisherServer.start` on
(``ZEST_TIMELINE=0``: none).
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from zest_tpu_torch import faults, storage, telemetry
from zest_tpu_torch import __version__
from zest_tpu_torch.config import DEFAULT_DEVICE, Config
from zest_tpu_torch.telemetry import fleet
from zest_tpu_torch.transfer import tenancy
from zest_tpu_torch.transfer.push import PUBLISHER_TOKEN, PublisherIndex

# What a POST /v1/pull's "device" may name (absent: files only), and the
# device it lands on: the pull's own thread names the card explicitly.
PULL_DEVICES = {"cuda": "cuda:0", "cpu": "cpu"}


class WatchHub:
    """Fan-out of push notifications to ``POST /v1/watch`` subscribers.

    One condition and a queue per subscriber: :meth:`notify` (from a
    ``/v1/push`` handler thread) appends to every matching subscriber's
    queue and wakes them; each :meth:`subscribe` generator drains its own
    queue into the SSE stream, with a ``ping`` keepalive after ``ping_s``
    of quiet (a dead client then surfaces as a broken pipe). A disconnect
    unregisters the subscriber; :meth:`close` ends every stream."""

    def __init__(self, ping_s: float = 15.0):
        self.ping_s = ping_s
        self._cond = threading.Condition()
        self._subs: list[dict] = []
        self._closed = False

    def watchers(self) -> int:
        with self._cond:
            return len(self._subs)

    def notify(self, event: dict) -> int:
        """Deliver ``event`` to matching subscribers; returns the count."""
        delivered = 0
        with self._cond:
            for sub in self._subs:
                repos = sub["repos"]
                if repos and event.get("repo") not in repos:
                    continue
                sub["queue"].append(dict(event))
                delivered += 1
            self._cond.notify_all()
        return delivered

    def subscribe(self, repos=None):
        """SSE event generator of one subscriber; ``repos`` filters (empty
        or None: every repo)."""
        sub = {"queue": [], "repos": set(repos) if repos else None}
        with self._cond:
            self._subs.append(sub)
        try:
            yield {"event": "hello",
                   "watching": sorted(sub["repos"] or [])}
            while True:
                with self._cond:
                    if not sub["queue"] and not self._closed:
                        self._cond.wait(timeout=self.ping_s)
                    batch, sub["queue"] = sub["queue"], []
                    closed = self._closed
                if not batch and not closed:
                    yield {"event": "ping"}
                for ev in batch:
                    yield ev
                if closed:
                    return
        finally:
            with self._cond:
                if sub in self._subs:
                    self._subs.remove(sub)

    def close(self) -> None:
        """End every subscriber's stream (after what is queued)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def push_notify(hub: WatchHub, req: dict, registry=None, swarm=None,
                gossip_node=None) -> dict:
    """A ``POST /v1/push`` from a push: make its new xorbs seedable now
    (``registry`` add, ``swarm`` announce), put the revision on the
    gossip plane (``gossip_node``), and wake every watcher of the repo.
    Raises ValueError on a malformed notification (answered 400)."""
    repo, revision = req.get("repo"), req.get("revision")
    if not repo or not revision:
        raise ValueError("push notify needs repo and revision")
    try:
        xorbs = [(str(h), int(n)) for h, n in (req.get("xorbs") or [])]
    except (TypeError, ValueError) as exc:
        raise ValueError("xorbs must be [[hex, size], ...]") from exc
    if registry is not None:
        for h, n in xorbs:
            registry.add(h, n)
    if swarm is not None and xorbs:
        try:
            swarm.announce_xorbs([h for h, _ in xorbs])
        except Exception:  # noqa: BLE001 - announce is best-effort
            pass
    if gossip_node is not None:
        try:
            gossip_node.announce_manifest(
                f"{repo}@{revision}",
                {"repo": repo, "revision": revision,
                 "parent": req.get("parent"),
                 "pushed_at": req.get("pushed_at")})
        except Exception:  # noqa: BLE001 - gossip is best-effort
            pass
    telemetry.timeline.post("push.new_xorb_bytes",
                            float(req.get("new_xorb_bytes") or 0))
    if req.get("dedup_ratio") is not None:
        telemetry.timeline.post("push.dedup_ratio",
                                float(req["dedup_ratio"]))
    event = {"event": "revision", "repo": repo, "revision": revision,
             "parent": req.get("parent"),
             "pushed_at": req.get("pushed_at"),
             "dedup_ratio": req.get("dedup_ratio"),
             "new_xorb_bytes": req.get("new_xorb_bytes")}
    delivered = hub.notify(event)
    return {"ok": True, "watchers": hub.watchers(), "delivered": delivered}


class HttpApi:
    """The daemon's state behind the routes: the publisher index, the
    watch fan-out, and the serving path over ``cfg``'s caches on
    ``device``. ``swarm`` (the node's ``SwarmDownloader``) carries every
    generate's pull; ``bt_server`` (its ``BtServer``) feeds ``/v1/status``
    and the metrics; ``dcn_server`` (its ``DcnServer``) feeds the
    ``dcn`` block of ``/v1/status``; ``registry`` (its ``XorbRegistry``)
    and ``gossip_node`` take what ``POST /v1/push`` announces. ``pod_peers``
    (host index → ``(host, http_port)`` of the other hosts' daemons, else
    ``cfg.pod_peers``) are scraped for ``/v1/metrics?scope=pod``."""

    _PULL_TTL_S = 30.0

    def __init__(self, cfg: Config, device=DEFAULT_DEVICE, swarm=None,
                 bt_server=None, registry=None, gossip_node=None,
                 pod_peers: dict | None = None, dcn_server=None):
        self.cfg = cfg
        self.pod_peers = dict(pod_peers if pod_peers is not None
                              else cfg.pod_peers)
        self.device = device
        self.swarm = swarm
        self.bt_server = bt_server
        self.dcn_server = dcn_server
        self.registry = registry
        self.gossip_node = gossip_node
        self.index = PublisherIndex(cfg)
        self.watch_hub = WatchHub()
        self.port: int | None = None   # set by the server once bound
        self.http_requests = 0
        self.shutdown_event = threading.Event()
        # Live-state gauges at scrape time; removed in close().
        self._collector = self._collect_gauges
        telemetry.REGISTRY.add_collector(self._collector)
        # snapshot_dir → (model_type, generate); see _generator_for.
        self._generators: dict = {}
        self._gen_lock = threading.Lock()
        self._gen_loading: dict = {}
        # (repo_id, revision) → (snapshot_dir, expiry); see _pull_memo.
        # A streaming generate pins its key (a pinned entry never
        # expires, so no re-pull rewrites the snapshot under it), and
        # concurrent misses of one key share one pull.
        self._pulled: dict = {}
        self._snapshot_pins: dict = {}
        self._pull_inflight: dict = {}

    def trigger_shutdown(self) -> None:
        self.shutdown_event.set()

    def close(self) -> None:
        telemetry.REGISTRY.remove_collector(self._collector)
        self.watch_hub.close()

    def _collect_gauges(self, registry) -> None:
        """Scrape-time gauges from the live objects this daemon owns."""
        health = getattr(self.swarm, "health", None)
        if health is not None:
            s = health.summary()
            registry.gauge("zest_peers_tracked",
                           "Peers with recorded health").set(s["tracked"])
            registry.gauge("zest_peers_quarantined",
                           "Peers currently quarantined"
                           ).set(s["quarantined_now"])
        if self.bt_server is not None:
            bt = self.bt_server.get_stats()
            registry.gauge("zest_bt_active_peers",
                           "Active inbound BT-wire connections"
                           ).set(bt.active_peers)
            registry.gauge("zest_seed_active_leechers",
                           "Leechers connected to the seeding server"
                           ).set(bt.active_peers)
            registry.gauge("zest_seed_choked_peers",
                           "Leechers currently choked by the upload policy"
                           ).set(bt.choked_peers)
            registry.gauge("zest_seed_unchoked_peers",
                           "Leechers currently holding unchoke slots"
                           ).set(bt.unchoked_peers)

    # ── Payloads ──

    def status_payload(self) -> dict:
        from zest_tpu_torch.models import hbm_pool

        bt = self.bt_server.get_stats() if self.bt_server else None
        payload = {
            "version": __version__,
            "bt_peers": bt.active_peers if bt else 0,
            "chunks_served": bt.chunks_served if bt else 0,
            "xorbs_cached": (len(self.registry)
                             if self.registry is not None
                             else len(storage.list_cached_xorbs(self.cfg))),
            "http_requests": self.http_requests,
            "listen_port": self.cfg.listen_port,
            "http_port": self.port,
        }
        if bt is not None:
            payload["seeding"] = {
                "active_leechers": bt.active_peers,
                "unchoked": bt.unchoked_peers,
                "choked": bt.choked_peers,
                "chunks_served": bt.chunks_served,
                "bytes_served": bt.bytes_served,
                "choke_events": bt.choke_events,
                "refused_quarantined": bt.refused_quarantined,
                "uploads_expired": bt.uploads_expired,
                "rate_bps": self.cfg.seed_rate_bps or None,
                "peer_bps": self.cfg.seed_peer_bps or None,
                "slots": self.cfg.seed_slots,
            }
        if self.dcn_server is not None and self.dcn_server.port is not None:
            d = self.dcn_server.stats
            payload["dcn"] = {
                "port": self.dcn_server.port,
                "connections": d.connections,
                "chunks_served": d.chunks_served,
                "bytes_served": d.bytes_served,
                "not_found": d.not_found,
            }
        if self.swarm is not None:
            payload["swarm"] = self.swarm.summary()
            health = getattr(self.swarm, "health", None)
            if health is not None:
                payload["peers"] = health.detail()
        payload["telemetry"] = telemetry.status_snapshot()
        payload["kernels"] = kernel_launches()
        sessions = telemetry.session.SESSIONS
        payload["pulls"] = {"active": len(sessions.active_ids()),
                            "recent": len(sessions.recent())}
        burn = sessions.slo_burn()
        if burn:
            payload["slo"] = burn
        fired = faults.counters()
        if fired:
            payload["faults"] = dict(sorted(fired.items()))
        # The pull service: admission, dedupe, eviction, pins. Absent
        # with ZEST_TENANCY=0.
        tn = tenancy.summary(self.cfg)
        if tn is not None:
            payload["tenancy"] = tn
        # The timeline store and the remediation engine: absent when
        # off, like tenancy.
        tl = telemetry.timeline.status_block()
        if tl.get("enabled"):
            payload["timeline"] = tl
        rm = telemetry.remediate.status_block()
        if rm.get("enabled"):
            payload["remediation"] = rm
        # The serving pool: absent with ZEST_HBM_POOL=0.
        hp = hbm_pool.pool(self.cfg, self.device)
        if hp is not None:
            payload["hbm_pool"] = hp.summary()
        return payload

    def models_payload(self) -> dict:
        """Pulled models in the HF hub cache and, with the pool on, the
        trees resident or landing on the device (``resident`` rows; a
        disk row whose repo matches gains ``pool_state``). Pool off: the
        ``models`` key alone."""
        from zest_tpu_torch.models import hbm_pool

        doc: dict = {"models": storage.list_models(self.cfg)}
        hp = hbm_pool.pool(self.cfg, self.device)
        if hp is not None:
            rows = hp.resident()
            doc["resident"] = rows
            states = {r["repo"]: r["state"] for r in rows}
            for m in doc["models"]:
                state = states.get(m.get("repo_id"))
                if state is not None:
                    m["pool_state"] = state
        return doc

    # ── Pulls ──

    def trace_payload(self) -> dict:
        """``GET /v1/trace``: the live tracer as Chrome trace JSON, the
        per-host piece ``zest trace --coop`` merges; empty, with a note,
        when no tracer is armed."""
        tracer = telemetry.trace.active()
        if tracer is None:
            return {"traceEvents": [],
                    "otherData": {"tool": "zest-tpu",
                                  "note": "no tracer armed "
                                          "(set ZEST_TRACE)"}}
        return tracer.to_chrome()

    def debug_payload(self, tail: int = 100) -> dict:
        """``GET /v1/debug``: the flight recorder's tail, the telemetry
        snapshot, the trace context, fired faults, the coop and collective
        summary from the metrics, the last landing (from the session
        table, the ``zest_last_pull_*`` gauges as fallback) and the
        quarantined peers."""
        rec = telemetry.recorder.RECORDER
        payload: dict = {
            "recorder": {
                "capacity": rec.capacity,
                "recorded_total": rec.recorded,
                "events": rec.tail(tail),
            },
            "telemetry": telemetry.status_snapshot(),
        }
        ctx = telemetry.trace.current_context()
        if ctx:
            payload["trace_context"] = ctx
        fired = faults.counters()
        if fired:
            payload["faults"] = dict(sorted(fired.items()))

        tiers = {}
        for labels, value in self._metric_samples("zest_coop_bytes_total"):
            tiers[labels.get("tier", "")] = int(value)
        coop: dict = {}
        if tiers:
            peer = tiers.get("peer", 0) + tiers.get("dcn", 0)
            total = peer + tiers.get("cdn", 0) + tiers.get("fallback", 0)
            coop["tier_bytes"] = tiers
            coop["peer_served_ratio"] = (
                round(peer / total, 4) if total else None)
        wall = self._metric_samples("zest_coop_exchange_wall_seconds")
        if wall:
            coop["exchange_wall_s"] = round(wall[0][1], 3)
        for _labels, value in self._metric_samples(
                "zest_coop_fallbacks_total"):
            coop["fallbacks"] = int(value)
        # The collective's last round: phases, wall, and cumulative wire
        # bytes per link class.
        collective: dict = {}
        phases = self._metric_samples("zest_coop_collective_phases")
        if phases and phases[0][1] > 0:
            collective["phases"] = int(phases[0][1])
        cwall = self._metric_samples("zest_coop_collective_wall_seconds")
        if cwall and cwall[0][1] > 0:
            collective["wall_s"] = round(cwall[0][1], 3)
        link_bytes = {}
        for labels, value in self._metric_samples(
                "zest_coop_collective_bytes_total"):
            link_bytes[labels.get("link", "")] = int(value)
        if link_bytes:
            collective["link_bytes"] = link_bytes
        for _labels, value in self._metric_samples(
                "zest_coop_collective_aborts_total"):
            collective["aborts"] = int(value)
        if collective:
            coop["collective"] = collective
        if coop:
            payload["coop"] = coop

        # One pull's values from the session table: the process gauges
        # clobber each other under concurrent pulls, so they are only the
        # fallback when the table holds no landing.
        landing = telemetry.session.last_landing() or {}
        if not landing:
            last_fl = self._metric_samples(
                "zest_last_pull_first_layer_seconds")
            if last_fl and last_fl[0][1] > 0:
                landing["first_layer_s"] = round(last_fl[0][1], 3)
            last_hbm = self._metric_samples("zest_last_pull_hbm_seconds")
            if last_hbm and last_hbm[0][1] > 0:
                landing["time_to_hbm_s"] = round(last_hbm[0][1], 3)
            if "first_layer_s" in landing and "time_to_hbm_s" in landing:
                landing["first_layer_ratio"] = round(
                    landing["first_layer_s"] / landing["time_to_hbm_s"],
                    4)
            for _labels, value in self._metric_samples(
                    "zest_last_pull_ring_stalls"):
                if value:
                    landing["ring_stalls"] = int(value)
            # -1 says "not a delta": 0.0 is a fully reused delta.
            last_delta = self._metric_samples("zest_last_pull_delta_ratio")
            if last_delta and last_delta[0][1] >= 0:
                landing["delta_ratio"] = round(last_delta[0][1], 4)
            last_swap = self._metric_samples("zest_last_pull_swap_seconds")
            if last_swap and last_swap[0][1] > 0:
                landing["swap_s"] = round(last_swap[0][1], 3)
        if landing:
            payload["landing"] = landing

        health = getattr(self.swarm, "health", None) \
            if self.swarm is not None else None
        if health is not None and hasattr(health, "detail"):
            payload["quarantined_peers"] = [
                r for r in health.detail() if r["quarantined_for_s"] > 0]
        return payload

    @staticmethod
    def _metric_samples(name: str) -> list:
        for m in telemetry.REGISTRY.metrics():
            if m.name == name:
                return m.samples()
        return []

    def _scrape_pod(self, path: str, local,
                    parse=lambda text: text) -> tuple[str, dict, dict]:
        """``path`` from every pod peer at once on ``fleet.scrape_pool``,
        each answer through ``parse``, beside ``local`` (this host's):
        ``(this host's label, {label: answer}, {label: error})``. A peer
        that fails the scrape or the parse is reported, not raised."""
        local_label = str(
            self.cfg.coop_index if self.cfg.coop_index is not None
            else self.cfg.mesh.process_id)
        answers = {local_label: local}
        errors: dict = {}
        peers = {str(k): v for k, v in self.pod_peers.items()
                 if str(k) != local_label}
        if peers:
            def scrape(item):
                label, (host, port) = item
                url = f"http://{host}:{port}{path}"
                try:
                    with urllib.request.urlopen(url, timeout=2.0) as r:
                        return label, parse(r.read().decode()), None
                except Exception as exc:  # noqa: BLE001 - per-host report
                    return label, None, str(exc)

            pool = fleet.scrape_pool(self.cfg.pod_scrape_workers)
            for label, answer, err in pool.map(scrape, peers.items()):
                if err is None:
                    answers[label] = answer
                else:
                    errors[label] = err
        return local_label, answers, errors

    def pod_timeline_payload(self) -> dict:
        """``GET /v1/timeline?scope=pod``: this host's timeline and every
        pod peer's, merged onto this host's clock by the offsets the last
        coop round recorded. A peer that fails the scrape is listed under
        ``scrape_errors`` instead of failing the surface."""
        local, docs, errors = self._scrape_pod(
            "/v1/timeline", telemetry.timeline.payload(), json.loads)
        merged = telemetry.timeline.merge_timelines(docs, reference=local)
        if errors:
            merged["scrape_errors"] = errors
        return merged

    def pod_metrics_text(self) -> str:
        """``GET /v1/metrics?scope=pod``: this host's exposition and every
        pod peer's, scraped at once on ``fleet.scrape_pool`` and summed by
        ``fleet.aggregate_prometheus``. A peer that fails the scrape shows
        as ``zest_pod_scrape_errors{host=...}`` instead of failing the
        surface."""
        _local, texts, errors = self._scrape_pod(
            "/v1/metrics", telemetry.render_prometheus())
        return fleet.aggregate_prometheus(texts, errors)

    def pulls_payload(self) -> dict:
        """``GET /v1/pulls``: active and recent sessions, newest first,
        and the admission queue's state."""
        doc = telemetry.session.payload()
        tn = tenancy.summary(self.cfg)
        if tn is not None:
            doc["tenancy"] = {"active": tn["active"],
                              "queued": tn["queued"],
                              "max_pulls": tn["max_pulls"],
                              "queue_cap": tn["queue_cap"],
                              "rejected_total": tn["rejected_total"]}
        return doc

    def cancel_pull(self, sid: str) -> tuple[dict, int]:
        """``DELETE /v1/pulls/<id>``: fire the session's cancel token. 404
        for an unknown id; 409 when the session is terminal or has no
        token."""
        sess = telemetry.session.get(sid)
        if sess is None:
            return {"error": "unknown session"}, 404
        if sess.cancel(reason=f"DELETE /v1/pulls/{sid}"):
            return {"id": sid, "status": "cancelling"}, 202
        snap = sess.snapshot()
        if snap["status"] != "running":
            return {"id": sid, "error": "already terminal",
                    "status": snap["status"]}, 409
        return {"id": sid, "error": "not cancellable"}, 409

    def pull_detail(self, sid: str) -> dict | None:
        sess = telemetry.session.get(sid)
        return sess.snapshot(detail=True) if sess is not None else None

    def session_events(self, sid: str):
        """SSE events of one session (``GET /v1/pulls/<id>/events``):
        ``start`` → [``progress``…] → ``done``/``error``; a progress
        event on each phase or version change, with a 1 s heartbeat. A
        finished session yields ``start`` and its terminal event."""
        sess = telemetry.session.get(sid)
        if sess is None:
            yield {"event": "error", "message": "unknown session"}
            return
        yield {"event": "start", **sess.snapshot(detail=True)}
        while True:
            snap = sess.snapshot()
            if snap["status"] != "running":
                break
            yield {"event": "progress", **snap}
            sess.wait(snap["version"], timeout=1.0)
        final = sess.snapshot(detail=True)
        yield {"event": "done" if final["status"] == "ok" else "error",
               **final}

    def pull_events(self, repo_id: str, revision: str, device: str | None,
                    tenant: str | None = None):
        """SSE events of one pull: ``start`` → [``log``…] → ``done``
        (``snapshot_dir``, ``stats``) | ``cancelled`` | ``error`` (a
        rejection in the race after the pre-stream probe carries ``code:
        429`` and ``retry_after_s``). The generator owns the pull's
        cancel token: a client that goes away mid-stream cancels the
        pull."""
        from zest_tpu_torch.transfer.pull import pull_model

        done = threading.Event()
        events: list[dict] = []
        cond = threading.Condition()
        token = tenancy.CancelToken()
        result: dict = {}

        def log(*args, **_kw):
            with cond:
                events.append({"event": "log",
                               "message": " ".join(str(a) for a in args)})
                cond.notify()

        def work():
            try:
                # Without a device the pull writes files only: nothing
                # lands, and no landing's pod pre-pass runs.
                res = pull_model(self.cfg, repo_id, revision=revision,
                                 device=PULL_DEVICES.get(device, "cpu"),
                                 land=device is not None, swarm=self.swarm,
                                 tenant=tenant, cancel=token, log=log)
                result["ok"] = {"snapshot_dir": str(res.snapshot_dir),
                                "stats": res.stats}
                del res  # the landed tree goes with the request,
                if device is not None:  # and with it the tree's pin
                    tenancy.release_tree(self.cfg, repo_id)
            except tenancy.PullCancelled as exc:
                result["cancelled"] = str(exc)
            except tenancy.AdmissionRejected as exc:
                result["rejected"] = {"message": str(exc),
                                      "retry_after_s": exc.retry_after_s}
            except Exception as exc:  # noqa: BLE001 - reported to client
                result["error"] = f"{type(exc).__name__}: {exc}"
            finally:
                done.set()
                with cond:
                    cond.notify()

        threading.Thread(target=work, daemon=True,
                         name="zest-http-pull").start()
        try:
            yield {"event": "start", "repo_id": repo_id,
                   "revision": revision}
            sent = 0
            while True:
                with cond:
                    cond.wait(timeout=1.0)
                    new = events[sent:]
                    sent = len(events)
                yield from new
                if done.is_set():
                    with cond:
                        yield from events[sent:]
                    break
            if "ok" in result:
                yield {"event": "done", **result["ok"]}
            elif "cancelled" in result:
                yield {"event": "cancelled",
                       "message": result["cancelled"]}
            elif "rejected" in result:
                yield {"event": "error", "code": 429,
                       **result["rejected"]}
            else:
                yield {"event": "error",
                       "message": result.get("error", "?")}
        finally:
            # Reached on completion and on GeneratorExit (the SSE writer
            # saw the client go); after the pull ended it is a no-op.
            if not done.is_set():
                token.cancel("client disconnected from /v1/pull stream")

    # ── Serving ──

    def _generator_for(self, snapshot_dir):
        """Memoized ``(model_type, generate)`` per snapshot: one loader a
        key (latecomers wait for it rather than build a second tree), an
        LRU of four."""
        from zest_tpu_torch.models.generate import load_generator

        key = str(snapshot_dir)
        while True:
            with self._gen_lock:
                cached = self._generators.get(key)
                if cached is not None:
                    self._generators.pop(key)          # LRU: to the end
                    self._generators[key] = cached
                    return cached
                pending = self._gen_loading.get(key)
                if pending is None:
                    pending = self._gen_loading[key] = threading.Event()
                    loading = True
                else:
                    loading = False
            if not loading:
                pending.wait()
                continue  # the loader finished or failed: look again
            try:
                cached = load_generator(snapshot_dir, device=self.device)
                with self._gen_lock:
                    self._generators[key] = cached
                    while len(self._generators) > 4:
                        self._generators.pop(next(iter(self._generators)))
                return cached
            finally:
                with self._gen_lock:
                    self._gen_loading.pop(key, None)
                pending.set()

    def generate_events(self, repo_id: str, req: dict):
        """SSE events of one pull + decode: ``start`` → ``pulled`` →
        [``token``…] → ``done`` with the output ids (and text with a
        tokenizer), or ``error``. ``"stream": true`` sends each generated
        token as its own event."""
        from zest_tpu_torch.models.generate import try_tokenizer

        yield {"event": "start", "repo_id": repo_id}
        memo_key = (repo_id, req.get("revision", "main"))
        self._pin_snapshot(memo_key)
        try:
            snapshot_dir = self._pull_memo(repo_id,
                                           req.get("revision", "main"))
            yield {"event": "pulled", "snapshot_dir": str(snapshot_dir)}
            tok = try_tokenizer(snapshot_dir)
            if "ids" in req:
                prompt = [int(t) for t in req["ids"]]
            elif "prompt" in req and tok is not None:
                prompt = tok.encode(req["prompt"])
            else:
                yield {"event": "error",
                       "message": "need ids, or prompt + a tokenizer "
                                  "in the snapshot"}
                return
            model_type, generate, pool_info = self._decode_path(
                snapshot_dir, repo_id)
            top_k = req.get("top_k")
            top_p = req.get("top_p")
            kwargs = dict(
                temperature=float(req.get("temperature", 0.0)),
                top_k=None if top_k is None else int(top_k),
                top_p=None if top_p is None else float(top_p),
                seed=int(req.get("seed", 0)),
                stop_at_eos=bool(req.get("stop_at_eos", True)),
            )
            steps = int(req.get("steps", 20))
            if req.get("stream"):
                yield from self._streamed_decode(
                    generate, model_type, prompt, steps, tok, kwargs,
                    pool_info=pool_info)
                return
            out = generate(prompt, steps, **kwargs)
            ev = self._done_event(model_type, out, tok)
            if pool_info:
                ev["pool"] = dict(pool_info)
            yield ev
        except Exception as exc:  # noqa: BLE001 - reported to the client
            yield {"event": "error", "message": str(exc)}
        finally:
            self._unpin_snapshot(memo_key)

    def _decode_path(self, snapshot_dir, repo_id: str):
        """Route one generate to the pool or the single-model path.
        Returns ``(model_type, generate, pool_info)``: on the pool path
        ``generate`` wraps ``HbmPool.generate_for`` and fills
        ``pool_info`` (the ``done`` event's ``pool``); otherwise
        ``pool_info`` is None."""
        from zest_tpu_torch.models import hbm_pool

        pool = hbm_pool.pool(self.cfg, self.device)
        if pool is not None:
            model_type, eos_ids = hbm_pool.snapshot_meta(snapshot_dir)
            if pool.supports(model_type):
                pool_info: dict = {}

                def generate(prompt, steps, on_token=None, **kw):
                    out, info = pool.generate_for(
                        snapshot_dir, repo_id, prompt, steps,
                        on_token=on_token, **kw)
                    pool_info.update(info)
                    return out

                generate.eos_ids = eos_ids  # _streamed_decode reads it
                return model_type, generate, pool_info
        model_type, generate = self._generator_for(snapshot_dir)
        return model_type, generate, None

    def _pin_snapshot(self, key) -> None:
        with self._gen_lock:
            self._snapshot_pins[key] = self._snapshot_pins.get(key, 0) + 1

    def _unpin_snapshot(self, key) -> None:
        with self._gen_lock:
            n = self._snapshot_pins.get(key, 0) - 1
            if n <= 0:
                self._snapshot_pins.pop(key, None)
            else:
                self._snapshot_pins[key] = n

    def _pull_memo(self, repo_id: str, revision: str):
        """Snapshot dir of (repo, revision), memoized for ``_PULL_TTL_S``.

        Even a fully cached pull asks the hub for the revision and file
        list; serving remembers the answer briefly (a vanished snapshot
        dir is a miss regardless). A key pinned by a live generate never
        expires, and concurrent misses of one key share one
        ``pull_model`` call (the others wait on its event, then read the
        memo or lead a retry). The pull writes the snapshot's files and
        lands nothing: the pool and the generators land from them."""
        from zest_tpu_torch.transfer.pull import pull_model

        key = (repo_id, revision)
        while True:
            with self._gen_lock:
                hit = self._pulled.get(key)
                now = time.monotonic()
                if hit is not None and hit[0].is_dir() and (
                        hit[1] > now or self._snapshot_pins.get(key)):
                    return hit[0]
                pending = self._pull_inflight.get(key)
                if pending is None:
                    pending = self._pull_inflight[key] = threading.Event()
                    leading = True
                else:
                    leading = False
            if not leading:
                pending.wait()
                continue
            try:
                res = pull_model(self.cfg, repo_id, revision=revision,
                                 device=self.device, swarm=self.swarm,
                                 land=False, log=lambda *a, **k: None)
                with self._gen_lock:
                    now = time.monotonic()
                    # Expired, unpinned entries go on insert.
                    self._pulled = {
                        k: v for k, v in self._pulled.items()
                        if v[1] > now or self._snapshot_pins.get(k)}
                    self._pulled[key] = (res.snapshot_dir,
                                         now + self._PULL_TTL_S)
                return res.snapshot_dir
            finally:
                with self._gen_lock:
                    self._pull_inflight.pop(key, None)
                pending.set()

    @staticmethod
    def _done_event(model_type: str, out, tok) -> dict:
        payload = {"event": "done", "model_type": model_type,
                   "ids": [int(t) for t in out]}
        if tok is not None:
            payload["text"] = tok.decode(list(out))
        return payload

    def _streamed_decode(self, generate, model_type: str, prompt, steps,
                         tok, kwargs: dict, pool_info: dict | None = None):
        """Run the decode in a worker and relay its tokens as SSE events:
        prompt positions are filtered, and token events stop at the
        first generated stop id. A disconnected client sets the cancel
        flag; later tokens are dropped and the bounded decode runs out."""
        q: queue.Queue = queue.Queue()
        n0 = len(prompt)
        cancelled = threading.Event()

        def on_token(pos, toks):
            if cancelled.is_set():
                return
            q.put(("tok", int(pos), int(np.asarray(toks).ravel()[0])))

        def worker():
            try:
                out = generate(prompt, steps, on_token=on_token, **kwargs)
                q.put(("done", out))
            except Exception as exc:  # noqa: BLE001 - relayed as SSE
                q.put(("error", exc))

        threading.Thread(target=worker, daemon=True,
                         name="zest-generate-stream").start()
        eos_ids = getattr(generate, "eos_ids", None)
        if not kwargs.get("stop_at_eos", True):
            eos_ids = None
        ended = False
        gen_ids: list[int] = []
        sent_text = ""
        try:
            while True:
                item = q.get()
                if item[0] == "done":
                    out = item[1]
                    break
                if item[0] == "error":
                    yield {"event": "error", "message": str(item[1])}
                    return
                _, pos, tid = item
                if pos >= n0 and not ended:
                    ev = {"event": "token", "pos": pos, "id": tid}
                    if tok is not None:
                        # A diff of whole decodes: merges and multi-byte
                        # UTF-8 render only in context (a trailing
                        # replacement char waits for its other bytes).
                        gen_ids.append(tid)
                        full = tok.decode(gen_ids)
                        if not full.endswith("�"):
                            ev["text"] = full[len(sent_text):]
                            sent_text = full
                    yield ev
                    ended = bool(eos_ids) and tid in eos_ids
        finally:
            cancelled.set()
        ev = self._done_event(model_type, out, tok)
        if pool_info:
            ev["pool"] = dict(pool_info)
        yield ev


def kernel_launches() -> dict:
    """The hand-written kernels' launch and row counts in this process,
    by kernel: what a daemon's requests launched on the card."""
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda

    return {name: {"launches": c.launches, "rows": c.rows}
            for name, c in (("blake3_chunks", blake3_cuda.COUNTER),
                            ("bg4_regroup", bg4_cuda.COUNTER),
                            ("bg4_fused_verify", bg4_cuda.FUSED_COUNTER))}


class _Handler(BaseHTTPRequestHandler):
    # Keep-alive (HTTP/1.1): every response sets Content-Length, or is
    # chunked (the SSE streams).
    protocol_version = "HTTP/1.1"
    timeout = 120
    api: HttpApi  # bound per server by PublisherServer

    def log_message(self, *args) -> None:  # quiet
        pass

    def _json(self, payload, code: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _text(self, body: bytes, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _base_url(self) -> str:
        """The URL the client dialed (fetch_info and casUrl point back)."""
        host = self.headers.get("Host")
        if host:
            return f"http://{host}"
        addr, port = self.server.server_address[:2]
        return f"http://{addr}:{port}"

    def _bytes_ranged(self, blob, range_header: str | None) -> None:
        """Serve bytes honoring an inclusive ``Range: bytes=a-b`` header:
        206 partial, 416 past EOF."""
        total = len(blob)
        if range_header:
            try:
                a_s, _, b_s = range_header.split("=", 1)[1].partition("-")
                a = int(a_s or 0)
                b = min(int(b_s), total - 1) if b_s else total - 1
            except (IndexError, ValueError):
                a, b = 0, total - 1
            if a >= total or a > b:
                self.send_response(416)
                self.send_header("Content-Range", f"bytes */{total}")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = memoryview(blob)[a:b + 1]
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {a}-{b}/{total}")
        else:
            body = blob
            self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802
        self.api.http_requests += 1
        index = self.api.index
        path, _, qs = self.path.partition("?")
        query = parse_qs(qs)
        if path == "/v1/health":
            self._json({"status": "ok"})
        elif path == "/v1/status":
            self._json(self.api.status_payload())
        elif path == "/v1/models":
            self._json(self.api.models_payload())
        elif path == "/v1/metrics":
            text = (self.api.pod_metrics_text()
                    if query.get("scope", [""])[0] == "pod"
                    else telemetry.render_prometheus())
            self._text(text.encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/v1/timeline":
            if query.get("scope", [""])[0] == "pod":
                self._json(self.api.pod_timeline_payload())
            else:
                try:
                    since = int(query.get("since", ["0"])[0])
                except ValueError:
                    since = 0
                self._json(telemetry.timeline.payload(
                    since=since, prefix=query.get("series", [None])[0]))
        elif path == "/v1/remediations":
            try:
                limit = int(query.get("limit", ["50"])[0])
            except ValueError:
                limit = 50
            self._json(telemetry.remediate.payload(limit=limit))
        elif path == "/":
            self._text(DASHBOARD_HTML.encode(), "text/html; charset=utf-8")
        elif path == "/v1/trace":
            self._json(self.api.trace_payload())
        elif path == "/v1/debug":
            try:
                tail = int(query.get("tail", ["100"])[0])
            except ValueError:
                tail = 100
            self._json(self.api.debug_payload(tail=tail))
        elif path == "/v1/pulls":
            self._json(self.api.pulls_payload())
        elif path.startswith("/v1/pulls/"):
            rest = path[len("/v1/pulls/"):].strip("/")
            if rest.endswith("/events"):
                sid = rest[:-len("/events")].strip("/")
                if telemetry.session.get(sid) is None:
                    self._json({"error": "unknown session"}, 404)
                else:
                    self._stream_sse(self.api.session_events(sid))
            else:
                detail = self.api.pull_detail(rest)
                if detail is None:
                    self._json({"error": "unknown session"}, 404)
                else:
                    self._json(detail)
        elif path.startswith("/api/models/"):
            parts = path[len("/api/models/"):].strip("/").split("/")
            if len(parts) >= 4 and parts[2] == "revision":
                doc = index.revision_doc(f"{parts[0]}/{parts[1]}",
                                         "/".join(parts[3:]))
                if doc is None:
                    self._json({"error": "unknown revision"}, 404)
                else:
                    self._json(doc)
            elif len(parts) >= 4 and parts[2] == "xet-read-token":
                self._json({"casUrl": self._base_url(),
                            "accessToken": PUBLISHER_TOKEN,
                            "exp": int(time.time()) + 3600})
            else:
                self._json({"error": "not found"}, 404)
        elif path.startswith("/v1/reconstructions/"):
            doc = index.reconstruction_doc(
                path[len("/v1/reconstructions/"):].strip("/"),
                self.headers.get("Range"), self._base_url())
            if doc is None:
                self._json({"error": "unknown file"}, 404)
            elif doc == "range":
                self._json({"error": "range past EOF"}, 416)
            else:
                self._json(doc)
        elif path.startswith("/xorbs/"):
            blob = index.xorb_blob(path[len("/xorbs/"):].strip("/"))
            if blob is None:
                self._json({"error": "unknown xorb"}, 404)
            else:
                self._bytes_ranged(blob, self.headers.get("Range"))
        else:
            parts = path.strip("/").split("/")
            data = None
            if len(parts) >= 5 and parts[2] == "resolve":
                data = index.resolve_file(f"{parts[0]}/{parts[1]}",
                                          parts[3], "/".join(parts[4:]))
            if data is None:
                self._json({"error": "not found"}, 404)
            else:
                self._bytes_ranged(data, self.headers.get("Range"))

    def _stream_sse(self, events) -> None:
        """Answer with an event generator as chunked SSE, then close it
        (a disconnected client's generator runs its cleanup now)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in events:
                data = f"data: {json.dumps(ev)}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode()
                                 + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away
        finally:
            events.close()

    def _json_body(self, raw: bytes) -> dict | None:
        """The request body as a JSON object, or None after a 400."""
        try:
            req = json.loads(raw or b"{}")
            if not isinstance(req, dict):
                raise TypeError
        except (ValueError, TypeError):  # JSONDecodeError, bad UTF-8
            self._json({"error": "body must be a JSON object"}, 400)
            return None
        return req

    def do_POST(self) -> None:  # noqa: N802
        self.api.http_requests += 1
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        if self.path == "/v1/stop":
            self._json({"status": "stopping"})
            self.api.trigger_shutdown()
            return
        if self.path == "/v1/pull":
            req = self._json_body(raw)
            if req is None:
                return
            device = req.get("device")
            if not isinstance(req.get("repo_id"), str) or (
                    device is not None and device not in PULL_DEVICES):
                self._json({"error": "body must be JSON with repo_id "
                            "(and device cuda|cpu, or none for files "
                            "only)"}, 400)
                return
            # Typed backpressure before the SSE stream opens: a full
            # admission queue answers a real 429 with Retry-After. The
            # probe is advisory (admission checks again); the race turns
            # a 429 into an in-stream error event with code 429.
            ok, retry_after = tenancy.can_enqueue(self.api.cfg)
            if not ok:
                body = json.dumps({"error": "admission queue full",
                                   "retry_after_s": retry_after}).encode()
                self.send_response(429)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", str(int(retry_after) or 1))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._stream_sse(self.api.pull_events(
                req["repo_id"], req.get("revision", "main"), device,
                tenant=req.get("tenant")))
            return
        if self.path == "/v1/generate":
            req = self._json_body(raw)
            if req is None:
                return
            if not isinstance(req.get("repo_id"), str):
                self._json({"error": "body must be JSON with repo_id"}, 400)
                return
            self._stream_sse(self.api.generate_events(req["repo_id"], req))
            return
        if self.path == "/v1/watch":
            if not self.api.cfg.watch_enabled:
                self._json({"error": "watch disabled"}, 404)
                return
            req = self._json_body(raw)
            if req is None:
                return
            try:
                repos = [str(r) for r in (req.get("repos") or [])]
            except TypeError:
                self._json({"error": "repos must be a list"}, 400)
                return
            self._stream_sse(self.api.watch_hub.subscribe(repos=repos))
            return
        if self.path == "/v1/remediations":
            # zest heal --dry-run on|off: decisions are logged and
            # counted, none executes.
            try:
                dry = bool(json.loads(raw or b"{}")["dry_run"])
            except (json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                self._json({"error": "body must be JSON with dry_run"},
                           400)
                return
            self._json({"dry_run": telemetry.remediate.set_dry_run(dry)})
            return
        if self.path == "/v1/push":
            req = self._json_body(raw)
            if req is None:
                return
            try:
                self._json(push_notify(
                    self.api.watch_hub, req, registry=self.api.registry,
                    swarm=self.api.swarm,
                    gossip_node=self.api.gossip_node))
            except ValueError as exc:
                self._json({"error": str(exc)}, 400)
            return
        parts = self.path[len("/api/models/"):].strip("/").split("/")
        if not (self.path.startswith("/api/models/") and len(parts) >= 4
                and parts[2] == "paths-info"):
            self._json({"error": "not found"}, 404)
            return
        req = self._json_body(raw)
        if req is None:
            return
        try:
            paths = [str(p) for p in (req.get("paths") or [])]
        except TypeError:
            self._json({"error": "paths must be a list"}, 400)
            return
        info = self.api.index.paths_info(f"{parts[0]}/{parts[1]}",
                                         "/".join(parts[3:]), paths)
        if info is None:
            self._json({"error": "unknown revision"}, 404)
        else:
            self._json(info)


    def do_DELETE(self) -> None:  # noqa: N802
        self.api.http_requests += 1
        if self.path.startswith("/v1/pulls/"):
            sid = self.path[len("/v1/pulls/"):].strip("/")
            payload, code = self.api.cancel_pull(sid)
            self._json(payload, code)
        else:
            self._json({"error": "not found"}, 404)


class PublisherServer:
    """Threaded loopback daemon over ``cfg``'s caches. ``port=0`` binds an
    ephemeral port; use as a context manager or call :meth:`start` /
    :meth:`close`. ``api`` is its :class:`HttpApi` (``device``, ``swarm``,
    ``bt_server``, ``registry``, ``gossip_node``, ``pod_peers`` and
    ``dcn_server`` go to it), ``hub`` its watch fan-out."""

    def __init__(self, cfg: Config, host: str = "127.0.0.1", port: int = 0,
                 device=DEFAULT_DEVICE, swarm=None, bt_server=None,
                 registry=None, gossip_node=None,
                 pod_peers: dict | None = None, dcn_server=None):
        self.api = HttpApi(cfg, device=device, swarm=swarm,
                           bt_server=bt_server, registry=registry,
                           gossip_node=gossip_node, pod_peers=pod_peers,
                           dcn_server=dcn_server)
        handler = type("DaemonHandler", (_Handler,), {"api": self.api})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.api.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="zest-publisher", daemon=True)

    @property
    def hub(self) -> WatchHub:
        return self.api.watch_hub

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PublisherServer":
        self._thread.start()
        # A daemon samples for its whole life, so /v1/timeline and zest
        # top have history when the first pull starts.
        telemetry.timeline.ensure_started()
        return self

    def close(self) -> None:
        self.api.close()  # ends the watchers' streams
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join(timeout=10)
        self._httpd.server_close()

    def __enter__(self) -> "PublisherServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# The dashboard behind GET /: the status, pulls, timeline sparklines (polled
# by cursor), coop, recorder, cached models and serving-pool panels.
DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>zest-tpu-torch</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;background:#101418;color:#e6e6e6}
 h1{font-size:1.3rem} .k{color:#8ab4f8} table{border-collapse:collapse}
 td,th{padding:.3rem .8rem;border-bottom:1px solid #333;text-align:left}
 .card{background:#1a2027;border-radius:8px;padding:1rem 1.4rem;margin:1rem 0;
       max-width:42rem}
 code{color:#7ee787}
</style></head><body>
<h1>zest-tpu-torch <span id="ver" class="k"></span></h1>
<div class="card"><table id="status"></table></div>
<div class="card"><h2 style="font-size:1.05rem">Pulls</h2>
<table id="pulls"><thead><tr><th>id</th><th>repo</th><th>tenant</th>
<th>phase</th><th>progress</th><th>elapsed</th></tr></thead>
<tbody></tbody></table></div>
<div class="card"><h2 style="font-size:1.05rem">Timelines</h2>
<table id="spark"><tbody></tbody></table>
<div id="anomalies" style="font-size:.85rem;color:#f28b82"></div></div>
<div class="card"><h2 style="font-size:1.05rem">Cooperative pull</h2>
<table id="coop"></table>
<h3 style="font-size:.95rem;margin-bottom:.2rem">Flight recorder</h3>
<table id="recorder"><tbody></tbody></table></div>
<div class="card"><h2 style="font-size:1.05rem">Cached models</h2>
<table id="models"><thead><tr><th>repo</th><th>revision</th><th>files</th>
</tr></thead><tbody></tbody></table></div>
<div class="card" id="poolcard" style="display:none">
<h2 style="font-size:1.05rem">HBM pool</h2>
<div id="poolsum" style="font-size:.85rem;margin-bottom:.4rem"></div>
<table id="pool"><thead><tr><th>repo</th><th>state</th><th>bytes</th>
<th>pins</th><th>lands</th><th>gate stall</th><th>experts</th></tr></thead>
<tbody></tbody></table></div>
<script>
let tlCursor=0,tlSeries={};
async function tick(){
 try{
  const s=await (await fetch('/v1/status')).json();
  // Every value from the daemon goes into the markup through esc():
  // repo ids, peer addresses and recorder fields come from outside.
  const esc=v=>String(v??'').replace(/[&<>"']/g,c=>'&#'+c.charCodeAt(0)+';');
  document.getElementById('ver').textContent='v'+s.version;
  const rows=Object.entries(s).filter(([k])=>k!=='version')
   .map(([k,v])=>`<tr><td class="k">${esc(k)}</td><td><code>${
     esc(typeof v==='object'?JSON.stringify(v):v)}</code></td></tr>`).join('');
  document.getElementById('status').innerHTML=rows;
  const P=await (await fetch('/v1/pulls')).json();
  const prow=s=>{
   const pct=s.progress!=null?(s.progress*100).toFixed(0)+'%':'';
   const eta=s.eta_s!=null?' (eta '+Number(s.eta_s)+'s)':'';
   const st=s.status==='running'?s.phase:s.status;
   return `<tr><td><code>${esc(s.id)}</code></td><td>${esc(s.repo)}</td>
    <td>${esc(s.tenant||'')}</td><td class="k">${esc(st)}</td>
    <td>${pct}${eta}</td><td>${Number(s.elapsed_s)}s</td></tr>`;
  };
  document.querySelector('#pulls tbody').innerHTML=
   [...(P.active||[]),...(P.recent||[]).slice(0,4)].map(prow).join('')
   ||'<tr><td colspan="6">no pulls yet</td></tr>';
  const m=await (await fetch('/v1/models')).json();
  document.querySelector('#models tbody').innerHTML=m.models.map(x=>
   `<tr><td>${esc(x.repo_id)}${x.pool_state?' <span class="k">['
    +esc(x.pool_state)+']</span>':''}</td>
    <td><code>${esc((x.revision||'').slice(0,12))}</code>
    </td><td>${esc(x.files)}</td></tr>`).join('');
  const HP=s.hbm_pool;
  document.getElementById('poolcard').style.display=HP?'':'none';
  if(HP){
   const MB=v=>(v/1048576).toFixed(1)+' MiB';
   document.getElementById('poolsum').textContent=
    'used '+MB(HP.used_bytes)+' ('+MB(HP.pinned_bytes)+' pinned) / '
    +(HP.budget_bytes?MB(HP.budget_bytes):'unbounded')
    +' · hits '+HP.hits+' · misses '+HP.misses
    +' · evictions '+HP.evictions+(HP.rush?' · RUSH':'');
   document.querySelector('#pool tbody').innerHTML=
    (HP.models||[]).map(r=>
     `<tr><td>${esc(r.repo)}</td><td class="k">${esc(r.state)}</td>
      <td>${esc(MB(r.bytes))}</td><td>${esc(r.pins)}</td>
      <td>${esc(r.lands)}</td><td>${esc(r.gate_stall_s)}s</td><td>${esc(
       r.experts?(r.experts.residency*100).toFixed(0)+'% resident':'')}</td>
      </tr>`
    ).join('')||'<tr><td colspan="7">empty</td></tr>';
  }
  const d=await (await fetch('/v1/debug?tail=8')).json();
  const c=d.coop||{}, crows=[];
  const L=d.landing||{};
  if(L.first_layer_s!=null)
   crows.push(['first_layer_s',L.first_layer_s+(L.first_layer_ratio!=null?
    ' ('+(L.first_layer_ratio*100).toFixed(0)+'% of hbm)':'')]);
  if(L.time_to_hbm_s!=null) crows.push(['time_to_hbm_s',L.time_to_hbm_s]);
  if(L.ring_stalls!=null) crows.push(['ring_stalls',L.ring_stalls]);
  if(L.delta_ratio!=null)
   crows.push(['delta_fetched',(L.delta_ratio*100).toFixed(1)+'% of bytes']);
  if(L.swap_s!=null) crows.push(['time_to_swap_s',L.swap_s]);
  if(c.peer_served_ratio!=null)
   crows.push(['peer_served_ratio',(c.peer_served_ratio*100).toFixed(1)+'%']);
  for(const [t,b] of Object.entries(c.tier_bytes||{}))
   crows.push(['bytes['+t+']',b.toLocaleString()]);
  if(c.exchange_wall_s!=null)
   crows.push(['exchange_wall_s',c.exchange_wall_s]);
  const CX=c.collective||{};
  if(CX.phases!=null)
   crows.push(['collective',CX.phases+' phase(s)'
    +(CX.wall_s!=null?' in '+CX.wall_s+'s':'')
    +(CX.aborts?'; '+CX.aborts+' abort(s)':'')]);
  for(const [lk,b] of Object.entries(CX.link_bytes||{}))
   crows.push(['collective_bytes['+lk+']',b.toLocaleString()]);
  if(c.fallbacks!=null) crows.push(['fallbacks',c.fallbacks]);
  const SD=s.seeding||{};
  if(SD.chunks_served!=null)
   crows.push(['seeding',SD.bytes_served.toLocaleString()+' B in '
    +SD.chunks_served+' chunks; unchoked '+SD.unchoked+'/'
    +(SD.unchoked+SD.choked)+(SD.refused_quarantined?
    '; refused '+SD.refused_quarantined:'')+(SD.rate_bps?
    '; shaped '+SD.rate_bps+' B/s':'')]);
  const q=(d.quarantined_peers||[]).map(p=>p.peer).join(', ');
  if(crows.length||q) crows.push(['quarantined',q||'none']);
  document.getElementById('coop').innerHTML=crows.map(([k,v])=>
   `<tr><td class="k">${esc(k)}</td><td><code>${esc(v)}</code></td></tr>`
   ).join('')
   ||'<tr><td>no cooperative round yet</td></tr>';
  const page=await (await fetch('/v1/timeline?since='+tlCursor)).json();
  if(page.enabled!==false){
   if(page.cursor<tlCursor) tlSeries={};  // daemon/store restarted
   tlCursor=page.cursor||0;
   for(const [n,s] of Object.entries(page.series||{})){
    const row=tlSeries[n]||(tlSeries[n]={kind:s.kind,samples:[]});
    row.samples.push(...s.samples);
    if(row.samples.length>150) row.samples.splice(0,row.samples.length-150);
   }
   const names=Object.keys(tlSeries);
   if(names.length>30){
    names.sort((a,b)=>(tlSeries[a].samples.at(-1)?.[0]||0)
                     -(tlSeries[b].samples.at(-1)?.[0]||0));
    for(const n of names.slice(0,names.length-30)) delete tlSeries[n];
   }
  }
  const T={enabled:page.enabled,series:tlSeries,
           anomalies:page.anomalies||[]};
  const spark=(pts)=>{
   if(pts.length<2) return '<code>·</code>';
   const vs=pts.map(p=>p[1]),ts=pts.map(p=>p[0]);
   const [v0,v1]=[Math.min(...vs),Math.max(...vs)];
   const [t0,t1]=[Math.min(...ts),Math.max(...ts)];
   const W=140,H=22,sx=t1>t0?W/(t1-t0):0,sy=v1>v0?(H-2)/(v1-v0):0;
   const pl=pts.map(p=>((p[0]-t0)*sx).toFixed(1)+','
     +(H-1-(p[1]-v0)*sy).toFixed(1)).join(' ');
   return `<svg width="${W}" height="${H}"><polyline points="${pl}"
     fill="none" stroke="#8ab4f8" stroke-width="1.2"/></svg>`;
  };
  const fmt=v=>v>=1e9?(v/1e9).toFixed(2)+'G':v>=1e6?(v/1e6).toFixed(1)+'M'
    :v>=1e3?(v/1e3).toFixed(1)+'k':String(Math.round(v*100)/100);
  const srows=Object.entries(T.series||{}).slice(0,14).map(([n,s])=>{
   const pts=s.samples||[],last=pts.length?pts[pts.length-1][1]:0;
   return `<tr><td class="k">${esc(n)}</td><td>${spark(pts)}</td>
     <td><code>${esc(fmt(last))}${s.kind==='rate'?'/s':''}</code></td></tr>`;
  }).join('');
  document.querySelector('#spark tbody').innerHTML=srows
   ||`<tr><td>${T.enabled===false?'timelines off (ZEST_TIMELINE=0)'
       :'no samples yet'}</td></tr>`;
  document.getElementById('anomalies').textContent=
   (T.anomalies||[]).slice(-4).map(a=>a.kind
     +(a.session?' ['+a.session+']':'')).join('  ');
  const evs=(d.recorder||{}).events||[];
  document.querySelector('#recorder tbody').innerHTML=evs.map(e=>{
   const t=new Date(e.t*1000).toISOString().slice(11,23);
   const extra=Object.entries(e).filter(([k])=>!['t','kind'].includes(k))
    .map(([k,v])=>k+'='+v).join(' ');
   return `<tr><td><code>${esc(t)}</code></td><td class="k">${esc(e.kind)}</td>
    <td><code>${esc(extra)}</code></td></tr>`;
  }).join('')||'<tr><td>no events</td></tr>';
 }catch(e){}
}
tick();setInterval(tick,2000);
</script></body></html>
"""

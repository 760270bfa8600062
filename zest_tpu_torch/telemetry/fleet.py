"""Fleet observability: cross-host trace correlation and pod metrics.

The counterpart of ``zest_tpu/telemetry/fleet.py``, with the same
outputs on the same inputs. Each host's telemetry is its own: a 4-host
cooperative pull emits four traces and four ``/v1/metrics`` texts. This
module joins them:

- **Trace identity** (:func:`mint_trace_id`): a 16-byte id every host of
  one pull derives alike (``repo@sha`` and a nonce shared through the
  process group's store, or the ownership-plan fingerprint when
  addresses are explicit), stamped on every span through the trace
  context and carried to peers in the DCN hello (``transfer.dcn``).
- **Trace merging** (:func:`merge_traces`): N per-host Chrome trace docs
  → one Perfetto file with a process track per host, timelines moved
  onto the reference host's clock (epoch anchors corrected by the DCN
  hello's offset estimates, "Clock normalization" below), and flow
  events binding each ``dcn.request_many`` window span to the
  ``dcn.serve`` spans that answered it.
- **Pod metrics** (:func:`aggregate_prometheus`): N hosts' Prometheus
  texts → one exposition where counters and histograms are summed,
  gauges are labelled ``{host="i"}``, plus derived pod gauges
  (``zest_coop_straggler_seconds``, fetch-share skew, the pod's
  peer-served ratio). The daemon serves it at
  ``GET /v1/metrics?scope=pod``.

Clock normalization: hosts' wall clocks are close but not equal, and a
merged trace that orders two hosts' DCN spans by raw wall time can show
an effect before its cause. Every DCN hello measures a clock-offset
estimate: the peer's hello block carries its wall time at send, read
within one round trip of sending ours, so ``offset ≈ peer_epoch −
(local_epoch − rtt/2)`` within ±rtt/2. Each host records its per-peer
estimates in its trace metadata; the merge moves every host onto the
reference host's clock with the reference's estimate of that host (or
the host's own estimate of the reference, negated), and falls back to
the raw epoch anchors when neither exists.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import statistics
import threading
import urllib.request

__all__ = [
    "mint_trace_id",
    "merge_traces",
    "split_hosts",
    "gather_traces",
    "parse_prometheus",
    "aggregate_prometheus",
]


def mint_trace_id(pull_key: str, nonce: str = "") -> str:
    """16-byte trace id (32 hex) of one cooperative pull.

    Derived, not drawn: every host mints the same id with no extra round.
    ``pull_key`` is ``repo@sha`` (or the unit-key set of a bare
    ``coop_round``); ``nonce``, shared through the process group's store
    when there is one (``transfer.coop.share_nonce_via_kv``), tells
    repeated pulls of one revision apart."""
    return hashlib.blake2b(f"zest-trace|{pull_key}|{nonce}".encode(),
                           digest_size=16).hexdigest()


# ── Trace merging ──


def split_hosts(doc: dict, default_host=0) -> dict:
    """Split one trace doc into per-host docs by each span's ``host``
    attr (events without one belong to ``default_host``) — the
    in-process multi-host runs (tests, ``chip_smoke.py``'s coop phase)
    record every simulated host into one process tracer; this recovers
    the per-host docs :func:`merge_traces` consumes."""
    out: dict = {}
    meta = doc.get("otherData", {})
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        host = ev.get("args", {}).get("host", default_host)
        out.setdefault(host, []).append(ev)
    return {
        host: {"traceEvents": events, "otherData": dict(meta)}
        for host, events in out.items()
    }


def _host_offset_s(host, ref, docs: dict) -> float | None:
    """Estimated (host clock − reference clock), from the hello-RTT
    measurements either side recorded (see module docstring)."""
    if host == ref:
        return 0.0
    ref_meta = docs[ref].get("otherData", {}).get("clock_offsets", {})
    est = ref_meta.get(str(host), ref_meta.get(host))
    if isinstance(est, dict) and "offset_s" in est:
        return float(est["offset_s"])
    own_meta = docs[host].get("otherData", {}).get("clock_offsets", {})
    est = own_meta.get(str(ref), own_meta.get(ref))
    if isinstance(est, dict) and "offset_s" in est:
        return -float(est["offset_s"])
    return None


def merge_traces(host_docs: dict, reference=None) -> dict:
    """Merge per-host Chrome trace docs into one multi-track doc.

    ``host_docs`` maps a host key (index or label) → a trace doc
    (:meth:`Tracer.to_chrome` output or a loaded export). Each host
    becomes its own process track (synthetic pid, ``process_name``
    metadata), timelines are normalized per the module docstring, and
    ``dcn.request_many`` ↔ ``dcn.serve`` spans are bound with flow
    events. ``reference`` picks the clock hosts are normalized onto
    (default: the smallest host key — the coordinator)."""
    if not host_docs:
        raise ValueError("no traces to merge")
    keys = sorted(host_docs, key=str)
    if reference is None:
        reference = keys[0]

    # Per-host epoch anchor corrected by the measured clock offset.
    anchors: dict = {}
    clock_meta: dict = {}
    for host in keys:
        meta = host_docs[host].get("otherData", {})
        epoch = float(meta.get("epoch_origin_s", 0.0))
        offset = _host_offset_s(host, reference, host_docs)
        anchors[host] = epoch - (offset or 0.0)
        clock_meta[str(host)] = {
            "epoch_origin_s": round(epoch, 6),
            "applied_offset_s": (None if offset is None
                                 else round(offset, 6)),
        }
    base = min(anchors.values())

    events: list[dict] = []
    trace_ids: set = set()
    # (client_host, flow_tag) → client event | server events, for flows.
    clients: dict = {}
    servers: dict = {}
    for i, host in enumerate(keys):
        pid = 1000 + i
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"host {host}"
                     + (" (reference clock)" if host == reference else "")},
        })
        shift_us = (anchors[host] - base) * 1e6
        for ev in host_docs[host].get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            out = dict(ev)
            out["pid"] = pid
            out["ts"] = round(ev.get("ts", 0.0) + shift_us, 1)
            args = out.get("args", {})
            args.setdefault("host", host)
            out["args"] = args
            tid_ = args.get("trace_id")
            if tid_:
                trace_ids.add(tid_)
            events.append(out)
            if ev.get("name") == "dcn.request_many" \
                    and args.get("flow_tag") is not None:
                clients[(str(host), int(args["flow_tag"]))] = out
            elif ev.get("name") == "dcn.serve" \
                    and args.get("client_host") is not None \
                    and args.get("tag") is not None:
                servers.setdefault(
                    (str(args["client_host"]), int(args["tag"])), []
                ).append(out)

    # Flow events: ``s`` bound inside the client window span, ``f``
    # (binding point "e"=enclosing) inside each serve span. Binding is
    # by (pid, tid, ts-inside-slice) per the trace-event format.
    links = 0
    for key, cl in clients.items():
        srvs = servers.get(key)
        if not srvs:
            continue
        fid = int.from_bytes(hashlib.blake2b(
            repr(key).encode(), digest_size=4).digest(), "big")
        events.append({
            "ph": "s", "id": fid, "name": "dcn", "cat": "dcn",
            "pid": cl["pid"], "tid": cl["tid"],
            "ts": round(cl["ts"] + min(1.0, cl.get("dur", 0) / 2), 1),
        })
        for sv in srvs:
            events.append({
                "ph": "f", "bp": "e", "id": fid, "name": "dcn",
                "cat": "dcn", "pid": sv["pid"], "tid": sv["tid"],
                "ts": round(sv["ts"] + min(1.0, sv.get("dur", 0) / 2), 1),
            })
            links += 1

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "zest-tpu",
            "merged_hosts": [str(k) for k in keys],
            "reference_host": str(reference),
            "epoch_base_s": round(base, 6),
            "flow_links": links,
            "clock_normalization": clock_meta,
        },
    }
    if trace_ids:
        doc["otherData"]["trace_ids"] = sorted(trace_ids)
    return doc


def host_coverage_s(doc: dict, host, root_name: str | None = None):
    """(union coverage seconds, root span seconds) of one host's track
    in a merged doc — the per-host acceptance check (coverage ≥90% of
    the host's root pull/round span). ``root_name`` defaults to the
    host's longest span."""
    evs = [e for e in doc.get("traceEvents", [])
           if e.get("ph") == "X"
           and str(e.get("args", {}).get("host")) == str(host)]
    if not evs:
        return 0.0, 0.0
    if root_name is None:
        root = max(evs, key=lambda e: e.get("dur", 0.0))
    else:
        cands = [e for e in evs if e["name"] == root_name]
        if not cands:
            return 0.0, 0.0
        root = max(cands, key=lambda e: e.get("dur", 0.0))
    ivs = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in evs)
    total, end = 0.0, float("-inf")
    for s, e in ivs:
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6, root.get("dur", 0.0) / 1e6


_SCRAPE_POOL = None
_SCRAPE_POOL_LOCK = threading.Lock()


def scrape_pool(workers: int | None = None):
    """The process-shared bounded executor behind every pod-scope
    scrape fan-out (``/v1/metrics?scope=pod``, ``/v1/timeline?scope=
    pod``, ``gather_traces``). One pool for the whole process — at
    hundreds of peers, concurrent pod-scope requests queue on these
    workers instead of bursting a fresh thread per peer per request
    Sized on first use: an explicit ``workers``
    (Config.pod_scrape_workers) wins, else ZEST_POD_SCRAPE_WORKERS,
    else 8; later calls reuse the existing pool regardless."""
    from concurrent.futures import ThreadPoolExecutor

    global _SCRAPE_POOL
    with _SCRAPE_POOL_LOCK:
        if _SCRAPE_POOL is None:
            if workers is None:
                raw = os.environ.get("ZEST_POD_SCRAPE_WORKERS", "")
                workers = int(raw) if raw.strip() else 8
            _SCRAPE_POOL = ThreadPoolExecutor(
                max_workers=max(1, int(workers)),
                thread_name_prefix="zest-podscrape")
        return _SCRAPE_POOL


def gather_traces(api_addrs: dict, timeout_s: float = 5.0):
    """Snapshot every host's live tracer over ``GET /v1/trace``.

    ``api_addrs`` maps host key → (host, http_port). Returns
    ``(docs, errors)`` — hosts that fail to answer (daemon down, no
    tracer armed) land in ``errors`` instead of failing the gather;
    a merged trace of the hosts that DID answer is still the operator's
    best artifact. Scrapes run concurrently on the shared bounded
    :func:`scrape_pool`: N dead peers must cost one timeout, not N."""

    def scrape(item):
        key, (host, port) = item
        url = f"http://{host}:{port}/v1/trace"
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as r:
                doc = json.loads(r.read().decode())
        except Exception as exc:  # noqa: BLE001 - per-host, reported
            return key, None, str(exc)
        if not doc.get("traceEvents"):
            return key, None, "empty trace (tracer not armed?)"
        return key, doc, None

    docs: dict = {}
    errors: dict = {}
    items = sorted(api_addrs.items(), key=lambda i: str(i))
    if not items:
        return docs, errors
    for key, doc, err in scrape_pool().map(scrape, items):
        if doc is not None:
            docs[key] = doc
        else:
            errors[key] = err
    return docs, errors


# ── Pod metrics aggregation ──

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? '
    r'(-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def parse_prometheus(text: str) -> dict:
    """Parse exposition text → ``{name: {"kind", "help", "samples":
    {labeltuple: value}}}``. Histogram/summary series parse under their
    sample names (``x_bucket``/``x_sum``/``x_count``) with the base
    name's TYPE recorded, which is exactly what additive re-summing
    needs. Unparseable lines raise — aggregating a half-read host would
    silently under-count the pod."""
    out: dict = {}
    kinds: dict = {}
    helps: dict = {}
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            helps[name] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            kinds[name] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"malformed sample line: {line!r}")
        name, labelstr, value = m.groups()
        labels = {}
        if labelstr:
            leftover = _LABEL_RE.sub("", labelstr).strip(", ")
            if leftover:
                raise ValueError(f"malformed labels: {labelstr!r}")
            for lm in _LABEL_RE.finditer(labelstr):
                labels[lm.group(1)] = _unescape(lm.group(2))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in kinds:
                base = name[:-len(suffix)]
                break
        v = {"+Inf": math.inf, "-Inf": -math.inf}.get(value)
        if v is None:
            v = float("nan") if value == "NaN" else float(value)
        entry = out.setdefault(name, {
            "kind": kinds.get(base, "untyped"),
            "help": helps.get(base, ""),
            "samples": {},
        })
        entry["samples"][tuple(sorted(labels.items()))] = v
    return out


_ADDITIVE_KINDS = frozenset({"counter", "histogram"})


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


def _line(name: str, labels: dict, value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape(v)}"'
                         for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def aggregate_prometheus(host_texts: dict, errors: dict | None = None) -> str:
    """N hosts' Prometheus texts → one pod-scope exposition.

    ``host_texts`` maps host label → that host's ``/v1/metrics`` body.
    Counters and histogram series (additive by Prometheus semantics)
    are summed across hosts per labelset; gauges and untyped samples
    keep one sample per host with a ``host`` label (summing a gauge —
    an occupancy, a ratio — would be meaningless). Adds the derived pod
    gauges (see :func:`_derived_pod_samples`) and the scrape health
    gauges (``zest_pod_hosts``, ``zest_pod_scrape_errors{host}``).

    A host whose body does not PARSE (a proxy's HTML error page with a
    200, a truncated stream) is demoted to a scrape error like a host
    that never answered — one flapping peer must not 500 the whole
    pod surface."""
    errors = dict(errors or {})
    parsed = {}
    for label, text in host_texts.items():
        try:
            parsed[label] = parse_prometheus(text)
        except ValueError as exc:
            errors[label] = f"unparseable metrics: {exc}"

    merged: dict = {}  # name → {"kind","help","samples":{labels: value}}
    for label in sorted(parsed, key=str):
        for name, entry in parsed[label].items():
            slot = merged.setdefault(name, {
                "kind": entry["kind"], "help": entry["help"],
                "samples": {},
            })
            if not slot["help"]:
                slot["help"] = entry["help"]
            additive = entry["kind"] in _ADDITIVE_KINDS
            for labelkey, value in entry["samples"].items():
                if additive:
                    slot["samples"][labelkey] = (
                        slot["samples"].get(labelkey, 0.0) + value)
                else:
                    key = tuple(sorted(
                        dict(labelkey, host=str(label)).items()))
                    slot["samples"][key] = value

    for name, help_text, kind, samples in _derived_pod_samples(parsed):
        merged[name] = {"kind": kind, "help": help_text,
                        "samples": samples}

    merged["zest_pod_hosts"] = {
        "kind": "gauge",
        "help": "Hosts aggregated into this pod-scope scrape",
        "samples": {(): float(len(parsed))},
    }
    if errors:
        merged["zest_pod_scrape_errors"] = {
            "kind": "gauge",
            "help": "Pod peers that failed the metrics scrape (1=down)",
            "samples": {
                (("host", str(h)),): 1.0 for h in sorted(errors, key=str)
            },
        }

    out: list[str] = []
    headered: set[str] = set()

    def _header(base: str, help_text: str, kind: str) -> None:
        if base in headered:
            return
        headered.add(base)
        out.append(f"# HELP {base} "
                   + help_text.replace("\\", "\\\\").replace("\n", "\\n"))
        out.append(f"# TYPE {base} {kind}")

    for name in sorted(merged):
        entry = merged[name]
        base = name
        if entry["kind"] == "histogram":
            # TYPE/HELP belong to the base series name, declared once
            # before its first _bucket/_sum/_count sample group.
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix):
                    base = name[:-len(suffix)]
                    break
        _header(base, entry["help"], entry["kind"])
        for labelkey in sorted(entry["samples"]):
            out.append(_line(name, dict(labelkey),
                             entry["samples"][labelkey]))
    return "\n".join(out) + "\n"


def _derived_pod_samples(parsed: dict):
    """The pod-level gauges no single host can compute:

    - ``zest_coop_straggler_seconds``: slowest-minus-median host
      exchange wall (per-host ``zest_coop_exchange_wall_seconds``);
    - ``zest_coop_fetch_share_skew``: max/mean of per-host coop fetch
      bytes (``zest_coop_fetch_bytes``) — the ownership plan promises
      ≤1.15, so drift here means quarantine re-shards or fallbacks;
    - ``zest_pod_peer_served_ratio``: swarm-wide peer-vs-CDN byte
      ratio over every host's summed ``zest_coop_bytes_total`` tiers
      (fallback bytes count as non-peer: conservative).
    """
    walls, fetch_bytes = [], []
    tiers: dict[str, float] = {}
    for host_doc in parsed.values():
        w = host_doc.get("zest_coop_exchange_wall_seconds")
        if w and w["samples"]:
            walls.append(max(w["samples"].values()))
        fb = host_doc.get("zest_coop_fetch_bytes")
        if fb and fb["samples"]:
            fetch_bytes.append(max(fb["samples"].values()))
        cb = host_doc.get("zest_coop_bytes_total")
        if cb:
            for labelkey, v in cb["samples"].items():
                tier = dict(labelkey).get("tier", "")
                tiers[tier] = tiers.get(tier, 0.0) + v

    out = []
    if walls:
        straggler = max(walls) - statistics.median(walls)
        out.append((
            "zest_coop_straggler_seconds",
            "Slowest-minus-median host cooperative exchange wall",
            "gauge", {(): round(straggler, 6)},
        ))
    if fetch_bytes:
        mean = sum(fetch_bytes) / len(fetch_bytes)
        skew = (max(fetch_bytes) / mean) if mean else 1.0
        out.append((
            "zest_coop_fetch_share_skew",
            "Max-over-mean of per-host cooperative fetch bytes",
            "gauge", {(): round(skew, 6)},
        ))
    if tiers:
        peer = tiers.get("peer", 0.0) + tiers.get("dcn", 0.0)
        total = peer + tiers.get("cdn", 0.0) + tiers.get("fallback", 0.0)
        if total:
            out.append((
                "zest_pod_peer_served_ratio",
                "Swarm-wide fraction of cooperative network bytes "
                "served by peers (fallback counted as non-peer)",
                "gauge", {(): round(peer / total, 6)},
            ))
    return out

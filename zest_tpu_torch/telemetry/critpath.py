"""Automated critical-path attribution over completed trace docs.

The counterpart of ``zest_tpu/telemetry/critpath.py``, giving the same
report on the same spans. A Perfetto trace answers "what happened during
this pull" only when a human reads it. This module reads it: given a
trace — a live :class:`~zest_tpu_torch.telemetry.trace.Tracer`, a solo exported
Chrome doc, or a ``fleet.merge_traces`` multi-host doc — it computes
the **blame-attributed critical path** through the span set and
reports where the wall time actually went: per-stage and per-tier
exclusive seconds, the top blocking spans, and the
fetch/decode/verify/commit split. It powers ``stats["critical_path"]``
on traced pulls, the ``zest analyze <trace.json>`` CLI, the SLO
breach events' ``blamed_stage`` and the coverage gates of the traced
pulls.

Attribution model
-----------------
Spans carry no explicit dependency edges, so the path is derived from
the wall timeline the way trace-profilers conventionally do it: walk
the root ``pull`` span's wall from start to end; at every instant,
blame the **most specific active span** — the one with the latest
start time, which for properly nested spans is exactly the deepest
one, and across threads is the most recently dispatched work. Each
span's *blamed* time is therefore its exclusive time minus any window
where deeper/more-recent work ran — summing the blames tiles the root
wall exactly (minus ``idle_s``: wall covered by no span but the root,
i.e. untraced time). The stage split sums to the path length by
construction, which is what the coverage gates assert.

The sweep is O(n log n) in the span count: one sorted boundary pass
with a lazy max-heap of active spans.
"""

from __future__ import annotations

_SKIP_NAMES = frozenset({
    # A stat interval, not work: anchored at the pull's t0 and covering
    # everything up to the first-layer commit — blaming it would hide
    # the real stages beneath it.
    "stage.first_layer",
})

# Ordered (prefix, category) rules; first match wins. "verify" anywhere
# in the name beats the prefix table (pod/coop verification spans are
# nested under fetch-ish parents).
_CATEGORY_PREFIXES = (
    # Tenancy admission wait: time parked in the fair queue
    # is its own stage — "queued" — not fetch work and not untraced
    # idle. A pull that spent 40 s queued and 5 s fetching must blame
    # the queue, or the analyzer would tell the operator to tune the
    # CDN.
    ("tenancy.queued", "queued"),
    ("stage.resolve", "metadata"),
    ("stage.cas_metadata", "metadata"),
    ("cas.reconstruction", "metadata"),
    ("stage.fetch", "fetch"),
    ("fetch.", "fetch"),
    ("cdn.", "fetch"),
    ("swarm.", "fetch"),
    ("peer.", "fetch"),
    ("dcn.", "fetch"),
    # Collective exchange: phase spans are byte movement
    # — they blame as "fetch" with the wire link class as the tier
    # (``link`` attr: dcn cross-slice, ici within a slice), so the
    # per-tier fetch split stays one comparable ledger whether the
    # bytes came over the waterfall or the collective. Barrier spans
    # blame as "barrier" (a lagging partner's idle, which is neither
    # fetch nor exchange work — the straggler signal).
    ("coop.collective.barrier", "barrier"),
    ("coop.collective.", "fetch"),
    ("coop.exchange", "exchange"),
    ("coop.", "fetch"),
    # Transport-split spans: the pluggable exchange backends
    # emit bare ``collective.*`` names (lane packing, loopback serve)
    # that are NOT nested under a ``coop.collective.`` phase prefix —
    # they are exchange work and must blame as such, not vanish into
    # "other". Checkpoint fan-out spans (``push`` and any ``push.*``
    # child) get their own stage for the same reason: a publisher
    # process's wall is push work, and "other" at 90% tells the
    # operator nothing.
    ("collective.", "exchange"),
    ("push", "push"),
    ("federated.", "fetch"),
    ("pod.", "fetch"),
    ("warm.", "fetch"),
    ("cas.", "fetch"),
    ("land.", "decode"),  # land.decode + land.slice (the run lane)
    ("stage.decode", "decode"),
    ("hbm.commit", "commit"),
    ("stage.hbm_commit", "commit"),
    ("delta.swap", "commit"),
    ("stage.files", "files"),
    ("files.", "files"),
)


class AnalyzeError(ValueError):
    """The doc cannot be analyzed (no root span, malformed events)."""


def categorize(name: str) -> str:
    if "verify" in name:
        return "verify"
    for prefix, cat in _CATEGORY_PREFIXES:
        if name.startswith(prefix):
            return cat
    return "other"


def _tier_of(name: str, attrs: dict) -> str | None:
    """Serving tier of a fetch-category span, for the per-tier split."""
    t = attrs.get("tier") or attrs.get("source")
    if t:
        return str(t)
    if name.startswith("coop.collective."):
        # Phase spans carry the link class (ici intra-slice, dcn
        # cross-slice); an attr-less one is wire movement all the same.
        return str(attrs.get("link") or "dcn")
    if name.startswith("cdn."):
        return "cdn"
    if name.startswith(("swarm.", "peer.")):
        return "peer"
    if name.startswith("dcn."):
        return "dcn"
    return None


class _Iv:
    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs


def _pick_root(ivs: list[_Iv], root_name: str, newest: bool) -> _Iv:
    roots = [s for s in ivs if s.name == root_name]
    if not roots:
        raise AnalyzeError(f"no root {root_name!r} span in the trace")
    if newest:
        # The LAST pull that finished — what stats["critical_path"]
        # wants from a long-lived daemon's accumulated tracer.
        return max(roots, key=lambda s: s.t1)
    # The dominant pull — what an exported doc analysis wants.
    return max(roots, key=lambda s: s.t1 - s.t0)


def _analyze(ivs: list[_Iv], root_name: str = "pull", top_k: int = 8,
             newest_root: bool = False, root: _Iv | None = None) -> dict:
    import heapq

    if root is None:
        root = _pick_root(ivs, root_name, newest_root)
    r0, r1 = root.t0, root.t1
    if r1 <= r0:
        raise AnalyzeError("root span has no duration")
    spans = [s for s in ivs
             if s is not root and s.name not in _SKIP_NAMES
             and s.name != root_name
             and s.t1 > r0 and s.t0 < r1]
    for s in spans:  # clip to the root window
        s.t0 = max(s.t0, r0)
        s.t1 = min(s.t1, r1)

    boundaries = sorted({r0, r1, *(s.t0 for s in spans),
                         *(s.t1 for s in spans)})
    spans.sort(key=lambda s: s.t0)
    # Heap entries: (-t0, t1, idx) — the top is the latest-started
    # active span (ties go to the shorter span: for same-start nesting
    # the deepest span is the shortest). Lazy deletion: an entry whose
    # span ended at or before the segment start is dead for every later
    # segment too (time only advances), so it pops permanently.
    heap: list[tuple[float, float, int]] = []
    next_span = 0
    blamed_s: dict[int, float] = {}
    idle_s = 0.0
    path: list[tuple[int | None, float, float]] = []  # merged segments
    for a, b in zip(boundaries, boundaries[1:]):
        while next_span < len(spans) and spans[next_span].t0 <= a:
            heapq.heappush(heap, (-spans[next_span].t0,
                                  spans[next_span].t1, next_span))
            next_span += 1
        while heap and spans[heap[0][2]].t1 <= a:
            heapq.heappop(heap)
        if heap:
            idx = heap[0][2]
            blamed_s[idx] = blamed_s.get(idx, 0.0) + (b - a)
        else:
            idx = None
            idle_s += b - a
        if path and path[-1][0] == idx and abs(path[-1][2] - a) < 1e-12:
            path[-1] = (idx, path[-1][1], b)
        else:
            path.append((idx, a, b))

    stages: dict[str, float] = {}
    tiers: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for idx, sec in blamed_s.items():
        s = spans[idx]
        cat = categorize(s.name)
        stages[cat] = stages.get(cat, 0.0) + sec
        by_name[s.name] = by_name.get(s.name, 0.0) + sec
        if cat == "fetch":
            tier = _tier_of(s.name, s.attrs)
            if tier:
                tiers[tier] = tiers.get(tier, 0.0) + sec
    path_s = sum(blamed_s.values())
    wall = r1 - r0

    top = sorted(blamed_s.items(), key=lambda kv: kv[1], reverse=True)
    top_spans = []
    for idx, sec in top[:max(0, top_k)]:
        s = spans[idx]
        top_spans.append({
            "name": s.name,
            "category": categorize(s.name),
            "start_s": round(s.t0 - r0, 4),
            "dur_s": round(s.t1 - s.t0, 4),
            "blamed_s": round(sec, 4),
        })

    doc = {
        "root": {"name": root.name, "wall_s": round(wall, 4)},
        "path_s": round(path_s, 4),
        "idle_s": round(idle_s, 4),
        "coverage": round(path_s / wall, 4),
        "steps": len(path),
        "stages": {k: round(v, 4) for k, v in
                   sorted(stages.items(), key=lambda kv: -kv[1])},
        "top_spans": top_spans,
    }
    if tiers:
        doc["tiers"] = {k: round(v, 4) for k, v in
                        sorted(tiers.items(), key=lambda kv: -kv[1])}
    by = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    doc["by_name"] = {k: round(v, 4) for k, v in by}
    for key in ("repo", "revision", "host"):
        if key in root.attrs:
            doc["root"][key] = root.attrs[key]
    return doc


def analyze_tracer(tracer, root_name: str = "pull", top_k: int = 8,
                   root_span=None) -> dict | None:
    """Analyze a live tracer's recorded spans. ``root_span`` — the
    caller's own just-closed root :class:`~zest_tpu_torch.telemetry.trace.
    Span` — pins the analysis window exactly (pull_model passes its
    root, so a daemon's accumulated tracer can never hand pull A
    another pull's root). Without it, the *newest* finished root is
    picked. Returns None when no root exists yet (tracer armed
    mid-pull).

    Caveat, inherent to a process-global tracer: spans from an
    overlapping concurrent pull that fall inside the window are not
    distinguishable (spans carry no per-pull identity) and share the
    blame; the per-session surfaces (``/v1/pulls``) stay correct —
    only the trace-level attribution blurs, exactly as the shared
    ``ZEST_TRACE`` file itself does."""
    ivs = [_Iv(s.name, s.t0, s.t1, s.attrs) for s in tracer.spans()]
    root = None
    if root_span is not None and getattr(root_span, "t1", 0):
        root = _Iv(root_span.name, root_span.t0, root_span.t1,
                   dict(root_span.attrs))
    try:
        return _analyze(ivs, root_name=root_name, top_k=top_k,
                        newest_root=True, root=root)
    except AnalyzeError:
        return None


def analyze_doc(doc: dict, host=None, root_name: str = "pull",
                top_k: int = 8) -> dict:
    """Analyze an exported Chrome trace doc (solo export or a
    ``fleet.merge_traces`` multi-host doc). For merged docs the
    analysis is confined to ONE host's spans — ``host`` selects it,
    defaulting to the host of the dominant root span (mixing hosts
    would blame one host's clock against another's). Raises
    :class:`AnalyzeError` when no root span is found. Accepts both
    Chrome trace forms: the object form (``{"traceEvents": [...]}``)
    our exporter writes and the bare-array variant other tools emit."""
    if isinstance(doc, list):
        raw = doc
    elif isinstance(doc, dict):
        raw = doc.get("traceEvents", [])
    else:
        raise AnalyzeError("not a Chrome trace document")
    events = [e for e in raw
              if isinstance(e, dict) and e.get("ph") == "X"]
    ivs = []
    for e in events:
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)) \
                or not isinstance(dur, (int, float)):
            continue
        ivs.append(_Iv(str(e.get("name", "")), ts / 1e6,
                       (ts + dur) / 1e6, e.get("args") or {}))
    if host is None:
        root = _pick_root(ivs, root_name, newest=False)
        host = root.attrs.get("host")
    if host is not None:
        ivs = [s for s in ivs
               if str(s.attrs.get("host", host)) == str(host)]
    return _analyze(ivs, root_name=root_name, top_k=top_k)


def render_text(report: dict) -> list[str]:
    """Human-readable summary lines for ``zest analyze``."""
    root = report["root"]
    head = f"critical path: {root.get('name', 'pull')}"
    if root.get("repo"):
        head += f" {root['repo']}"
        if root.get("revision"):
            head += f"@{str(root['revision'])[:12]}"
    if root.get("host") is not None:
        head += f" (host {root['host']})"
    lines = [
        head,
        f"  wall {root['wall_s']}s — path {report['path_s']}s "
        f"({report['coverage']:.0%} attributed), "
        f"idle {report['idle_s']}s, {report['steps']} steps",
        "  stage split:",
    ]
    path_s = report["path_s"] or 1.0
    for stage, sec in report["stages"].items():
        lines.append(f"    {stage:<9} {sec:>9.3f}s  {sec / path_s:>5.1%}")
    if report.get("tiers"):
        lines.append("  fetch tiers: " + "  ".join(
            f"{t}={sec:.3f}s" for t, sec in report["tiers"].items()))
    lines.append("  top blocking spans:")
    for s in report["top_spans"]:
        lines.append(
            f"    {s['blamed_s']:>8.3f}s  {s['name']:<22} "
            f"[{s['category']}]  @+{s['start_s']:.3f}s "
            f"(span {s['dur_s']:.3f}s)")
    return lines

"""``python -m zest_tpu_torch {push,serve,start,stop,status,ps,top,heal,stats,debug,analyze,trace,version,seed,pull,generate,watch,diff,models,bench}``.

The push → pull → generate subset of ``zest_tpu/cli.py``, on ``cuda`` by
default (``--device cpu`` runs on the CPU). ``serve`` starts the
publisher endpoint that a second node's ``pull`` points at
(``HF_ENDPOINT=http://host:port``), and seeds this node's xorb cache: a
BT-wire ``BtServer`` (``--listen-port``, ``ZEST_LISTEN_PORT``, 6881) and
a ``DcnServer`` (``--dcn-port``) share one peer-health book with the
node's swarm. ``serve`` indexes the xorb cache into an ``XorbRegistry``
(``POST /v1/push`` adds to it and announces what it adds); with a coop
identity (``ZEST_COOP_INDEX``, ``ZEST_COOP_HOSTS`` >= 2,
``ZEST_COOP_ADDRS``) and ``ZEST_GOSSIP`` on, it attaches a gossip node to
its swarm and its DCN listener and ticks it against the other hosts every
``ZEST_GOSSIP_INTERVAL_S``; ``serve --tracker URL`` also registers what it
announces with an HTTP tracker. ``seed [--tracker URL]`` announces every
cached xorb at ``ZEST_LISTEN_PORT``. ``pull`` finds peers through the
Kademlia DHT (UDP on ``ZEST_LISTEN_PORT``, an ephemeral port when that
one is taken; ``--no-dht`` skips it) and ``--tracker URL``;
``pull --peer HOST:PORT`` (repeatable) asks those peers first;
``--no-p2p`` turns the peer tier off. ``pull --coop
--coop-hosts N --coop-index I --coop-addr J=HOST:PORT ...`` runs the
cooperative pull: this host fetches its ~1/N of the xorbs and the
others' shares come over the DCN chunk RPC (its listener is
``ZEST_DCN_PORT``, 6991 by default), the collective exchange first
(``ZEST_COOP_COLLECTIVE=0`` keeps to the point-to-point one); ``--pod``
/ ``--no-pod`` force the pod round over every CUDA device on or off (on
by default with ``--device cuda``). ``pull --device=cuda`` lands the tree
sharded over ``ZEST_TPU_MESH`` (e.g. ``data=2,model=4``) over every CUDA
device when it is set, and its summary says so.
``push`` notifies the publisher (``--publisher URL``, default the local
``ZEST_HTTP_PORT``) unless ``--no-notify``; ``watch REPO --publisher URL``
delta-pulls and swaps each pushed revision; ``diff REPO@A [REV_B]``
prints the chunk-level delta from metadata alone, and ``diff REPO[@REV]
--push-preview DIR`` the dedup outcome of pushing ``DIR`` with nothing
written. ``generate REPO --ids
... | --prompt TEXT`` pulls and decodes a GPT-2 or Llama-family model,
greedy or sampled (``--temperature``, ``--top-k``, ``--top-p``,
``--seed``). ``serve`` also answers ``POST /v1/generate`` from the
serving pool on ``--device`` (``cuda`` by default), with ``/v1/health``,
``/v1/status``, ``/v1/models``, ``/v1/metrics`` and ``/v1/stop``;
``models [--resident] [--json]`` lists the pulled models, through the
running daemon's ``/v1/models`` when there is one. The daemon's life
cycle: ``start`` spawns ``serve`` in the background (its pid goes to
``ZEST_CACHE_DIR/zest.pid``) and waits for ``/v1/health``, ``stop`` asks
it to stop (``POST /v1/stop``, else SIGTERM to the recorded pid),
``status`` prints its ``/v1/status`` (with the pull service's ``tenancy``
block), ``ps [--watch|--json]`` lists its pull sessions (``/v1/pulls``:
id, repo@revision, tenant, status, phase, progress; then the admission
line), and ``version`` prints the package version. ``pull --tenant T``
labels the pull's session. Observability: ``stats [--json | --pod |
--watch]`` prints the daemon's metrics, ``debug [--tail N] [--out F]``
its ``/v1/debug`` report, ``trace REPO [--out F] [--coop --peer-api
I=HOST:PORT]`` pulls with a tracer installed and writes the Chrome trace
(``trace --merge a.json b.json`` merges per-host exports offline), and
``analyze TRACE.json [--json] [--host H] [--top K]`` prints a trace's
critical path. ``top [--count N | --json]`` is the live view over
``/v1/pulls`` and ``/v1/timeline`` (progress bars, tier rates, ring and
queue, anomalies); ``heal [--watch | --json | --dry-run on|off]`` the
self-healing engine's decisions (``/v1/remediations``). ``bench
[--json] [--no-device]`` runs the synthetic suite (``bench_suite``): the
host benches, then the device benches on ``cuda``; without a card it
fails unless ``--no-device``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

from zest_tpu_torch import __version__
from zest_tpu_torch.config import Config, parse_host_addr


def cmd_push(args) -> int:
    from zest_tpu_torch.transfer.push import push_checkpoint

    try:
        res = push_checkpoint(Config.load(), args.repo, args.checkpoint_dir,
                              base_revision=args.base, device=args.device,
                              notify=not args.no_notify,
                              notify_url=args.publisher)
    except (ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(res.summary(), indent=2))
        return 0
    print(f"pushed {args.repo}@{res.revision[:12]} "
          f"(parent {res.parent[:12] if res.parent else '(none)'})")
    print(f"  files {res.files} ({res.xet_files} xet), "
          f"{res.total_bytes:,} bytes")
    print(f"  new xorbs {res.new_xorbs} ({res.new_xorb_bytes:,} bytes, "
          f"{res.minted_chunks} chunks verified on {args.device}), "
          f"dedup ratio {res.dedup_ratio:.4f}")
    if res.notified:
        print(f"  fan-out: {res.notified.get('delivered', 0)} watcher(s) "
              "notified")
    elif not args.no_notify:
        print("  fan-out: no publisher reachable (revision still "
              "published locally)")
    return 0


def _daemon_text(cfg: Config, path: str, timeout: float = 2.0) -> str | None:
    """GET a local daemon endpoint (``cfg.effective_http_port()``) as
    text; None on any failure."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{cfg.effective_http_port()}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    except (OSError, urllib.error.URLError, UnicodeDecodeError):
        return None


def _daemon_get(cfg: Config, path: str, timeout: float = 2.0) -> dict | None:
    """GET a local daemon endpoint as JSON; None on any failure: no
    daemon, or an answer that is not a JSON object."""
    text = _daemon_text(cfg, path, timeout)
    try:
        payload = json.loads(text) if text is not None else None
    except ValueError:
        return None
    return payload if isinstance(payload, dict) else None


def _daemon_post(cfg: Config, path: str, body: dict | None = None,
                 timeout: float = 5.0) -> bool:
    """POST ``body`` as JSON (or nothing) to a local daemon endpoint; True
    on a 2xx."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{cfg.effective_http_port()}{path}",
        data=b"" if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return 200 <= r.status < 300
    except (OSError, urllib.error.URLError):
        return False


def _pid_file(cfg: Config) -> Path:
    return cfg.cache_dir / "zest.pid"


def _remove_pid_file(cfg: Config) -> None:
    """Remove both daemon state files (pid and recorded http port): a
    surviving port record would keep clients dialing a dead daemon."""
    for path in (_pid_file(cfg), cfg.http_port_file()):
        try:
            path.unlink()
        except OSError:
            pass


def _server_running(cfg: Config) -> bool:
    return _daemon_get(cfg, "/v1/health", timeout=1.0) is not None


def auto_start_server(cfg: Config) -> bool:
    """Spawn a detached ``serve`` unless a daemon answers already."""
    if _server_running(cfg):
        return False
    subprocess.Popen(
        [sys.executable, "-m", "zest_tpu_torch", "serve",
         "--port", str(cfg.http_port),
         "--listen-port", str(cfg.listen_port)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    return True


def cmd_start(args) -> int:
    cfg = Config.load()
    if _server_running(cfg):
        print("already running")
        return 0
    auto_start_server(cfg)
    deadline = time.monotonic() + args.timeout
    while time.monotonic() < deadline:
        if _server_running(cfg):
            print(f"started (http :{cfg.effective_http_port()})")
            return 0
        time.sleep(0.1)
    print("daemon failed to become healthy", file=sys.stderr)
    return 1


def cmd_stop(_args) -> int:
    """``POST /v1/stop``, else SIGTERM to the recorded pid. The health
    check comes first: a stale port record may point at another
    service, which must not get the stop."""
    cfg = Config.load()
    if _server_running(cfg) and _daemon_post(cfg, "/v1/stop"):
        print("stopped")
        return 0
    pid_file = _pid_file(cfg)
    if pid_file.exists():
        try:
            pid = int(pid_file.read_text().strip())
            os.kill(pid, signal.SIGTERM)
            print(f"sent SIGTERM to pid {pid}")
        except (ValueError, ProcessLookupError):
            print("stale pid file removed")
        _remove_pid_file(cfg)
        return 0
    print("not running")
    return 0


def cmd_status(_args) -> int:
    payload = _daemon_get(Config.load(), "/v1/status")
    if payload is None:
        print("daemon not running")
        return 1
    print(json.dumps(payload, indent=2))
    return 0


def cmd_version(_args) -> int:
    print(f"zest-tpu-torch {__version__}")
    return 0


def _ps_lines(payload: dict) -> list[str]:
    """One ``ps`` frame from the ``/v1/pulls`` document: active sessions,
    then the recent ring, the admission line and the SLO burn line."""
    rows = [("ID", "REPO@REV", "TENANT", "STATUS", "PHASE", "PROG",
             "ELAPSED")]

    def row(s: dict) -> tuple:
        rev = str(s.get("revision", ""))[:12]
        prog = ""
        if s.get("progress") is not None:
            prog = f"{s['progress']:.0%}"
            if s.get("eta_s") is not None:
                prog += f" eta {s['eta_s']}s"
        status = s.get("status", "?")
        if s.get("slo") and any(v.get("breached")
                                for v in s["slo"].values()):
            status += "!slo"
        return (s.get("id", "?"), f"{s.get('repo', '?')}@{rev}",
                s.get("tenant") or "-", status, s.get("phase", ""),
                prog, f"{s.get('elapsed_s', 0)}s")

    for s in payload.get("active") or []:
        rows.append(row(s))
    for s in payload.get("recent") or []:
        rows.append(row(s))
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    if len(rows) == 1:
        lines.append("no pull sessions (daemon idle, or ZEST_TELEMETRY=0)")
    # Queued against active, and the total of typed 429s; a queued
    # session also shows above with phase "queued".
    tn = payload.get("tenancy") or {}
    if tn:
        line = (f"tenancy: {tn.get('active', 0)}/{tn.get('max_pulls', '?')}"
                f" active  {tn.get('queued', 0)}/{tn.get('queue_cap', '?')}"
                " queued")
        if tn.get("rejected_total"):
            line += f"  rejected {tn['rejected_total']}"
        lines.append(line)
    burn = payload.get("slo") or {}
    if burn:
        lines.append("slo burn: " + "  ".join(
            f"{k}={v['breaches']}/{v['pulls']} ({v['burn']:.1%})"
            for k, v in sorted(burn.items())))
    return lines


def cmd_ps(args) -> int:
    """The daemon's pull sessions (``GET /v1/pulls``); ``--watch``
    redraws every ``--interval`` seconds (``--count`` frames, or until
    Ctrl-C)."""
    cfg = Config.load()
    frames = 0
    try:
        while True:
            payload = _daemon_get(cfg, "/v1/pulls")
            if payload is None:
                print("daemon not running", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(payload, indent=2))
            else:
                if args.watch and sys.stdout.isatty():
                    sys.stdout.write("\x1b[H\x1b[2J")
                print("\n".join(_ps_lines(payload)))
            frames += 1
            if not args.watch or (args.count and frames >= args.count):
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _fmt_rate(bps: float) -> str:
    """Human B/s: 1.25 GB/s, 310 MB/s, 12 kB/s, 0 B/s."""
    if bps >= 1e9:
        return f"{bps / 1e9:.2f} GB/s"
    if bps >= 1e6:
        return f"{bps / 1e6:.1f} MB/s"
    if bps >= 1e3:
        return f"{bps / 1e3:.0f} kB/s"
    return f"{bps:.0f} B/s"


def _bar(frac: float, width: int = 24) -> str:
    frac = min(1.0, max(0.0, frac))
    filled = int(round(frac * width))
    return "[" + "#" * filled + "-" * (width - filled) + "]"


def _series_last(tl: dict, name: str):
    s = (tl.get("series") or {}).get(name)
    if not s or not s.get("samples"):
        return None
    return s["samples"][-1][1]


def _series_rate(tl: dict, name: str):
    """The latest per-second change of a gauge series (a session's byte
    progress) from its last two samples."""
    s = (tl.get("series") or {}).get(name)
    pts = (s or {}).get("samples") or []
    if len(pts) < 2:
        return None
    (t0, v0), (t1, v1) = pts[-2], pts[-1]
    if t1 <= t0:
        return None
    return max(0.0, (v1 - v0) / (t1 - t0))


def _top_lines(status: dict, pulls: dict, tl: dict,
               width: int = 78) -> list[str]:
    """One ``zest top`` frame: the header, each session's progress bar
    with its live byte rate, the tier-rate, ring and queue lines from
    the timeline's latest samples, and the anomaly tail."""
    active = pulls.get("active") or []
    recent = pulls.get("recent") or []
    tn = pulls.get("tenancy") or {}
    anomalies = tl.get("anomalies") or []
    lines = [
        f"zest top — v{status.get('version', '?')}  "
        f"active {len(active)}"
        + (f"  queued {tn.get('queued', 0)}" if tn else "")
        + f"  recent {len(recent)}"
        + (f"  anomalies {len(anomalies)}" if anomalies else "")
    ]
    for s in active:
        sid = s.get("id", "?")
        frac = s.get("progress")
        rate = _series_rate(tl, f"session.{sid}.bytes")
        anns = ",".join(sorted((s.get("anomalies") or {})))
        row = (f"  {sid}  {s.get('repo', '?')}  "
               f"{s.get('phase', ''):<10} ")
        row += _bar(frac if frac is not None else 0.0)
        if frac is not None:
            row += f" {frac:>4.0%}"
        if rate is not None:
            row += f"  {_fmt_rate(rate)}"
        if s.get("eta_s") is not None:
            row += f"  eta {s['eta_s']}s"
        if anns:
            row += f"  !{anns}"
        lines.append(row[:width + 30])
    if not active:
        lines.append("  (no active pulls)")
    tiers = []
    for tier in ("cdn", "peer", "cache", "dcn"):
        v = _series_last(tl, f"fetch.{tier}_bps")
        if v is not None:
            tiers.append(f"{tier}={_fmt_rate(v)}")
    for name, label in (("dcn.bps", "dcn_serve"), ("seed.bps", "seed"),
                        ("collective.ici_bps", "coll_ici"),
                        ("collective.dcn_bps", "coll_dcn")):
        v = _series_last(tl, name)
        if v:
            tiers.append(f"{label}={_fmt_rate(v)}")
    if tiers:
        lines.append("rates: " + "  ".join(tiers))
    ring = _series_last(tl, "ring.in_use_bytes")
    if ring is not None:
        stalls = _series_last(tl, "ring.stalls")
        lines.append(f"ring:  {int(ring):,} B in flight"
                     + (f"  stalls={int(stalls)}" if stalls else ""))
    depth = _series_last(tl, "tenancy.queue_depth")
    if depth is not None:
        adm = int(_series_last(tl, "tenancy.active_pulls") or 0)
        flights = int(_series_last(tl, "tenancy.inflight_fetches") or 0)
        lines.append(f"queue: depth={int(depth)}  active={adm}"
                     f"  inflight_fetches={flights}")
    for ev in anomalies[-4:]:
        row = f"anomaly: {ev.get('kind')}"
        if ev.get("session"):
            row += f"  session={ev['session']}"
        for k in ("phase", "partner", "depth", "rate_bps"):
            if k in ev:
                row += f"  {k}={ev[k]}"
        lines.append(row)
    if tl.get("enabled") is False:
        lines.append("timelines off (ZEST_TIMELINE=0) — rates and "
                     "anomalies unavailable")
    return lines


def cmd_top(args) -> int:
    """The live view over ``/v1/pulls`` and ``/v1/timeline``, redrawn
    until Ctrl-C (or ``--count`` frames); ``--json`` prints one raw
    document."""
    cfg = Config.load()
    frames = 0
    try:
        while True:
            status = _daemon_get(cfg, "/v1/status")
            if status is None:
                print("daemon not running", file=sys.stderr)
                return 1
            pulls = _daemon_get(cfg, "/v1/pulls") or {}
            tl = _daemon_get(cfg, "/v1/timeline") or {}
            if args.json:
                print(json.dumps({"status": status, "pulls": pulls,
                                  "timeline": tl}, indent=2))
                return 0
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J")
            print("\n".join(_top_lines(status, pulls, tl)))
            frames += 1
            if args.count and frames >= args.count:
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def _heal_lines(doc: dict) -> list[str]:
    """``/v1/remediations`` as the operator view: the engine's mode,
    knob overrides, outcome counts per action, recent decisions."""
    lines: list[str] = []
    if not doc.get("enabled"):
        return ["self-healing off (ZEST_REMEDIATE=0 or timelines off) "
                "— the process is a pure observer"]
    mode = "DRY-RUN (decisions only)" if doc.get("dry_run") else "live"
    lines.append(
        f"self-healing: {mode}  "
        f"actions={','.join(doc.get('actions') or []) or '-'}  "
        f"rate={doc.get('rate_s')}s/token burst={doc.get('burst')}")
    if doc.get("shedding"):
        lines.append("LOAD SHEDDING ACTIVE — new queued pulls answer "
                     "429 until the SLO burn recovers")
    for name, k in sorted((doc.get("knobs") or {}).items()):
        if k.get("value") != k.get("base"):
            lines.append(
                f"knob {name}: {k.get('value')} "
                f"(base {k.get('base')}, rails "
                f"[{k.get('min')}, {k.get('max')}])")
    counts = doc.get("counts") or {}
    if counts:
        lines.append("decisions:")
        for action, outcomes in sorted(counts.items()):
            pairs = "  ".join(f"{o}={n}"
                              for o, n in sorted(outcomes.items()))
            lines.append(f"  {action:<8} {pairs}")
    else:
        lines.append("decisions: none yet")
    recent = doc.get("recent") or []
    if recent:
        lines.append("recent:")
    for e in recent[-10:]:
        ts = time.strftime("%H:%M:%S", time.localtime(e.get("t", 0)))
        row = (f"  {ts}  {e.get('action', '?'):<8} "
               f"{e.get('outcome', '?'):<12} {e.get('reason', '')}")
        if e.get("session"):
            row += f"  session={e['session']}"
        lines.append(row)
    return lines


def cmd_heal(args) -> int:
    """The daemon's self-healing engine (``/v1/remediations``): what it
    decided, on which anomaly, with which outcome; ``--dry-run on|off``
    flips decision-only mode on the live engine."""
    cfg = Config.load()
    if args.dry_run is not None:
        want = args.dry_run == "on"
        if not _daemon_post(cfg, "/v1/remediations", {"dry_run": want},
                            timeout=2.0):
            print("daemon not running", file=sys.stderr)
            return 1
        print(f"dry-run {'on' if want else 'off'}")
        return 0
    frames = 0
    try:
        while True:
            payload = _daemon_get(cfg, f"/v1/remediations?limit="
                                       f"{args.limit}")
            if payload is None:
                print("daemon not running", file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(payload, indent=2))
            else:
                if args.watch and sys.stdout.isatty():
                    sys.stdout.write("\x1b[H\x1b[2J")
                print("\n".join(_heal_lines(payload)))
            frames += 1
            if not args.watch or (args.count and frames >= args.count):
                return 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        return 0


def cmd_stats(args) -> int:
    """The daemon's process metrics: ``GET /v1/metrics`` verbatim
    (Prometheus text; ``--pod`` the pod-scope sum), the ``/v1/status``
    telemetry, faults and peer-health blocks with ``--json``, or a live
    redraw over ``/v1/debug`` with ``--watch``."""
    cfg = Config.load()
    if args.watch:
        return _stats_watch(cfg, interval=args.interval, count=args.count)
    if args.json:
        payload = _daemon_get(cfg, "/v1/status")
        if payload is None:
            print("daemon not running", file=sys.stderr)
            return 1
        keep = {k: payload[k] for k in
                ("telemetry", "faults", "swarm", "peers", "hbm", "dcn")
                if k in payload}
        print(json.dumps(keep, indent=2))
        return 0
    text = _daemon_text(cfg, "/v1/metrics?scope=pod" if args.pod
                        else "/v1/metrics",
                        timeout=10.0 if args.pod else 2.0)
    if text is None:
        print("daemon not running", file=sys.stderr)
        return 1
    sys.stdout.write(text)
    return 0


def _stats_watch_lines(debug: dict, status: dict) -> list[str]:
    """One frame of ``stats --watch``, from ``/v1/debug`` and
    ``/v1/status``."""
    lines = [f"zest-tpu v{status.get('version', '?')}  "
             f"http_requests={status.get('http_requests', 0)}  "
             f"xorbs={status.get('xorbs_cached', 0)}"]
    landing = debug.get("landing") or {}
    if landing:
        fl = landing.get("first_layer_s")
        hbm = landing.get("time_to_hbm_s")
        ratio = landing.get("first_layer_ratio")
        lane = "landing:"
        if fl is not None:
            lane += f" first_layer={fl}s"
        if hbm is not None:
            lane += f" hbm={hbm}s"
        if ratio is not None:
            lane += f" ({ratio:.0%} of hbm)"
        if "ring_stalls" in landing:
            lane += f"  ring_stalls={landing['ring_stalls']}"
        lines.append(lane)
        if "delta_ratio" in landing or "swap_s" in landing:
            dline = "delta:"
            if "delta_ratio" in landing:
                dline += f" fetched={landing['delta_ratio']:.1%} of bytes"
            if "swap_s" in landing:
                dline += f"  swap={landing['swap_s']}s"
            lines.append(dline)
    coop = debug.get("coop") or {}
    if coop:
        ratio = coop.get("peer_served_ratio")
        tiers = " ".join(f"{t}={b}" for t, b in
                         sorted((coop.get("tier_bytes") or {}).items()))
        lines.append(
            "coop: peer_served="
            + (f"{ratio:.1%}" if ratio is not None else "n/a")
            + (f"  wall={coop['exchange_wall_s']}s"
               if "exchange_wall_s" in coop else "")
            + (f"  fallbacks={coop['fallbacks']}"
               if "fallbacks" in coop else "")
            + (f"  [{tiers}]" if tiers else ""))
        cx = coop.get("collective") or {}
        if cx:
            links = " ".join(f"{lk}={b}" for lk, b in
                             sorted((cx.get("link_bytes") or {}).items()))
            lines.append(
                f"collective: phases={cx.get('phases', 0)}"
                + (f"  wall={cx['wall_s']}s" if "wall_s" in cx else "")
                + (f"  aborts={cx['aborts']}" if cx.get("aborts") else "")
                + (f"  [{links}]" if links else ""))
    seeding = status.get("seeding") or {}
    if seeding.get("chunks_served") or seeding.get("active_leechers"):
        sline = (f"seed: {seeding.get('bytes_served', 0)}B in "
                 f"{seeding.get('chunks_served', 0)} chunks  "
                 f"unchoked={seeding.get('unchoked', 0)}"
                 f"/{seeding.get('unchoked', 0) + seeding.get('choked', 0)}")
        if seeding.get("choke_events"):
            sline += f"  choke_events={seeding['choke_events']}"
        if seeding.get("refused_quarantined"):
            sline += f"  refused={seeding['refused_quarantined']}"
        if seeding.get("uploads_expired"):
            sline += f"  expired={seeding['uploads_expired']}"
        if seeding.get("rate_bps"):
            sline += f"  rate={seeding['rate_bps']}B/s"
        lines.append(sline)
    quarantined = debug.get("quarantined_peers") or []
    if quarantined:
        lines.append("quarantined: "
                     + ", ".join(p["peer"] for p in quarantined))
    faults_fired = debug.get("faults") or {}
    if faults_fired:
        lines.append("faults: " + " ".join(
            f"{k}={v}" for k, v in sorted(faults_fired.items())))
    events = (debug.get("recorder") or {}).get("events") or []
    if events:
        lines.append("recorder tail:")
        for ev in events[-8:]:
            extra = " ".join(f"{k}={v}" for k, v in ev.items()
                             if k not in ("t", "kind"))
            lines.append(f"  {ev.get('t', 0):.3f} {ev.get('kind')} {extra}")
    return lines


def _stats_watch(cfg: Config, interval: float = 1.0, count: int = 0) -> int:
    """Redraw every ``interval`` seconds, ``count`` frames (0: until
    Ctrl-C)."""
    frames = 0
    try:
        while True:
            debug = _daemon_get(cfg, "/v1/debug?tail=8") or {}
            status = _daemon_get(cfg, "/v1/status") or {}
            if not status:
                print("daemon not running", file=sys.stderr)
                return 1
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J")
            print("\n".join(_stats_watch_lines(debug, status)))
            frames += 1
            if count and frames >= count:
                return 0
            time.sleep(max(0.1, interval))
    except KeyboardInterrupt:
        return 0


def cmd_debug(args) -> int:
    """The daemon's ``/v1/debug`` (recorder tail, coop summary, landing,
    quarantined peers) to stdout or, with ``--out``, to a JSON file."""
    cfg = Config.load()
    payload = _daemon_get(cfg, f"/v1/debug?tail={args.tail}", timeout=5.0)
    if payload is None:
        print("daemon not running", file=sys.stderr)
        return 1
    body = json.dumps(payload, indent=2)
    if args.out:
        Path(args.out).write_text(body + "\n")
        n = len((payload.get("recorder") or {}).get("events") or [])
        print(f"debug report: {args.out} ({n} recorder events)")
    else:
        print(body)
    return 0


def cmd_analyze(args) -> int:
    """Critical-path attribution over a trace export (solo, or merged by
    ``trace --merge``): per-stage and per-tier blamed seconds and the top
    blocking spans."""
    from zest_tpu_torch.telemetry import critpath

    try:
        doc = json.loads(Path(args.trace).read_text())
    except (OSError, ValueError) as exc:
        print(f"error: cannot read trace: {exc}", file=sys.stderr)
        return 1
    try:
        report = critpath.analyze_doc(doc, host=args.host, top_k=args.top)
    except critpath.AnalyzeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print("\n".join(critpath.render_text(report)))
    return 0


def _write_merged(docs: dict, out: str, reference=None) -> None:
    from zest_tpu_torch.telemetry import fleet

    merged = fleet.merge_traces(docs, reference=reference)
    Path(out).write_text(json.dumps(merged))
    meta = merged["otherData"]
    print(f"merged trace: {out} ({len(meta['merged_hosts'])} host "
          f"tracks, {meta['flow_links']} cross-host flow links)")


def _host_key(doc: dict, default):
    """The host a trace doc recorded for itself, else ``default``."""
    return doc.get("otherData", {}).get("context", {}).get("host", default)


def cmd_trace(args) -> int:
    """Pull with a tracer installed and write its Chrome trace (view it
    at ui.perfetto.dev), printing the span count and wall coverage.
    ``--merge a.json b.json`` merges per-host exports offline, with no
    pull; ``--coop`` gathers every pod peer's live ``/v1/trace``
    (``--peer-api`` or ``ZEST_POD_PEERS``) after the traced pull and
    writes one merged multi-track file."""
    if args.merge:
        docs = {}
        for i, path in enumerate(args.merge):
            doc = json.loads(Path(path).read_text())
            docs[_host_key(doc, i)] = doc
        _write_merged(docs, args.out)
        return 0
    if args.repo is None:
        print("error: a repo id is required unless --merge is given",
              file=sys.stderr)
        return 2
    cfg = Config.load()
    try:
        cfg.model_cache_dir(args.repo)  # repo-id syntax, before any I/O
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    peer_apis = {}
    if args.coop:
        try:
            peer_apis = dict(parse_host_addr(a) for a in args.peer_api or [])
        except ValueError as exc:
            print(f"error: --peer-api: {exc}", file=sys.stderr)
            return 2
        peer_apis = peer_apis or dict(cfg.pod_peers)
        if not peer_apis:
            print("error: --coop needs peer API endpoints (--peer-api "
                  "I=HOST:PORT or ZEST_POD_PEERS)", file=sys.stderr)
            return 2
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.telemetry import fleet
    from zest_tpu_torch.transfer.pull import pull_model

    # The command is the opt-in: ZEST_TELEMETRY=0 must not turn a
    # requested trace into an empty one.
    telemetry.set_enabled(True)
    tracer = telemetry.trace.install(None)
    t0 = time.monotonic()
    failed = None
    try:
        res = pull_model(cfg, args.repo, revision=args.revision,
                         device=args.device, no_p2p=args.no_p2p,
                         coop=True if args.coop else None)
    except Exception as exc:  # noqa: BLE001 - a failed pull's trace is
        failed = exc          # what the operator wants to see
    elapsed = time.monotonic() - t0
    if args.coop:
        own = (cfg.coop_index if cfg.coop_index is not None
               else cfg.mesh.process_id)
        docs, errors = fleet.gather_traces(peer_apis)
        for key, err in sorted(errors.items(), key=lambda i: str(i)):
            print(f"host {key}: trace unavailable ({err})", file=sys.stderr)
        keyed = {_host_key(doc, key): doc for key, doc in docs.items()}
        keyed[own] = tracer.to_chrome()
        _write_merged(keyed, args.out, reference=own)
    else:
        n = tracer.export(args.out)
        print(f"trace: {args.out} ({n} events, spans cover "
              f"{tracer.coverage_s():.2f}s of {elapsed:.2f}s wall)")
    print("view:  https://ui.perfetto.dev or chrome://tracing")
    if failed is not None:
        print(f"error: pull failed: {failed}", file=sys.stderr)
        return 1
    print(f"✓ {args.repo} -> {res.snapshot_dir}")
    return 0


def _build_swarm(cfg: Config, tracker: str | None = None, dht: bool = True,
                 health=None):
    """A ``SwarmDownloader`` with the configured discovery sources, which
    it closes with itself: the DHT (UDP on ``cfg.listen_port``, an
    ephemeral port when that one is taken; reference swarm.zig:221) and
    an HTTP tracker. The DHT is not bootstrapped here: it answers from
    the nodes that reach it. A coop identity attaches the gossip node
    (:func:`_attach_fleet_gossip`)."""
    from zest_tpu_torch.p2p import peer_id as peer_id_mod
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    sources = []
    if dht:
        from zest_tpu_torch.p2p.dht import Dht

        try:
            sources.append(Dht(bind=("0.0.0.0", cfg.listen_port)))
        except OSError:  # the port is taken (a daemon owns it)
            try:
                sources.append(Dht(bind=("0.0.0.0", 0)))
            except OSError:
                pass
    if tracker:
        from zest_tpu_torch.p2p.tracker import TrackerClient

        sources.append(TrackerClient(tracker, peer_id_mod.generate(),
                                     listen_port=cfg.listen_port))
    swarm = SwarmDownloader(cfg, peer_sources=sources, health=health,
                            own_sources=True)
    _attach_fleet_gossip(cfg, swarm)
    return swarm


def _attach_fleet_gossip(cfg: Config, swarm, dcn_server=None):
    """With a coop identity (host index + a fleet of two or more) and
    ``ZEST_GOSSIP`` on, the gossip node becomes the swarm's primary
    discovery source (tracker and DHT demote to bootstrap announce) and,
    given a ``DcnServer``, answers anti-entropy rounds on its listener.
    Returns the node, or None (no identity, or ``ZEST_GOSSIP=0``)."""
    if cfg.coop_index is None or not cfg.coop_hosts or cfg.coop_hosts < 2:
        return None
    from zest_tpu_torch.transfer.gossip import node_from_config

    node = node_from_config(cfg, cfg.coop_index, cfg.coop_hosts,
                            cfg.coop_addrs or None)
    if node is None:
        return None
    swarm.attach_gossip(node)
    if dcn_server is not None:
        dcn_server.attach_gossip(node)
    return node


def _start_gossip_loop(cfg: Config, node) -> threading.Event:
    """Tick ``node`` against ``cfg.coop_addrs``' DCN endpoints every
    ``cfg.gossip_interval_s`` until the returned event is set."""
    from zest_tpu_torch.transfer.dcn import DcnPool
    from zest_tpu_torch.transfer.gossip import DcnGossipTransport

    pool = DcnPool()
    transport = DcnGossipTransport(pool, cfg.coop_addrs)
    stop = threading.Event()

    def loop() -> None:
        try:
            while not stop.wait(cfg.gossip_interval_s):
                try:
                    node.tick(transport)
                except Exception:  # noqa: BLE001 - gossip is best-effort
                    pass
        finally:
            pool.close()

    threading.Thread(target=loop, name="zest-gossip", daemon=True).start()
    print(f"gossip: fanout {node.fanout()} over {len(cfg.coop_addrs)} "
          f"peers, every {cfg.gossip_interval_s:g}s", flush=True)
    return stop


def cmd_serve(args) -> int:
    """The daemon over this node's cache until SIGINT, SIGTERM or
    ``POST /v1/stop``: the publisher endpoint, the serving routes and
    the seeding tier. Then the seeder drains and its ``ServerStats``
    print as one JSON line."""
    from zest_tpu_torch import storage
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.p2p.health import HealthRegistry
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.server import BtServer

    cfg = Config.load()
    if args.listen_port is not None:
        cfg.listen_port = args.listen_port
    if args.dcn_port is not None:
        cfg.dcn_port = args.dcn_port
    port = cfg.http_port if args.port is None else args.port
    registry = storage.XorbRegistry()
    print(f"indexed {registry.scan(cfg)} cached xorbs", flush=True)
    # One health book for the node: the seeder's reciprocity ranking,
    # stalled-reader strikes and quarantine oracle read what the node's
    # swarm writes.
    health = HealthRegistry()
    bt = BtServer(cfg, health=health)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    dcn = None
    server = None
    swarm = None
    gossip_stop = None
    try:
        bt_port = bt.start()
        # The announces carry the bound port (``--listen-port 0``).
        cfg.listen_port = bt_port
        # No DHT: the daemon's swarm discovers through the tracker and
        # the gossip plane only (the JAX package's daemon has neither
        # a DHT nor a tracker).
        swarm = _build_swarm(cfg, tracker=args.tracker, dht=False,
                             health=health)
        shaped = ""
        if cfg.seed_rate_bps or cfg.seed_peer_bps:
            shaped = (f", shaped {cfg.seed_rate_bps or 'unlimited'} B/s "
                      f"global / {cfg.seed_peer_bps or 'unlimited'} B/s "
                      "per-peer")
        print(f"seeding on :{bt_port} (BT wire, {cfg.seed_slots}+1 upload "
              f"slots{shaped})", flush=True)
        # Same cache, second transport; a taken port leaves BT-only
        # seeding, not a dead node.
        dcn = DcnServer(cfg, bt.cache)
        try:
            print(f"seeding on :{dcn.start()} (DCN chunk RPC)", flush=True)
        except OSError as exc:
            dcn = None
            print(f"DCN listener disabled (port {cfg.dcn_port}: {exc})",
                  flush=True)
        # The gossip plane: rounds answered on the DCN listener, and the
        # active tick loop against the other hosts' DCN endpoints.
        gossip_node = swarm.gossip
        if gossip_node is not None and dcn is not None:
            dcn.attach_gossip(gossip_node)
        if gossip_node is not None and cfg.coop_addrs:
            gossip_stop = _start_gossip_loop(cfg, gossip_node)
        # The serving routes pull through this node's swarm.
        server = PublisherServer(cfg, host=args.host, port=port,
                                 device=args.device, swarm=swarm,
                                 bt_server=bt, registry=registry,
                                 gossip_node=gossip_node,
                                 dcn_server=dcn).start()
        bound = server.api.port
        try:
            storage.atomic_write(cfg.http_port_file(), str(bound).encode())
            storage.atomic_write(_pid_file(cfg), str(os.getpid()).encode())
        except OSError:
            pass  # only the client side of a port-0 daemon reads them
        print(f"publisher endpoint at {server.url}", flush=True)
        print(f"serving /v1/generate on {args.device}", flush=True)
        try:
            # SIGTERM, or POST /v1/stop.
            while not (stop.wait(0.5) or server.api.shutdown_event.is_set()):
                pass
        except KeyboardInterrupt:
            pass
    finally:
        if gossip_stop is not None:
            gossip_stop.set()
        if server is not None:
            server.close()
        pool_mod = sys.modules.get("zest_tpu_torch.models.hbm_pool")
        if pool_mod is not None:
            pool_mod.reset()  # evict what the pool holds
        if dcn is not None:
            dcn.shutdown()
        bt.shutdown()
        if swarm is not None:
            swarm.close()
        _remove_pid_file(cfg)
    print("seeder stats: " + json.dumps(dataclasses.asdict(bt.get_stats())),
          flush=True)
    return 0


def cmd_models(args) -> int:
    """Pulled models and the xorb cache's totals, through the running
    daemon's ``/v1/models`` when there is one (else from the caches).
    ``--resident`` lists the trees the daemon's serving pool holds on
    its device."""
    from zest_tpu_torch import storage

    cfg = Config.load()
    payload = _daemon_get(cfg, "/v1/models")
    if args.resident:
        resident = (payload.get("resident")
                    if isinstance(payload, dict) else None)
        if not isinstance(resident, list):
            print("no HBM pool state (daemon not running, or "
                  "ZEST_HBM_POOL=0)", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps({"resident": resident}))
            return 0
        if not resident:
            print("HBM pool empty")
        for r in resident:
            line = (f"{r.get('repo')}  {r.get('state')}  "
                    f"{r.get('bytes', 0) / 1e6:.1f} MB  "
                    f"pins {r.get('pins', 0)}  lands {r.get('lands', 0)}")
            ex = r.get("experts")
            if isinstance(ex, dict):
                line += (f"  experts {ex.get('residency', 0) * 100:.0f}%"
                         " resident")
            print(line)
        return 0
    models = payload.get("models") if payload is not None else None
    if not isinstance(models, list) or any(
            not isinstance(m, dict) or not m.get("repo_id")
            for m in models):
        # A foreign service on the recorded port: scan the caches.
        models = storage.list_models(cfg)
    xorbs = storage.list_cached_xorbs(cfg)
    xorb_bytes = 0
    for hex_key in xorbs:
        try:
            xorb_bytes += cfg.xorb_cache_path(hex_key).stat().st_size
        except OSError:
            pass
    if args.json:
        print(json.dumps({"models": models, "xorbs": len(xorbs),
                          "xorb_bytes": xorb_bytes}))
        return 0
    if not models:
        print("no models pulled")
    for m in models:
        rev = (m.get("revision") or "?")[:12]
        pool = f"  [hbm:{m['pool_state']}]" if m.get("pool_state") else ""
        print(f"{m.get('repo_id')}  rev {rev}  "
              f"{m.get('files', 0)} files{pool}")
    print(f"xorb cache: {len(xorbs)} xorbs, {xorb_bytes / 1e6:.1f} MB")
    return 0


def cmd_seed(args) -> int:
    """Announce every cached xorb at ``ZEST_LISTEN_PORT`` (reference
    main.zig:307-369)."""
    from zest_tpu_torch import storage

    cfg = Config.load()
    hashes = storage.list_cached_xorbs(cfg)
    if not hashes:
        print("nothing cached to seed")
        return 0
    swarm = _build_swarm(cfg, tracker=args.tracker)
    try:
        n = swarm.announce_xorbs(hashes)
    finally:
        swarm.close()
    print(f"announced {n}/{len(hashes)} xorbs to the swarm")
    return 0


def _swarm_for(args, tracker: str | None = None, dht: bool = False):
    """The pull's peer tier: None for ``--no-p2p``, else a swarm over the
    ``--peer`` direct peers with the discovery sources ``tracker`` and
    ``dht`` (see :func:`_build_swarm`). A swarm that cannot be built
    leaves the pull CDN-only, said on stderr."""
    if args.no_p2p:
        return None
    from zest_tpu_torch.p2p.peer import parse_address

    swarm = None
    try:
        swarm = _build_swarm(Config.load(), tracker=tracker, dht=dht)
        for spec in args.peer or []:
            swarm.add_direct_peer(*parse_address(spec))
    except (OSError, ValueError) as exc:
        if swarm is not None:
            swarm.close()
        print(f"p2p unavailable ({exc}); continuing CDN-only",
              file=sys.stderr)
        return None
    return swarm


def cmd_pull(args) -> int:
    from zest_tpu_torch.transfer.pull import pull_model

    if (args.pods is None) != (args.pod_index is None):
        print("error: --pods and --pod-index must be given together",
              file=sys.stderr)
        return 2
    if args.pods is not None and not 0 <= args.pod_index < args.pods:
        print(f"error: --pod-index {args.pod_index} outside [0,{args.pods})",
              file=sys.stderr)
        return 2
    addrs = {}
    for flag in ("coop_addr", "pod_addr"):
        try:
            addrs[flag] = dict(parse_host_addr(a)
                               for a in getattr(args, flag) or [])
        except ValueError as exc:
            print(f"error: --{flag.replace('_', '-')}: {exc}",
                  file=sys.stderr)
            return 2
    swarm = _swarm_for(args, tracker=args.tracker, dht=not args.no_dht)
    try:
        res = pull_model(Config.load(), args.repo, revision=args.revision,
                         device=args.device, coop=args.coop,
                         coop_hosts=args.coop_hosts,
                         coop_index=args.coop_index,
                         coop_addrs=addrs["coop_addr"], swarm=swarm,
                         no_p2p=args.no_p2p, pod=args.pod, pods=args.pods,
                         pod_index=args.pod_index,
                         pod_addrs=addrs["pod_addr"], tenant=args.tenant)
    finally:
        if swarm is not None:
            swarm.close()
    st = res.stats
    print(f"pulled {args.repo}@{st['revision'][:12]} → {res.snapshot_dir}")
    print(f"  {st['files_downloaded']} downloaded, {st['files_skipped']} "
          f"skipped; {st['hbm']['tensors']} tensors "
          f"({st['hbm']['bytes']:,} bytes) on {st['device']}")
    first = (f", first layer {st['time_to_first_layer_s']} s"
             if "time_to_first_layer_s" in st else "")
    print(f"  elapsed {st['elapsed_s']} s, time to device "
          f"{st['time_to_hbm_s']} s{first} "
          f"({'direct' if st['hbm']['direct'] else 'from disk'})")
    nbytes = st["fetch"]["bytes"]
    print(f"  From cache: {nbytes['cache']} bytes")
    print(f"  From peers: {nbytes['peer']} bytes")
    print(f"  From CDN:   {nbytes['cdn']} bytes")
    print(f"  P2P ratio:  {st['fetch']['p2p_ratio']:.1%}")
    coop = st.get("coop")
    if coop and not coop.get("skipped"):
        ex = coop["exchange"]
        print(f"  coop host {coop['host']}/{coop['hosts']}: "
              f"{coop['fetch']['units']} fetched, {ex['units']} over DCN "
              f"({ex['wire_bytes']:,} wire bytes, {ex['unpacked_bytes']:,} "
              f"unpacked), {coop['fallbacks']} fallback, "
              f"{ex['verify_rejected']} rejected — peer-served "
              f"{coop['peer_served_ratio']:.1%}")
        cx = coop.get("collective")
        if cx:
            links = " ".join(f"{lk}={b}" for lk, b in
                             sorted(cx["link_bytes"].items()) if b)
            line = (f"  Collective: {cx['schedule']} {cx['phases']} "
                    f"phase(s), {cx['windows']} window(s)")
            if links:
                line += f" [{links}]"
            if cx.get("aborted"):
                line += (f" — aborted ({cx['aborted']}), degraded to "
                         "point-to-point")
            print(line)
    fed = st.get("federated")
    if fed:
        print(f"  Federated:  pod {fed['pod']}/{fed['pods']}: "
              f"{fed['own_units']} own, {fed['dcn_units']} over DCN "
              f"({fed['dcn_bytes']} bytes), {fed['fallback_units']} "
              "CDN-fallback")
    if st["hbm"].get("sharded"):
        shape = ",".join(f"{a}={n}" for a, n in st["mesh"].items())
        print(f"  Sharded:    over the mesh {shape}")
    pod = st.get("pod")
    if pod and pod.get("expert_routed"):
        sh = pod["shared"]
        print(f"  Expert routed: {pod['n_experts']} experts; "
              f"{pod['expert_units_fetched']} expert units "
              f"({pod['expert_bytes']:,} bytes) fetched by their slots, "
              f"{pod['expert_units_failed']} failed; "
              f"{pod['ici_bytes_saved']:,} gather bytes saved; shared "
              + ("skipped" if sh.get("skipped") else
                 f"{sh['filled']}/{sh['units']} units over "
                 f"{sh['slots']} slots"))
    elif pod and not pod.get("skipped"):
        print(f"  Pod round:  {pod['filled']}/{pod['units']} units over "
              f"{pod['slots']} slots, gather {pod['gather_s']}s")
    for line in _delta_lines(st):
        print(line)
    return 0


def _delta_lines(st: dict) -> list[str]:
    """The pull's delta and hot-swap lines, as the JAX package prints
    them."""
    out = []
    if "delta" in st:
        d = st["delta"]
        line = (f"  Delta:      {d['changed_bytes']} of "
                f"{d['total_bytes']} bytes changed vs "
                f"{d['base_revision'][:12]} "
                f"({d['delta_bytes_ratio']:.1%})")
        if "fetched_bytes" in d:
            line += f"; fetched {d['fetched_bytes']} bytes"
        if "tensors" in d:
            line += (f"; {d['tensors']['reused']} tensors reused, "
                     f"{d['tensors']['landed']} landed")
        out.append(line)
    if st.get("time_to_swap_s") is not None:
        out.append(f"  Hot swap:   tree swapped in {st['time_to_swap_s']}s")
    return out


def cmd_watch(args) -> int:
    from zest_tpu_torch.transfer.push import watch_and_swap

    cfg = Config.load()
    try:
        records = watch_and_swap(
            cfg, args.repo, publisher_url=args.publisher,
            device=args.device, base_revision=args.base,
            max_events=args.count, timeout_s=args.timeout,
            log=lambda *a, **k: print(*a, **{**k, "file": sys.stderr}))
    except (ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({"swaps": records}, indent=2))
        return 0 if records else 1
    for r in records:
        prop = r.get("propagation_s")
        print(f"swapped to {r['revision'][:12]} in {r['time_to_swap_s']} s"
              + (f", propagation {prop:.2f} s" if prop is not None else ""))
    if not records:
        print("watch ended with no revision events", file=sys.stderr)
        return 1
    return 0


def cmd_diff(args) -> int:
    from zest_tpu_torch.transfer import delta

    def parse_spec(spec: str) -> tuple[str, str]:
        repo, sep, rev = spec.partition("@")
        return (repo, rev) if sep and rev else (repo, "main")

    repo_a, rev_a = parse_spec(args.base)
    if args.push_preview:
        # zest diff REPO[@BASE] --push-preview DIR: what pushing DIR
        # would mint and dedup against the cached base, nothing written.
        from zest_tpu_torch.transfer import push as push_mod

        try:
            out = push_mod.preview_push(
                Config.load(), repo_a, args.push_preview,
                base_revision=rev_a if "@" in args.base else None)
        except (ValueError, OSError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(out, indent=2))
        else:
            print(f"push preview: {repo_a} <- {args.push_preview}")
            print(f"  base revision : {str(out['parent'])[:12] or '(none)'}")
            print(f"  files         : {out['files']} "
                  f"({out['xet_files']} xet)")
            print(f"  total bytes   : {out['total_bytes']:,}")
            print(f"  reused bytes  : {out['reused_bytes']:,}")
            print(f"  new xorbs     : {out['new_xorbs']} "
                  f"({out['new_xorb_bytes']:,} bytes)")
            print(f"  dedup ratio   : {out['dedup_ratio']:.4f}")
        return 0
    if args.target is None:
        repo_b, rev_b = repo_a, "main"
    elif "/" in args.target.partition("@")[0]:
        repo_b, rev_b = parse_spec(args.target)
    else:
        repo_b, rev_b = repo_a, args.target
    cfg = Config.load()
    try:
        cfg.model_cache_dir(repo_a)
        cfg.model_cache_dir(repo_b)
        out = delta.diff_revisions(cfg, repo_a, rev_a, repo_b, rev_b)
    except (ValueError, OSError, RuntimeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2) if args.json else delta.format_diff(out))
    return 0


def cmd_bench(args) -> int:
    from zest_tpu_torch import bench_suite

    results = bench_suite.run_synthetic(device=not args.no_device)
    print(bench_suite.format_results(results, as_json=args.json))
    return 0


def cmd_generate(args) -> int:
    from zest_tpu_torch.models.generate import (
        UnsupportedModelError,
        load_generator,
        try_tokenizer,
    )
    from zest_tpu_torch.transfer.pull import pull_model

    # Flag validation needs no pull: done before a possibly large
    # download (only the tokenizer lookup needs the snapshot).
    prompt = None
    if args.steps < 1:
        print(f"error: --steps must be positive (got {args.steps})",
              file=sys.stderr)
        return 2
    if args.ids:
        try:
            prompt = [int(t) for t in args.ids.split(",")]
        except ValueError:
            print(f"error: --ids {args.ids!r} is not a comma-separated list "
                  "of ints", file=sys.stderr)
            return 2
    elif args.prompt is None:
        print("error: one of --prompt or --ids is required", file=sys.stderr)
        return 2
    swarm = _swarm_for(args)
    try:
        res = pull_model(Config.load(), args.repo, revision=args.revision,
                         device=args.device, swarm=swarm,
                         no_p2p=args.no_p2p)
    finally:
        if swarm is not None:
            swarm.close()
    tok = try_tokenizer(res.snapshot_dir)
    if prompt is None:
        if tok is None:
            print("error: snapshot has no tokenizer; pass token ids via "
                  "--ids", file=sys.stderr)
            return 2
        prompt = tok.encode(args.prompt)
    try:
        model_type, generate = load_generator(
            res.snapshot_dir, device=args.device, tensors=res.params)
        res.params = None  # the generator holds the family's own tree
        out = generate(prompt, args.steps, temperature=args.temperature,
                       top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                       stop_at_eos=not args.ignore_eos)
    except (UnsupportedModelError, FileNotFoundError, ValueError) as exc:
        # ValueError: a context overflow, a top_p outside (0, 1] and kin:
        # a usage problem, not a crash.
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"[{model_type}] {len(prompt)} prompt + {len(out) - len(prompt)} "
          "new tokens")
    if tok is not None:
        print(tok.decode(list(out)))
    else:
        print(",".join(str(int(t)) for t in out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zest-tpu-torch",
        description="PyTorch/CUDA port of zest: push, pull, generate")
    sub = p.add_subparsers(dest="command", required=True)
    devices = ["cuda", "cpu"]

    push = sub.add_parser("push", help="publish a checkpoint dir as a new "
                                       "revision in the local cache")
    push.add_argument("repo")
    push.add_argument("checkpoint_dir")
    push.add_argument("--base", default=None,
                      help="base revision to dedup against (default: "
                           "refs/main)")
    push.add_argument("--device", choices=devices, default="cuda",
                      help="where minted chunks are re-verified")
    push.add_argument("--publisher", metavar="URL", default=None,
                      help="publisher to notify (default "
                           "http://127.0.0.1:ZEST_HTTP_PORT)")
    push.add_argument("--no-notify", action="store_true",
                      help="publish locally only; notify no watcher")
    push.add_argument("--json", action="store_true")
    push.set_defaults(fn=cmd_push)

    serve = sub.add_parser("serve", help="serve pushed revisions to pulls "
                                         "and seed the xorb cache")
    serve.add_argument("--host", default="127.0.0.1")
    serve.add_argument("--port", type=int, default=None,
                       help="default ZEST_HTTP_PORT (9847); 0 = ephemeral")
    serve.add_argument("--listen-port", type=int, default=None,
                       help="BT seeding port (default ZEST_LISTEN_PORT, "
                            "6881; 0 = ephemeral)")
    serve.add_argument("--dcn-port", type=int, default=None,
                       help="DCN chunk-RPC port (default ZEST_DCN_PORT, "
                            "6991; 0 = ephemeral)")
    serve.add_argument("--device", choices=devices, default="cuda",
                       help="where /v1/generate decodes")
    serve.add_argument("--tracker", metavar="URL", default=None,
                       help="HTTP tracker announce URL: pushed xorbs are "
                            "registered there too")
    serve.set_defaults(fn=cmd_serve)

    seed = sub.add_parser("seed", help="announce the cached xorbs to the "
                                       "swarm (DHT and --tracker)")
    seed.add_argument("--tracker", metavar="URL", default=None,
                      help="HTTP tracker announce URL")
    seed.set_defaults(fn=cmd_seed)

    models = sub.add_parser("models", help="pulled models (and, with "
                                           "--resident, the daemon's "
                                           "device-resident trees)")
    models.add_argument("--resident", action="store_true",
                        help="the trees the running daemon's serving pool "
                             "holds on its device")
    models.add_argument("--json", action="store_true")
    models.set_defaults(fn=cmd_models)

    def add_peer_flags(cmd) -> None:
        cmd.add_argument("--peer", action="append", metavar="HOST:PORT",
                         help="direct peer, asked before the CDN "
                              "(repeatable)")
        cmd.add_argument("--no-p2p", action="store_true",
                         help="no peer tier: cache and CDN only")

    pull = sub.add_parser("pull", help="download a model and land it on "
                                       "the device")
    pull.add_argument("repo")
    pull.add_argument("--revision", default="main")
    pull.add_argument("--device", choices=devices, default="cuda")
    coop = pull.add_mutually_exclusive_group()
    coop.add_argument("--coop", dest="coop", action="store_true",
                      default=None,
                      help="cooperative pull: fetch ~1/N of the CDN bytes "
                           "and exchange the rest with the other hosts "
                           "over DCN (auto when more than one host is "
                           "configured; also ZEST_COOP=1)")
    coop.add_argument("--no-coop", dest="coop", action="store_false")
    pull.add_argument("--coop-hosts", type=int, default=None,
                      help="hosts in the cooperative pull "
                           "(also ZEST_COOP_HOSTS)")
    pull.add_argument("--coop-index", type=int, default=None,
                      help="this host's index, 0-based "
                           "(also ZEST_COOP_INDEX)")
    pull.add_argument("--coop-addr", action="append", metavar="I=HOST:PORT",
                      help="DCN endpoint of coop host I (repeatable; also "
                           "ZEST_COOP_ADDRS)")
    pod = pull.add_mutually_exclusive_group()
    pod.add_argument("--pod", dest="pod", action="store_true", default=None,
                     help="run the pod round over every CUDA device "
                          "(default with --device cuda; also ZEST_TPU_POD)")
    pod.add_argument("--no-pod", dest="pod", action="store_false",
                     help="skip the pod round")
    pull.add_argument("--pods", type=int, default=None,
                      help="pods in a federated multi-pod pull (separate "
                           "processes linked over DCN)")
    pull.add_argument("--pod-index", type=int, default=None,
                      help="this process's pod index, 0-based")
    pull.add_argument("--pod-addr", action="append", metavar="I=HOST:PORT",
                      help="DCN endpoint of pod I (repeatable); units "
                           "owned by unreachable pods degrade to the CDN")
    add_peer_flags(pull)
    pull.add_argument("--tracker", metavar="URL", default=None,
                      help="HTTP tracker announce URL (peer discovery)")
    pull.add_argument("--no-dht", action="store_true",
                      help="skip DHT discovery (direct peers and tracker "
                           "only)")
    pull.add_argument("--tenant", default=None,
                      help="tenant label of the pull's session (default "
                           "ZEST_TENANT)")
    pull.set_defaults(fn=cmd_pull)

    start = sub.add_parser("start", help="start the daemon in the "
                                         "background")
    start.add_argument("--timeout", type=float, default=30.0,
                       help="seconds to wait for /v1/health")
    start.set_defaults(fn=cmd_start)
    sub.add_parser("stop", help="stop the daemon").set_defaults(fn=cmd_stop)
    sub.add_parser("status", help="print the daemon's status") \
        .set_defaults(fn=cmd_status)
    ps = sub.add_parser("ps", help="list the daemon's pull sessions "
                                   "(live and recent)")
    ps.add_argument("--json", action="store_true",
                    help="the raw /v1/pulls document")
    ps.add_argument("--watch", action="store_true",
                    help="redraw until Ctrl-C")
    ps.add_argument("--interval", type=float, default=1.0,
                    help="redraw interval in seconds")
    ps.add_argument("--count", type=int, default=0,
                    help="with --watch: stop after N frames")
    ps.set_defaults(fn=cmd_ps)
    heal = sub.add_parser(
        "heal", help="self-healing control plane: the remediation "
                     "engine's decisions, knob overrides, shed state")
    heal.add_argument("--json", action="store_true",
                      help="the raw /v1/remediations document")
    heal.add_argument("--watch", action="store_true",
                      help="redraw until Ctrl-C")
    heal.add_argument("--interval", type=float, default=1.0,
                      help="redraw interval in seconds")
    heal.add_argument("--count", type=int, default=0,
                      help="with --watch: stop after N frames")
    heal.add_argument("--limit", type=int, default=50,
                      help="recent decisions to fetch")
    heal.add_argument("--dry-run", choices=["on", "off"], default=None,
                      help="flip decision-only mode on the live engine")
    heal.set_defaults(fn=cmd_heal)
    top = sub.add_parser(
        "top", help="live view: session progress bars, tier rates, "
                    "queue, anomalies (/v1/timeline)")
    top.add_argument("--json", action="store_true",
                     help="one raw status + pulls + timeline document")
    top.add_argument("--interval", type=float, default=1.0,
                     help="redraw interval in seconds")
    top.add_argument("--count", type=int, default=0,
                     help="stop after N frames (0: until Ctrl-C)")
    top.set_defaults(fn=cmd_top)
    sub.add_parser("version", help="print the version") \
        .set_defaults(fn=cmd_version)

    stats = sub.add_parser("stats", help="print the daemon's metrics "
                                         "(Prometheus text)")
    stats.add_argument("--json", action="store_true",
                       help="the telemetry, faults and peer-health blocks "
                            "of /v1/status as JSON instead")
    stats.add_argument("--pod", action="store_true",
                       help="pod-scope sum (/v1/metrics?scope=pod)")
    stats.add_argument("--watch", action="store_true",
                       help="redraw over /v1/debug until Ctrl-C")
    stats.add_argument("--interval", type=float, default=1.0,
                       help="redraw interval in seconds")
    stats.add_argument("--count", type=int, default=0,
                       help="with --watch: stop after N frames")
    stats.set_defaults(fn=cmd_stats)
    debug = sub.add_parser("debug", help="dump the daemon's flight "
                                         "recorder and coop summary "
                                         "(/v1/debug)")
    debug.add_argument("--out", default=None, metavar="PATH",
                       help="write the JSON report here, not to stdout")
    debug.add_argument("--tail", type=int, default=100,
                       help="recorder events to include")
    debug.set_defaults(fn=cmd_debug)
    analyze = sub.add_parser("analyze", help="critical-path attribution "
                                             "over a trace export")
    analyze.add_argument("trace", metavar="TRACE.json",
                         help="a trace export (solo or merged)")
    analyze.add_argument("--json", action="store_true")
    analyze.add_argument("--host", default=None,
                         help="merged docs: analyze this host's spans "
                              "(default: the dominant pull's host)")
    analyze.add_argument("--top", type=int, default=8,
                         help="top blocking spans to list")
    analyze.set_defaults(fn=cmd_analyze)
    trace = sub.add_parser("trace", help="pull with the tracer on and "
                                         "write a Chrome trace")
    trace.add_argument("repo", nargs="?", default=None)
    trace.add_argument("--revision", default="main")
    trace.add_argument("--device", choices=devices, default="cuda")
    trace.add_argument("--out", default="zest-trace.json", metavar="PATH",
                       help="trace file (view at ui.perfetto.dev)")
    trace.add_argument("--no-p2p", action="store_true")
    trace.add_argument("--coop", action="store_true",
                       help="after the traced coop pull, gather every pod "
                            "peer's /v1/trace into one merged file")
    trace.add_argument("--peer-api", action="append", metavar="I=HOST:PORT",
                       help="pod peer HTTP endpoint for --coop "
                            "(repeatable; default ZEST_POD_PEERS)")
    trace.add_argument("--merge", nargs="+", default=None,
                       metavar="TRACE.json",
                       help="offline: merge per-host exports into --out")
    trace.set_defaults(fn=cmd_trace)

    gen = sub.add_parser("generate", help="pull a model and decode with it")
    gen.add_argument("repo")
    gen.add_argument("--revision", default="main")
    gen.add_argument("--prompt", default=None,
                     help="text prompt (needs a tokenizer in the snapshot)")
    gen.add_argument("--ids", default=None,
                     help="comma-separated prompt token ids")
    gen.add_argument("--steps", type=int, default=20,
                     help="new tokens to decode (default 20)")
    gen.add_argument("--temperature", type=float, default=0.0,
                     help="0 = greedy (default); >0 samples")
    gen.add_argument("--top-k", type=int, default=None,
                     help="restrict sampling to the k most likely tokens")
    gen.add_argument("--top-p", type=float, default=None,
                     help="nucleus sampling: restrict to the smallest set "
                          "of tokens with cumulative probability top_p")
    gen.add_argument("--seed", type=int, default=0,
                     help="sampling seed (default 0; a torch.Generator, so "
                          "not the JAX package's tokens for the same seed)")
    gen.add_argument("--device", choices=devices, default="cuda")
    gen.add_argument("--ignore-eos", action="store_true",
                     help="decode all --steps tokens even past the "
                          "model's eos_token_id")
    add_peer_flags(gen)
    gen.set_defaults(fn=cmd_generate)

    watch = sub.add_parser("watch", help="subscribe to a publisher and "
                                         "delta-pull + hot-swap each "
                                         "pushed revision")
    watch.add_argument("repo")
    watch.add_argument("--publisher", metavar="URL", default=None,
                       help="publisher base URL (default "
                            "http://127.0.0.1:ZEST_HTTP_PORT)")
    watch.add_argument("--device", choices=devices, default="cuda")
    watch.add_argument("--base", metavar="REV", default=None,
                       help="the revision already cached here (delta "
                            "evidence for the first pull)")
    watch.add_argument("--count", type=int, default=1,
                       help="stop after N revisions (0: until the stream "
                            "ends)")
    watch.add_argument("--timeout", type=float, default=120.0,
                       help="idle-stream timeout in seconds")
    watch.add_argument("--json", action="store_true")
    watch.set_defaults(fn=cmd_watch)

    diff = sub.add_parser("diff", help="chunk-level delta between two "
                                       "revisions (metadata only)")
    diff.add_argument("base", metavar="REPO@REV",
                      help="base revision (what is cached here)")
    diff.add_argument("target", metavar="[REPO@]REV", nargs="?",
                      default=None,
                      help="target revision (default: the base repo's "
                           "main)")
    diff.add_argument("--json", action="store_true")
    diff.add_argument("--push-preview", metavar="DIR", default=None,
                      help="the would-be dedup outcome of pushing DIR "
                           "against REPO[@REV], nothing written")
    diff.set_defaults(fn=cmd_diff)

    bench = sub.add_parser("bench", help="run the synthetic benchmark "
                           "suite (host benches, then the device benches "
                           "on cuda)")
    bench.add_argument("--json", action="store_true")
    bench.add_argument("--no-device", action="store_true",
                       help="the host benches only")
    bench.add_argument("--synthetic", action="store_true",
                       help="accepted for the reference CLI (the default)")
    bench.set_defaults(fn=cmd_bench)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)

"""``python -m zest_tpu_torch {push,serve,pull,generate,watch,diff,models}``.

The push → pull → generate subset of ``zest_tpu/cli.py``, on ``cuda`` by
default (``--device cpu`` runs on the CPU). ``serve`` starts the
publisher endpoint that a second node's ``pull`` points at
(``HF_ENDPOINT=http://host:port``), and seeds this node's xorb cache: a
BT-wire ``BtServer`` (``--listen-port``, ``ZEST_LISTEN_PORT``, 6881) and
a ``DcnServer`` (``--dcn-port``) share one peer-health book with the
node's swarm. ``pull --peer HOST:PORT`` (repeatable) asks those peers
before the CDN; ``--no-p2p`` turns the peer tier off. ``pull --coop
--coop-hosts N --coop-index I --coop-addr J=HOST:PORT ...`` runs the
cooperative pull: this host fetches its ~1/N of the xorbs and the
others' shares come over the DCN chunk RPC (its listener is
``ZEST_DCN_PORT``, 6991 by default), the collective exchange first
(``ZEST_COOP_COLLECTIVE=0`` keeps to the point-to-point one); ``--pod``
/ ``--no-pod`` force the pod round over every CUDA device on or off (on
by default with ``--device cuda``).
``push`` notifies the publisher (``--publisher URL``, default the local
``ZEST_HTTP_PORT``) unless ``--no-notify``; ``watch REPO --publisher URL``
delta-pulls and swaps each pushed revision; ``diff REPO@A [REV_B]``
prints the chunk-level delta from metadata alone. ``generate REPO --ids
... | --prompt TEXT`` pulls and decodes a GPT-2 or Llama-family model,
greedy or sampled (``--temperature``, ``--top-k``, ``--top-p``,
``--seed``). ``serve`` also answers ``POST /v1/generate`` from the
serving pool on ``--device`` (``cuda`` by default), with ``/v1/health``,
``/v1/status``, ``/v1/models``, ``/v1/metrics`` and ``/v1/stop``;
``models [--resident] [--json]`` lists the pulled models, through the
running daemon's ``/v1/models`` when there is one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import sys
import threading

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


def _daemon_get(cfg: Config, path: str, timeout: float = 2.0) -> dict | None:
    """GET a local daemon endpoint (``cfg.effective_http_port()``); None
    on any failure: no daemon, or an answer that is not a JSON object."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{cfg.effective_http_port()}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            payload = json.loads(r.read().decode())
    except (OSError, urllib.error.URLError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


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
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    cfg = Config.load()
    if args.listen_port is not None:
        cfg.listen_port = args.listen_port
    if args.dcn_port is not None:
        cfg.dcn_port = args.dcn_port
    port = cfg.http_port if args.port is None else args.port
    # One health book for the node: the seeder's reciprocity ranking,
    # stalled-reader strikes and quarantine oracle read what the node's
    # swarm writes.
    health = HealthRegistry()
    swarm = SwarmDownloader(cfg, health=health)
    bt = BtServer(cfg, health=health)
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    dcn = None
    server = None
    try:
        bt_port = bt.start()
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
        # The serving routes pull through this node's swarm.
        server = PublisherServer(cfg, host=args.host, port=port,
                                 device=args.device, swarm=swarm,
                                 bt_server=bt).start()
        bound = server.api.port
        try:
            storage.atomic_write(cfg.http_port_file(), str(bound).encode())
        except OSError:
            pass  # only `models` of a port-0 daemon reads it
        print(f"publisher endpoint at {server.url}", flush=True)
        print(f"serving /v1/generate on {args.device}", flush=True)
        try:
            # SIGTERM, or POST /v1/stop.
            while not (stop.wait(0.5) or server.api.shutdown_event.is_set()):
                pass
        except KeyboardInterrupt:
            pass
    finally:
        if server is not None:
            server.close()
        pool_mod = sys.modules.get("zest_tpu_torch.models.hbm_pool")
        if pool_mod is not None:
            pool_mod.reset()  # evict what the pool holds
        if dcn is not None:
            dcn.shutdown()
        bt.shutdown()
        swarm.close()
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


def _swarm_for(args):
    """The pull's peer tier from ``--peer``/``--no-p2p``: None for
    ``--no-p2p``, else a swarm over the direct peers. A swarm that cannot
    be built leaves the pull CDN-only, said on stderr."""
    if args.no_p2p:
        return None
    from zest_tpu_torch.p2p.peer import parse_address
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    try:
        swarm = SwarmDownloader(Config.load())
        for spec in args.peer or []:
            swarm.add_direct_peer(*parse_address(spec))
    except (OSError, ValueError) as exc:
        print(f"p2p unavailable ({exc}); continuing CDN-only",
              file=sys.stderr)
        return None
    return swarm


def cmd_pull(args) -> int:
    from zest_tpu_torch.transfer.pull import pull_model

    try:
        coop_addrs = dict(parse_host_addr(a) for a in args.coop_addr or [])
    except ValueError as exc:
        print(f"error: --coop-addr: {exc}", file=sys.stderr)
        return 2
    swarm = _swarm_for(args)
    try:
        res = pull_model(Config.load(), args.repo, revision=args.revision,
                         device=args.device, coop=args.coop,
                         coop_hosts=args.coop_hosts,
                         coop_index=args.coop_index, coop_addrs=coop_addrs,
                         swarm=swarm, no_p2p=args.no_p2p, pod=args.pod)
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
    pod = st.get("pod")
    if pod and not pod.get("skipped"):
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
    serve.set_defaults(fn=cmd_serve)

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
    add_peer_flags(pull)
    pull.set_defaults(fn=cmd_pull)

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
    diff.set_defaults(fn=cmd_diff)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)

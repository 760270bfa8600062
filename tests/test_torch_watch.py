"""The port's push fan-out and watch subscriber, on the CPU.

- the publisher's ``WatchHub`` and ``/v1/push`` notification give the
  JAX package's ``WatchHub`` and ``HttpApi.push_notify`` event shapes
  (``hello``, ``revision``, ``ping``) and answers;
- a push with ``notify=True`` wakes a ``/v1/watch`` subscriber over
  HTTP; ``ZEST_WATCH=0`` answers watch with 404 and a malformed notice
  with 400;
- ``watch_and_swap(device="cpu", max_events=2)`` chains A → B → C: each
  event's tree is the next event's base (its unchanged tensors are the
  previous tree's objects), and each digest equals a cold pull of that
  revision;
- the CLI's ``push --no-notify`` and ``watch`` do the same through
  ``Config.load()``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from zest_tpu.api import http_api as j_http_api
from zest_tpu.config import Config as JConfig
from zest_tpu_torch.api.http_api import PublisherServer, WatchHub, push_notify
from zest_tpu_torch.config import Config
from zest_tpu_torch.models.loader import load_checkpoint, params_digest
from zest_tpu_torch.models.safetensors_io import write_safetensors
from zest_tpu_torch.transfer import push as push_mod
from zest_tpu_torch.transfer.pull import pull_model
from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

REPO = "acme/watch"
E, L, V = 128, 2, 256


def _quiet(*a, **k):
    pass


def _checkpoint(root, seed: int, redraw: tuple = (), redraw_seed: int = 0):
    """A small GPT-2 checkpoint dir from ``seed``; the ``redraw`` tensors
    drawn again from ``redraw_seed`` (a fine-tune of those tensors)."""
    rng = np.random.default_rng(seed)
    t = {"wte.weight": rng.normal(0, 0.02, (V, E)),
         "wpe.weight": rng.normal(0, 0.01, (64, E)),
         "ln_f.weight": np.ones(E), "ln_f.bias": np.zeros(E)}
    for i in range(L):
        for leaf, shape in (("ln_1.weight", (E,)), ("ln_1.bias", (E,)),
                            ("attn.c_attn.weight", (E, 3 * E)),
                            ("attn.c_attn.bias", (3 * E,)),
                            ("attn.c_proj.weight", (E, E)),
                            ("attn.c_proj.bias", (E,)),
                            ("ln_2.weight", (E,)), ("ln_2.bias", (E,)),
                            ("mlp.c_fc.weight", (E, 4 * E)),
                            ("mlp.c_fc.bias", (4 * E,)),
                            ("mlp.c_proj.weight", (4 * E, E)),
                            ("mlp.c_proj.bias", (E,))):
            t[f"h.{i}.{leaf}"] = rng.normal(0, 0.02, shape)
    fine = np.random.default_rng(redraw_seed)
    for name in redraw:
        t[name] = fine.normal(0, 0.02, t[name].shape)
    root.mkdir(parents=True)
    (root / "config.json").write_text(json.dumps(dict(
        model_type="gpt2", vocab_size=V, n_positions=64, n_ctx=64, n_embd=E,
        n_layer=L, n_head=4, layer_norm_epsilon=1e-5)))
    write_safetensors(root / "model.safetensors",
                      {k: v.astype(np.float32) for k, v in t.items()})
    return root


def _node(root, name, **kw) -> Config:
    return Config(hf_home=root / name / "hf", cache_dir=root / name / "zest",
                  **kw)


# ── The hub and the notification, against the JAX package's ──


def test_watch_hub_and_push_notify_match_reference():
    req = {"repo": REPO, "revision": "b" * 40, "parent": "a" * 40,
           "pushed_at": 1234.5, "dedup_ratio": 0.97, "new_xorb_bytes": 4096,
           "xorbs": [["ab" * 32, 4096]]}
    hub = WatchHub(ping_s=0.05)
    api = j_http_api.HttpApi(JConfig(hf_home="/nonexistent/hf",
                                     cache_dir="/nonexistent/zest"))
    try:
        mine = hub.subscribe([REPO])
        theirs = api.watch_hub.subscribe([REPO], ping_s=0.05)
        other = hub.subscribe(["acme/other"])
        their_other = api.watch_hub.subscribe(["acme/other"])
        assert next(mine) == next(theirs) == {"event": "hello",
                                              "watching": [REPO]}
        assert next(other) == next(their_other)
        assert push_notify(hub, req) == api.push_notify(req) == {
            "ok": True, "watchers": 2, "delivered": 1}
        ev = next(mine)
        assert ev == next(theirs)
        assert ev["event"] == "revision" and ev["revision"] == "b" * 40
        assert next(mine) == next(theirs) == {"event": "ping"}
        for bad in ({"repo": REPO}, {"repo": REPO, "revision": "x",
                                     "xorbs": [["ab", "n"]]}):
            with pytest.raises(ValueError):
                push_notify(hub, bad)
            with pytest.raises(ValueError):
                api.push_notify(bad)
        mine.close()
        assert hub.watchers() == 1
        hub.close()
        assert list(other) == []  # a closed hub ends the stream
    finally:
        theirs.close()
        their_other.close()
        api.close()


def test_push_notify_wakes_a_watcher_over_http(tmp_path):
    cfg_a = _node(tmp_path, "a")
    with PublisherServer(cfg_a) as server:
        events = push_mod.watch_events(server.url, repos=[REPO],
                                       timeout_s=30)
        assert next(events) == {"event": "hello", "watching": [REPO]}
        assert server.hub.watchers() == 1
        pushed = push_checkpoint(cfg_a, REPO, _checkpoint(tmp_path / "ck", 1),
                                 device="cpu", notify_url=server.url,
                                 log=_quiet)
        assert pushed.notified == {"ok": True, "watchers": 1,
                                   "delivered": 1}
        ev = next(events)
        assert ev["event"] == "revision" and ev["repo"] == REPO
        assert ev["revision"] == pushed.revision and ev["parent"] is None
        assert ev["new_xorb_bytes"] == pushed.new_xorb_bytes
        events.close()
    # No publisher: the push lands and reports no notification.
    again = push_checkpoint(cfg_a, REPO, _checkpoint(tmp_path / "ck2", 2),
                            device="cpu", notify_url=server.url, log=_quiet)
    assert again.notified is None and again.revision != pushed.revision


def test_watch_events_end_on_a_quiet_timeout(tmp_path):
    """A read timeout ends the stream (the reference's documented
    behaviour; its generator raises instead), as the publisher's close
    does."""
    with PublisherServer(_node(tmp_path, "a")) as server:
        server.hub.ping_s = 60.0
        events = push_mod.watch_events(server.url, [REPO], timeout_s=0.3)
        assert next(events)["event"] == "hello"
        t0 = time.monotonic()
        assert list(events) == []
        assert time.monotonic() - t0 < 10
        closing = push_mod.watch_events(server.url, [REPO], timeout_s=30)
        assert next(closing)["event"] == "hello"
    assert list(closing) == []


def test_watch_off_answers_404_and_bad_notice_400(tmp_path):
    with PublisherServer(_node(tmp_path, "a", watch_enabled=False)) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            next(push_mod.watch_events(srv.url, [REPO], timeout_s=10))
        assert ei.value.code == 404
        assert push_mod.notify_daemon(
            Config(hf_home=tmp_path, cache_dir=tmp_path),
            {"repo": REPO, "revision": "x" * 40}, url=srv.url) == {
            "ok": True, "watchers": 0, "delivered": 0}
        req = urllib.request.Request(
            srv.url + "/v1/push", data=b'{"repo": "acme/watch"}',
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400


# ── The subscriber: A → B → C ──


def _wait_for_watchers(server, n=1, timeout=30.0):
    deadline = time.monotonic() + timeout
    while server.hub.watchers() < n:
        assert time.monotonic() < deadline, "the watcher never subscribed"
        time.sleep(0.02)


def test_watch_and_swap_chains_two_pushed_revisions(tmp_path):
    cfg_a = _node(tmp_path, "a")
    ck_a = _checkpoint(tmp_path / "ck_a", 3)
    ck_b = _checkpoint(tmp_path / "ck_b", 3, ("h.1.mlp.c_fc.weight",
                                              "ln_f.bias"), 11)
    ck_c = _checkpoint(tmp_path / "ck_c", 3, ("h.1.mlp.c_fc.weight",
                                              "ln_f.bias",
                                              "h.0.attn.c_proj.weight"), 12)
    sha_a = push_checkpoint(cfg_a, REPO, ck_a, device="cpu",
                            log=_quiet).revision
    with PublisherServer(cfg_a) as server:
        cfg_s = _node(tmp_path, "s", endpoint=server.url)
        tree = pull_model(cfg_s, REPO, device="cpu", log=_quiet).params
        seen, errors, records = [], [], []

        def on_swap(record, result):
            seen.append((record, result.stats, dict(result.params)))

        def watch():
            try:
                records.extend(watch_and_swap(
                    cfg_s, REPO, publisher_url=server.url, device="cpu",
                    base_params=tree, base_revision=sha_a, max_events=2,
                    timeout_s=60, on_swap=on_swap, log=_quiet))
            except Exception as exc:  # noqa: BLE001 - asserted below
                errors.append(exc)

        a_tree = dict(tree)
        t = threading.Thread(target=watch)
        t.start()
        _wait_for_watchers(server)
        sha_b = push_checkpoint(cfg_a, REPO, ck_b, base_revision=sha_a,
                                device="cpu", notify_url=server.url,
                                log=_quiet).revision
        sha_c = push_checkpoint(cfg_a, REPO, ck_c, base_revision=sha_b,
                                device="cpu", notify_url=server.url,
                                log=_quiet).revision
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        colds = {sha: pull_model(_node(tmp_path, f"cold-{sha[:6]}",
                                       endpoint=server.url), REPO,
                                 revision=sha, device="cpu",
                                 log=_quiet).params
                 for sha in (sha_b, sha_c)}
    assert [r["revision"] for r in records] == [sha_b, sha_c]
    assert [r["parent"] for r in records] == [sha_a, sha_b]
    assert all(r["time_to_swap_s"] > 0 and r["propagation_s"] >= 0
               for r in records)
    assert not tree, "the first base is consumed"
    prev = a_tree
    for (record, stats, params), sha, ck in zip(seen, (sha_b, sha_c),
                                               (ck_b, ck_c)):
        assert stats["revision"] == sha
        assert stats["delta"]["base_revision"] == record["parent"]
        assert stats["time_to_swap_s"] == record["time_to_swap_s"]
        reused = {n for n, t in params.items() if prev.get(n) is t}
        assert len(reused) == stats["hbm"]["swap"]["reused_tensors"] > 0
        assert params_digest(params) == params_digest(colds[sha]) == \
            params_digest(load_checkpoint(ck, "cpu"))
        prev = params


def test_cli_push_no_notify_and_watch(tmp_path, monkeypatch, capsys):
    from zest_tpu_torch import cli

    cfg_a = _node(tmp_path, "a")
    ck_a = _checkpoint(tmp_path / "ck_a", 5)
    ck_b = _checkpoint(tmp_path / "ck_b", 5, ("h.0.mlp.c_proj.weight",), 6)
    monkeypatch.setenv("HF_HOME", str(cfg_a.hf_home))
    monkeypatch.setenv("ZEST_CACHE_DIR", str(cfg_a.cache_dir))
    assert cli.main(["push", REPO, str(ck_a), "--device", "cpu",
                     "--no-notify", "--json"]) == 0
    sha_a = json.loads(capsys.readouterr().out)["revision"]
    with PublisherServer(cfg_a) as server:
        cfg_s = _node(tmp_path, "s", endpoint=server.url)
        pull_model(cfg_s, REPO, device="cpu", log=_quiet)
        out: list = []
        t = threading.Thread(target=lambda: out.append(cli.main(
            ["watch", REPO, "--publisher", server.url, "--device", "cpu",
             "--base", sha_a, "--count", "1", "--timeout", "60",
             "--json"])))
        monkeypatch.setenv("HF_HOME", str(cfg_s.hf_home))
        monkeypatch.setenv("ZEST_CACHE_DIR", str(cfg_s.cache_dir))
        t.start()
        _wait_for_watchers(server)
        pushed = push_checkpoint(cfg_a, REPO, ck_b, base_revision=sha_a,
                                 device="cpu", notify_url=server.url,
                                 log=_quiet)
        t.join(timeout=120)
    assert out == [0]
    swaps = json.loads(capsys.readouterr().out)["swaps"]
    assert [s["revision"] for s in swaps] == [pushed.revision]
    snap = cfg_s.model_snapshot_dir(REPO, pushed.revision)
    assert (snap / "model.safetensors").read_bytes() == (
        ck_b / "model.safetensors").read_bytes()

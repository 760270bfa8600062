"""The general generator: one runner for each kind of traffic.

A traffic file (``traffic/<mix>.json``) names its ``kind`` and the
parameters the kind reads; a cell is a configuration under a mix. Every
kind builds the configuration's checkpoint from the seed, publishes it
through the loopback hub (``hub.py``), runs an untimed step of its own
kind in set-up, then the measured window; the program's outputs are
judged by ``reference.py`` after each step's measured interval or after
the window.

- ``land``: the xorb cache is warm (the filling pull in set-up) and there
  are no peers. Each step removes the snapshot and releases the last
  tree, then calls ``pull_model`` on the device: the direct landing
  decodes the cache into the ring and commits, and writes the snapshot's
  file. ``steps`` paced steps.
- ``restart``: the snapshot is complete, so each step lands it from disk
  (disk staging), as a restarted serving node does. Back to back for the
  window; nothing is written.
- ``swap``: revision B is A with ``mutate_fraction`` of its bytes XORed
  in seeded runs. Each step hot-swaps a resident tree of A to B. Before
  it, outside the measured interval, A is landed again from its complete
  snapshot (which writes nothing), B's snapshot is removed (else the
  swap takes the disk-staging path) and so are the cache entries of the
  xorbs that only B holds, so that every swap fetches its delta from the
  CDN. (Swapping back B→A would fetch nothing: B still references every
  xorb of A.) ``steps`` paced steps.
- ``serve``: one tree resident in the ``HbmPool``; ``clients`` in-process
  clients in a closed loop call ``generate_for`` (``/v1/generate``
  without HTTP), greedy, no stop at EOS. Prompt lengths come from one
  fixed log-uniform grid that every seed shares: each round of requests
  sends every length once, in a seeded order.

Each runner leaves what the per-layer readers read in :class:`Record`.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np

from portbench import checkpoints, flops, pacing, reference
from portbench.trace import Tracer, maybe


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers."""

    seconds: float = 0.0
    steps: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    trace: dict | None = None
    window_flops: float = 0.0
    window_start: float = 0.0


def _quiet(*_a, **_k) -> None:
    pass


class Cell:
    """A cell's runner: ``setup()``, ``window()``, ``close_program()``,
    then ``judge()``."""

    REPO = "portbench/model"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 work: Path):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.work = Path(work)
        self.record = Record()
        self.hub = None
        self.setup_parts: dict[str, float] = {}
        self._t_part = time.perf_counter()
        # What the run wrote, counted from its files (``pacing``).
        self.writes = {"setup": 0, "window": 0}
        self._disk = pacing.file_states(self.work)

    def count_writes(self, phase: str) -> None:
        """Book the files written since the last count under ``phase``
        (``setup`` or ``window``); called before anything is removed."""
        now = pacing.file_states(self.work)
        self.writes[phase] += pacing.written(self._disk, now)
        self._disk = now

    def cap_bytes(self) -> int:
        return int(float(self.traffic["write_cap_gib"]) * pacing.GIB)

    def _part(self, name: str) -> None:
        """Book the set-up time since the last part under ``name``."""
        now = time.perf_counter()
        self.setup_parts[name] = now - self._t_part
        self._t_part = now

    # ── shared set-up ──

    def _publish(self) -> None:
        from portbench.hub import FixtureHub, FixtureRepo
        from zest_tpu_torch.config import Config

        data = checkpoints.draw(self.cfg, self.seed, self.device)
        self.files_a = checkpoints.repo_files(self.cfg, data)
        self._part("draw")
        self.blob_a = self.files_a["model.safetensors"]
        self.repo = FixtureRepo(
            self.REPO, self.files_a,
            chunks_per_xorb=int(self.traffic.get("chunks_per_xorb", 0)))
        self.sha_a = self.repo.commit_sha
        self.data_a = data
        self._part("publish")
        self.hub = FixtureHub(self.repo).__enter__()
        self.zcfg = Config(hf_home=self.work / "hf",
                           cache_dir=self.work / "zest",
                           hf_token="hf_portbench", endpoint=self.hub.url)

    def _pull(self, revision: str, **kw):
        from zest_tpu_torch.transfer.pull import pull_model

        return pull_model(self.zcfg, self.REPO, revision=revision,
                          device=self.device, no_p2p=True, log=_quiet, **kw)

    def _sync(self) -> None:
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def close(self) -> None:
        if self.hub is not None:
            self.hub.__exit__(None, None, None)
            self.hub = None


class _PullCell(Cell):
    """The landing kinds: ``land``, ``restart`` and ``swap``."""

    def _staging(self):
        """A pinned host buffer as large as the largest tensor, through
        which the judge reads a landed tensor back."""
        import torch

        _, entries = reference.read_safetensors(self.blob_a)
        biggest = max(hi - lo for _, _, lo, hi in entries.values())
        pin = torch.device(self.device).type == "cuda"
        return torch.empty(biggest, dtype=torch.uint8, pin_memory=pin)

    def _snapshot(self, sha: str) -> Path:
        return self.zcfg.model_snapshot_dir(self.REPO, sha)

    def _timed_pull(self, tracer, k: int, revision: str, **kw) -> dict:
        """One measured step. ``hbm_s`` is the host clock from the call
        to the close of the program's last ``stage.hbm_commit`` span,
        where every tensor is resident; the files lane's tail after it
        (the snapshot's fsync and rename) is not the step's. ``wall_s``
        is the whole call, synchronised."""
        from zest_tpu_torch.telemetry import trace as ztrace

        spans = ztrace.install()  # fresh each step: the span count stays small
        try:
            with maybe(tracer, f"step_{k}"):
                t0 = time.monotonic()
                res = self._pull(revision, **kw)
                self._sync()
                wall = time.monotonic() - t0
        finally:
            ztrace.uninstall()
        ends = [s.t1 for s in spans.spans()
                if s.name == "stage.hbm_commit" and s.t0 >= t0]
        if not ends:
            raise RuntimeError(f"step {k} closed no stage.hbm_commit span")
        self.result = res
        return {"hbm_s": max(ends) - t0, "wall_s": wall, "stats": res.stats,
                "t0": t0}

    def _judge_step(self, tracer, k: int, tree: dict, blob: bytes) -> int:
        with maybe(tracer, f"judge_{k}"):
            got = reference.judge_tree(tree, blob, self.staging)
        return got["bad_bytes"]

    def _between(self, tracer, k: int) -> None:
        """Outside every measured interval: drop garbage and let the
        disk's write-back finish, so the next step starts on a quiet
        host."""
        with maybe(tracer, f"between_{k}"):
            gc.collect()
            os.sync()
            self._disk = pacing.present(self._disk)

    def _check_cap(self) -> None:
        """Refuse a paced mix whose steps, each writing the snapshot's
        file, would take the run past its cap after what the set-up
        wrote."""
        cap, steps = self.cap_bytes(), int(self.traffic["steps"])
        if steps > pacing.max_steps(len(self.blob_a), cap,
                                    self.writes["setup"]):
            raise ValueError(
                f"{steps} steps of {len(self.blob_a)} B do not fit the "
                f"{cap} B write cap after {self.writes['setup']} B of set-up")

    def judge(self, control: bool = False) -> dict:
        """``bad_bytes`` over every timed step's tree. With ``control``
        the reference's tree one precision below the published one takes
        the program's place in ``bad_bytes``, and the program's count is
        kept as ``program_bad_bytes``."""
        bad = sum(s["bad_bytes"] for s in self.record.steps)
        if not control:
            return {"bad_bytes": bad}
        blob = self.expected()
        ctl = reference.control_tree(blob, self.device)
        out = {"bad_bytes": reference.judge_tree(ctl, blob)["bad_bytes"],
               "program_bad_bytes": bad}
        del ctl
        return out

    def expected(self) -> bytes:
        """The published bytes a timed step's tree is held to."""
        return self.blob_a

    def end_to_end(self) -> dict:
        return {self.METRIC: float(np.mean([s["hbm_s"]
                                            for s in self.record.steps]))}

    def close_program(self) -> None:
        self.result = self.tree = None
        gc.collect()


class LandCell(_PullCell):
    METRIC = "time_to_hbm_s"

    def setup(self) -> None:
        self._publish()
        self.staging = self._staging()
        # The filling pull: a cold landing fills the xorb cache.
        res = self._pull(self.sha_a)
        del res
        self.count_writes("setup")
        self._prepare()
        self._part("fill")
        self._timed_pull(None, -1, self.sha_a)  # the untimed step
        self.count_writes("setup")
        self._prepare()
        self._check_cap()
        self._part("warm")

    def _prepare(self) -> None:
        self.result = None
        shutil.rmtree(self._snapshot(self.sha_a), ignore_errors=True)
        self._between(None, -1)

    def window(self, seconds: float, tracer: Tracer | None) -> None:
        steps = int(self.traffic["steps"])
        if tracer is not None:
            tracer.start()
        t_w = time.monotonic()
        for k, due in enumerate(pacing.schedule(t_w, seconds, steps)):
            with maybe(tracer, "wait"):
                time.sleep(max(0.0, due - time.monotonic()))
            step = self._timed_pull(tracer, k, self.sha_a)
            step["late_s"] = step["t0"] - due
            step["bad_bytes"] = self._judge_step(
                tracer, k, self.result.params, self.blob_a)
            self.record.steps.append(step)
            self.result = None
            with maybe(tracer, f"between_{k}"):
                self.count_writes("window")
                shutil.rmtree(self._snapshot(self.sha_a), ignore_errors=True)
            self._between(tracer, k)
        if tracer is not None:
            tracer.stop()
        self.record.seconds = max(seconds, time.monotonic() - t_w)


class RestartCell(LandCell):
    def setup(self) -> None:
        self._publish()
        self.staging = self._staging()
        # A files-only pull writes the complete snapshot.
        self._pull(self.sha_a, land=False)
        self._part("fill")
        self._timed_pull(None, -1, self.sha_a)  # the untimed step
        self.result = None
        self._between(None, -1)
        self.count_writes("setup")
        self._part("warm")

    def window(self, seconds: float, tracer: Tracer | None) -> None:
        if tracer is not None:
            tracer.start()
        t_w = time.monotonic()
        k = 0
        while time.monotonic() < t_w + seconds:
            step = self._timed_pull(tracer, k, self.sha_a)
            step["late_s"] = 0.0
            step["bad_bytes"] = self._judge_step(
                tracer, k, self.result.params, self.blob_a)
            self.record.steps.append(step)
            self.result = None
            with maybe(tracer, f"between_{k}"):
                gc.collect()
            k += 1
        if tracer is not None:
            tracer.stop()
        self.record.seconds = time.monotonic() - t_w
        self.count_writes("window")  # the steps remove nothing


class SwapCell(_PullCell):
    METRIC = "time_to_swap_s"

    def setup(self) -> None:
        self._publish()
        self.staging = self._staging()
        frac = float(self.traffic["mutate_fraction"])
        data_b = checkpoints.mutate(self.cfg, self.data_a, frac, self.seed)
        files_b = checkpoints.repo_files(self.cfg, data_b)
        self.sha_b = self.repo.add_revision(files_b)
        # The xorbs that B alone holds: its delta. Evicted before every
        # swap, so that each one fetches the delta from the CDN.
        self.only_b = (self.repo.xorbs_of(self.sha_b)
                       - self.repo.xorbs_of(self.sha_a))
        if not self.only_b:
            raise ValueError("revision B minted no xorb of its own")
        self._part("publish_b")
        res = self._pull(self.sha_a)  # A's cache, snapshot and manifest
        del res
        self._reset("setup")
        self._part("fill")
        self._swap(None, -1)  # the untimed step
        self._reset("setup")
        self._check_cap()
        self._part("warm")

    def _reset(self, phase: str) -> None:
        """Outside the measured interval: A resident again, landed from
        its complete snapshot (which writes nothing), B's snapshot and
        B's own xorbs gone. What was written since the last count is
        booked under ``phase`` first."""
        self.tree = self.result = None
        gc.collect()
        self.tree = self._pull(self.sha_a).params
        self.count_writes(phase)
        shutil.rmtree(self._snapshot(self.sha_b), ignore_errors=True)
        xdir = self.zcfg.xorb_cache_dir()
        for h in self.only_b:
            for p in (xdir / h[:2]).glob(h + "*"):
                p.unlink()
        self._between(None, -1)

    def _swap(self, tracer, k: int) -> dict:
        sent0 = self.hub.xorb_bytes_sent
        step = self._timed_pull(tracer, k, self.sha_b, base_params=self.tree,
                                base_revision=self.sha_a)
        step["hub_bytes"] = self.hub.xorb_bytes_sent - sent0
        if "time_to_swap_s" not in step["stats"]:
            raise RuntimeError(f"step {k} landed without a hot-swap")
        if step["hub_bytes"] <= 0:
            raise RuntimeError(f"swap step {k} fetched nothing from the hub: "
                               "B's xorbs were still cached")
        self.tree, self.result = self.result.params, None
        return step

    def window(self, seconds: float, tracer: Tracer | None) -> None:
        steps = int(self.traffic["steps"])
        if tracer is not None:
            tracer.start()
        t_w = time.monotonic()
        for k, due in enumerate(pacing.schedule(t_w, seconds, steps)):
            with maybe(tracer, "wait"):
                time.sleep(max(0.0, due - time.monotonic()))
            step = self._swap(tracer, k)
            step["late_s"] = step["t0"] - due
            step["bad_bytes"] = self._judge_step(tracer, k, self.tree,
                                                 self.expected())
            self.record.steps.append(step)
            with maybe(tracer, f"between_{k}"):
                self._reset("window")
        if tracer is not None:
            tracer.stop()
        self.record.seconds = max(seconds, time.monotonic() - t_w)

    def expected(self) -> bytes:
        """Revision B as the reference derives it from A's published
        bytes by itself."""
        if not hasattr(self, "_ref_b"):
            self._ref_b = reference.apply_delta(
                self.blob_a, float(self.traffic["mutate_fraction"]),
                self.seed)
        return self._ref_b

class ServeCell(Cell):
    def lengths(self) -> list[int]:
        """The fixed log-uniform grid of prompt lengths every seed
        shares."""
        t = self.traffic
        lo, hi, n = t["prompt_min"], t["prompt_max"], t["lengths"]
        return [int(round(lo * (hi / lo) ** (i / (n - 1)))) for i in range(n)]

    def setup(self) -> None:
        from zest_tpu_torch.models.hbm_pool import HbmPool

        self._publish()
        res = self._pull(self.sha_a, land=False)
        self.snapshot = res.snapshot_dir
        self._part("fill")
        self.pool = HbmPool(self.zcfg, device=self.device)
        rng = np.random.default_rng([self.seed, 5])
        grid = self.lengths()
        # Each round of requests sends every length of the grid once, in
        # a seeded order: every seed does the same work.
        rounds = int(self.traffic["rounds"])
        self.order = [grid[i] for _ in range(rounds)
                      for i in rng.permutation(len(grid))]
        self.rng = rng
        vocab = self.cfg["vocab_size"]
        # Land the tree and warm every prompt length this traffic sends.
        for n0 in grid:
            self.pool.generate_for(self.snapshot, self.REPO,
                                   rng.integers(0, vocab, n0).tolist(), 2,
                                   stop_at_eos=False)
        self._sync()
        self.count_writes("setup")
        self._part("warm")

    def window(self, seconds: float, tracer: Tracer | None) -> None:
        t = self.traffic
        steps = int(t["new_tokens"])
        vocab = self.cfg["vocab_size"]
        lock = threading.Lock()
        counter = [0]
        reqs: list[dict] = []
        prompts = [self.rng.integers(0, vocab, n).tolist()
                   for n in self.order]

        if tracer is not None:
            tracer.start()
        t_w = time.perf_counter()
        t_end = t_w + seconds

        def client() -> None:
            while time.perf_counter() < t_end:
                with lock:
                    r = counter[0]
                    counter[0] += 1
                prompt = prompts[r % len(prompts)]
                times: list[float] = []
                rec = {"n0": len(prompt), "times": times, "t_start":
                       time.perf_counter(), "error": None}
                try:
                    out, info = self.pool.generate_for(
                        self.snapshot, self.REPO, prompt, steps,
                        stop_at_eos=False,
                        on_token=lambda _p, _t: times.append(
                            time.perf_counter()))
                    rec["tokens"] = np.asarray(out)
                    rec["ttft_s"] = info["ttft_s"]
                except Exception as exc:  # noqa: BLE001 - counted as failed
                    rec["error"] = f"{type(exc).__name__}: {exc}"
                with lock:
                    reqs.append(rec)

        threads = [threading.Thread(target=client, name=f"client-{i}")
                   for i in range(int(t["clients"]))]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            if tracer is not None:
                tracer.poll()
            time.sleep(0.05)
        for th in threads:
            th.join()
        if tracer is not None:
            tracer.stop()
        self.record.seconds = seconds
        self.record.requests = reqs
        self.count_writes("window")
        self.t_w, self.t_end = t_w, t_end
        self.record.window_start = t_w
        total = 0.0
        for r in reqs:
            for k, tk in enumerate(r["times"]):
                if t_w <= tk <= t_end:
                    if k == 0:
                        total += flops.llama_forward_flops(self.cfg, 0,
                                                           r["n0"], 1)
                    else:
                        total += flops.llama_forward_flops(
                            self.cfg, r["n0"] + k - 1, 1, 1)
        self.record.window_flops = total

    def tokens_in_window(self) -> int:
        return sum(1 for r in self.record.requests for tk in r["times"]
                   if self.t_w <= tk <= self.t_end)

    def end_to_end(self) -> dict:
        return {"serve_tok_s": self.tokens_in_window() / self.record.seconds}

    def close_program(self) -> None:
        import torch

        self.pool.close()
        self.pool = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[dict]:
        """The requests the judge reads: the longest finished one and a
        seeded draw of the others, ``judge_requests`` in all."""
        done = [r for r in self.record.requests if "tokens" in r]
        if not done:
            return []
        longest = max(range(len(done)), key=lambda i: done[i]["n0"])
        rest = [i for i in range(len(done)) if i != longest]
        rng = np.random.default_rng([self.seed, 7])
        n = int(self.traffic["judge_requests"]) - 1
        pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[:n]]
        return [done[i] for i in pick]

    def judge(self, control: bool = False) -> dict:
        import torch

        steps = int(self.traffic["new_tokens"])
        short = sum(1 for r in self.record.requests
                    if r["error"] is None
                    and (len(r["tokens"]) != r["n0"] + steps
                         or len(r["times"]) != steps))
        got, ctl = [], []
        sample = self.sample()
        for r in sample:
            toks, n0 = r["tokens"], r["n0"]
            ref = reference.llama_logits(self.blob_a, self.cfg, toks[:-1],
                                         self.device)
            got.append(reference.gaps(ref, toks, n0))
            if control:
                low = reference.llama_logits(self.blob_a, self.cfg,
                                             toks[:-1], self.device,
                                             quant="fp8")
                ctl.append(reference.gaps(ref, toks, n0,
                                          chosen=low.argmax(-1)))
            del ref
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        # No finished request to judge reads as wrong as can be.
        out = {"short_requests": short, "judged_tokens": steps * len(sample),
               "widest_gap": 1e30}
        # With ``control`` the control's gaps take the program's place,
        # and the program's are kept under ``program_``.
        for name, g in ((("program_", got), ("", ctl)) if control
                        else (("", got),)):
            if g:
                g = torch.cat(g)
                out[name + "widest_gap"] = float(g.max())
                out[name + "mean_gap"] = float(g.mean())
                out[name + "off_argmax"] = int((g > 0).sum())
        return out


KINDS = {"land": LandCell, "restart": RestartCell, "swap": SwapCell,
         "serve": ServeCell}

"""The benchmark of ``zest_tpu_torch`` on one card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything a cell is made of is found by
name: the cell in ``BENCHMARK.json``, its configuration in the file that
entry names, its traffic in ``portbench/traffic/<traffic>.json``, the
limits of its comparison in ``portbench/limits/<cell>.json`` and each
per-layer metric's reader in ``portbench/metrics/<metric>.py``. A cell,
a configuration or a metric is added by adding files and entries.

A run builds its inputs from ``--seed`` on the card, runs the cell's
set-up (``setup_s`` is the process's start to the window's start), then
measures for ``--seconds``. With ``--trace 0`` it reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
device's busy and window seconds from ``torch.profiler``. The outputs of
the timed path are judged by ``portbench/reference.py``; every number
compared is printed beside its limit on the last lines of standard
error and under ``compared``, the last key of the result line, which is
the last line of standard output. ``--control 1`` judges the control
instead: the reference in the next precision below takes the program's
place in the numbers compared (the program's are printed beside them),
so ``correct`` reads false; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "zest_tpu"}


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path in the checkout, and
    no library loading JAX on the side."""
    cache = root / ".portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: Path = ROOT, pkg: Path = PKG):
        self.root, self.pkg = root, pkg
        self.bench = load_json(root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.pkg / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.pkg / "limits" / f"{workload}.json")

    @staticmethod
    def _covers(metric: dict, workload: str) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self._covers(m, workload)]

    def per_layer(self, workload: str) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The ``read(record)`` of ``metrics/<metric>.py``."""
        path = self.pkg / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def write_bytes() -> int | None:
    """This process's ``write_bytes`` (bytes it sent to storage)."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def fs_type(path: str) -> str:
    """The file system a path lies on, from /proc/mounts."""
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) >= len(best):
                    best, kind = mnt, parts[2]
    except OSError:
        pass
    return kind


def card_label() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, control: bool = False,
             log=print, t_start: float = T_START) -> dict:
    """Run one cell and return its result line (a dict) and the numbers
    compared, ``result["compared"]``."""
    import torch

    from portbench.cells import KINDS
    from portbench.trace import Tracer

    w = spec.workload(workload)
    cfg = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(workload)
    e2e = spec.end_to_end(workload)
    layer = spec.per_layer(workload)
    cuda = torch.device(device).type == "cuda"

    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        cell = KINDS[traffic["kind"]](cfg, traffic, seed, device,
                                      Path(work))
        try:
            cell.setup()
            tracer = (Tracer(traffic.get("trace_seconds"))
                      if trace else None)
            if cuda:
                torch.cuda.synchronize()
            setup_s = time.monotonic() - t_start
            wb_setup = write_bytes()
            cell.window(seconds, tracer)
            if cuda:
                torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() if cuda else 0)
            values = cell.end_to_end()
            cell.close_program()
            if tracer is not None:
                cell.record.trace = tracer.summary
            judged = cell.judge(control=control)
        finally:
            cell.close()
    rec = cell.record
    wb = write_bytes()
    written = cell.writes["setup"] + cell.writes["window"]
    log(f"portbench: written setup {cell.writes['setup']} window "
        f"{cell.writes['window']} cap {cell.cap_bytes()}; write_bytes "
        f"setup {wb_setup} total {wb}")
    if max(written, wb or 0) > cell.cap_bytes():
        raise RuntimeError(f"the run wrote {max(written, wb or 0)} B, past "
                           f"its cap of {cell.cap_bytes()} B")
    log(f"portbench: steps {len(rec.steps)}, requests {len(rec.requests)}, "
        f"window {rec.seconds:.3f} s")
    if rec.steps:
        log("portbench: step hbm_s " + " ".join(
            f"{s['hbm_s']:.4f}" for s in rec.steps))
        log("portbench: step wall_s " + " ".join(
            f"{s['wall_s']:.4f}" for s in rec.steps))
        log("portbench: step program_s " + " ".join(
            f"{s['stats'].get('time_to_swap_s', s['stats'].get('time_to_hbm_s'))}"
            for s in rec.steps))
        # The files lane's tail after the landing (fsync and rename at
        # the pull's barrier): recorded, not a metric.
        log("portbench: step files_tail_s " + " ".join(
            f"{s['stats'].get('files_after_hbm_s')}" for s in rec.steps))
        log("portbench: step late_s " + " ".join(
            f"{s['late_s']:.4f}" for s in rec.steps))
    log("portbench: setup parts " + " ".join(
        f"{k} {v:.3f}" for k, v in cell.setup_parts.items()))
    if rec.steps:
        stages: dict[str, list] = {}
        for s in rec.steps:
            for k, v in (s["stats"].get("stages") or {}).items():
                stages.setdefault(k, []).append(v)
        log("portbench: stage means " + " ".join(
            f"{k} {sum(v) / len(rec.steps):.4f}" for k, v in stages.items()))
    if rec.requests:
        n_tok = sum(len(r["times"]) for r in rec.requests)
        log(f"portbench: requests {len(rec.requests)} tokens {n_tok}")

    values["setup_s"] = setup_s
    metrics = {}
    if not trace:
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"{traffic['kind']} cells give no "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in layer:
            v = spec.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    compared = {k: {"value": judged[k], "limit": lim}
                for k, lim in limits.items()}
    failed = sum(1 for r in rec.requests if r.get("error"))
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())
    attempted = len(rec.steps) or len(rec.requests)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    extra = {k: v for k, v in judged.items() if k not in compared}
    result["compared"] = compared
    result["judged"] = extra
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    spec = Spec()
    chips = int(spec.workload(args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"portbench: card {card_label()}; cpus {os.cpu_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"work under {tempfile.gettempdir()} ({fs_type(tempfile.gettempdir())})",
          flush=True)
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0",
                      control=bool(args.control),
                      log=lambda *a: print(*a, flush=True))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    judged = result.pop("judged")
    for k, v in judged.items():
        print(f"portbench: judged {k} {v}", flush=True)
    line = json.dumps(result)
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell of the PyTorch port.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything about a cell is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic mix; the
configuration is ``perfbench/configs/<config>.json``, the mix
``perfbench/traffic/<traffic>.json``, whose ``driver`` names the code that
sends its requests (``perfbench/drivers/<driver>.py``); each metric is read
by ``perfbench/metrics/<metric>.py``; the limits of the numbers that decide
``correct`` are ``perfbench/checks/<cell>.json``.

A run: set-up (the program built, its inputs made from the seed, the first
training steps driven through the timed call and recorded), then the window
(``--trace 0``: requests back to back for ``--seconds``; ``--trace 1``: the
traced mix's bounded request repeated untraced for ``PLAIN_S`` on the host's
clock, then once under the profiler), then the peak memory is read, what
the comparison needs read from the program, its state freed, and the
reference run over the recorded steps.
The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the result's
last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "universal_differential_equations_tpu")
CACHE = CHECKOUT / "build" / "perfbench_cache"
PLAIN_S = 0.5  # host-clock seconds of the traced run's untraced slice


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entries and files, found by its name."""

    def __init__(self, name, bench=None, root=CHECKOUT):
        bench = load_json(root / "BENCHMARK.json") if bench is None else bench
        self.bench, self.name = bench, name
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = by_name[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.cfg = load_json(root / conf["file"])
        pb = root / "perfbench"
        self.traffic = load_json(pb / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(pb / "checks" / f"{name}.json")
        self.metric_dir = pb / "metrics"

    def metrics(self, trace):
        """The metric entries this cell reports: its end-to-end metrics, or
        with ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if self.name in m.get("workloads", [self.name])]

    def reader(self, metric):
        path = self.metric_dir / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What the metric readers read: set-up, window, trace and work."""

    def __init__(self, cfg, traffic, work):
        self.cfg, self.traffic, self.work = cfg, traffic, work
        self.setup_s = self.window_s = math.nan
        self.iterations = self.requests = self.failed = 0
        self.iter_times = None
        self.trace = None
        self.plain_s, self.plain_iters = math.nan, 0


class _Plain:
    """Stands in for the trace where the traced request runs untraced."""

    iterations = 0


def run_cell(name, seed, seconds, trace, device, bench=None, overrides=None, t_start=None,
             root=CHECKOUT):
    """Run cell ``name`` once on ``device``; returns ``(result, checks)``.

    ``overrides`` updates the configuration and traffic dicts (``{"cfg":
    {...}, "traffic": {...}}``), for tests at small sizes; ``root`` is the
    checkout whose ``BENCHMARK.json`` and ``perfbench/`` files are read."""
    import torch

    from perfbench.trace import Tracer

    t_start = T_START if t_start is None else t_start
    cell = Cell(name, bench, root)
    for key, extra in (overrides or {}).items():
        getattr(cell, key).update(extra)
    tracer = Tracer(bool(trace))
    drv_mod = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    drv = drv_mod.Driver(cell.cfg, cell.traffic, seed, device, tracer)

    drv.setup()
    _sync(device)
    run = Run(cell.cfg, cell.traffic, drv.work())
    run.setup_s = time.perf_counter() - t_start
    if trace:
        # the traced request's steady time, untraced: repeated for PLAIN_S
        t0, plain = time.perf_counter(), _Plain()
        while time.perf_counter() - t0 < PLAIN_S:
            ok = drv.traced(plain)
            _sync(device)
            run.plain_iters += plain.iterations
            run.requests += 1
            run.failed += int(not ok)
        run.plain_s = time.perf_counter() - t0
        with tracer.slice(device) as tr:
            ok = drv.traced(tr)
        run.trace, run.requests, run.failed = tr, run.requests + 1, run.failed + int(not ok)
        run.iterations, run.window_s = tr.iterations, tr.window_s
    else:
        if hasattr(drv, "start_window"):
            drv.start_window()
        t0 = time.perf_counter()
        while True:
            n, ok = drv.request()
            run.requests += 1
            run.failed += int(not ok)
            run.iterations += n
            t1 = time.perf_counter()
            if t1 - t0 >= seconds:
                break
        run.window_s = t1 - t0
        if hasattr(drv, "iter_times"):
            run.iter_times = drv.iter_times(t0, t1)

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"],
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s

    drv.collect()
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = drv.readings()
    values = {k: readings.get(k, math.inf) for k in cell.limits}
    correct = all(values[k] <= lim for k, lim in cell.limits.items()) and run.failed == 0
    # a gap that is no finite number is written as text, so the line stays JSON
    checks = {k: {"value": v if math.isfinite(v) else str(v), "limit": cell.limits[k]}
              for k, v in values.items()}
    result = {"correct": correct, "attempted": run.requests, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result, checks


def _sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _card_note():
    """The card's name and power limit, for the run's standard error."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    cell = Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {_card_note()}", file=sys.stderr, flush=True)
    result, checks = run_cell(args.workload, args.seed, args.seconds, args.trace,
                              torch.device("cuda"))
    bad = banned_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

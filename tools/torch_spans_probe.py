#!/usr/bin/env python3
"""What the training loops' own spans and counters (``utils.profiling``) show on a CUDA card.

    python3 tools/torch_spans_probe.py cost [--out FILE]
    python3 tools/torch_spans_probe.py chain [--seed N] [--seconds 51] [--out FILE]
    python3 tools/torch_spans_probe.py traced --workload CELL [--seed N] [--out FILE]

``cost``: host microseconds of ``span()`` and ``count()`` with no profiler
(the flag test), and of a span and a count while a CPU-only profiler records.

``chain``: the benchmark cell ``lv_study.bfgs`` as its harness runs it
(``perfbench/drivers/lv_stage.py``: the seed's lane order, a 20-step ADAM
warm start and 3 BFGS iterations in set-up, then requests of 10 BFGS
iterations chained for ``--seconds``), every request under a CPU-only
``torch.profiler`` session so that the counters record.  For each request:
its seconds, evaluations per iteration (the first evaluation included, as the
trace's graph replays count it), lane occupancy (``bfgs.lane_trials`` ÷
evaluations × lanes) and the seconds in each BFGS span (``bfgs.read`` is the
host waiting on the device).

``traced``: one ``python3 -m perfbench.run --trace 1`` run of ``CELL`` (its
result line printed as the harness prints it), then, from the same traced
window: each program span's record against the profiler's event of the same
name (record less event at each end, by time in the window), the idle time
by the host's innermost program span (``waits`` spans and time outside every
span named apart), for each CUDA graph launch its call's host time and the
idle in and after it, and the program's counters summed over the window
beside its ``graph.replay`` spans (``lane_loss.kernel`` equals them where
every evaluation went through the lane kernel).

Each prints one JSON object and writes it to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cost():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from universal_differential_equations_torch.utils import profiling

    def per_call_us(body, n):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        return (time.perf_counter() - t0) / n * 1e6

    def one_span():
        with profiling.span("probe.span"):
            pass

    def one_count():
        profiling.count("probe.count")

    def record_function():
        with torch.profiler.record_function("probe.rf"):
            pass

    out = {"off": {"span_us": per_call_us(one_span, 200_000),
                   "count_us": per_call_us(one_count, 200_000),
                   "record_function_us": per_call_us(record_function, 20_000)}}
    with profile(activities=[ProfilerActivity.CPU]):
        record_function()
        out["on"] = {"span_us": per_call_us(one_span, 20_000),
                     "count_us": per_call_us(one_count, 20_000),
                     "record_function_us": per_call_us(record_function, 20_000)}
    profiling.clear()
    return out


def chain(seed, seconds, device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import run
    from perfbench.drivers import lv_stage
    from perfbench.trace import Tracer
    from universal_differential_equations_torch.utils import profiling

    cell = run.Cell("lv_study.bfgs")
    drv = lv_stage.Driver(cell.cfg, cell.traffic, seed, device, Tracer(False))
    drv.setup()
    run._sync(device)
    rows, t_start = [], time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        profiling.clear()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU]):
            iters, ok = drv.request()
        wall = time.perf_counter() - t0
        rec = profiling.recorded()
        total = {}
        for name, _, n in rec["counts"]:
            total[name] = total.get(name, 0) + n
        spans = {}
        for name, s, e, _, _ in rec["spans"]:
            spans[name] = spans.get(name, 0) + (e - s) / 1e9
        evals = total["bfgs.evaluations"]
        rows.append({"seconds": wall, "ok": ok, "iterations": iters,
                     "evaluations": evals + 1, "evals_per_iter": (evals + 1) / iters,
                     "lane_occupancy_pct": 100.0 * total["bfgs.lane_trials"]
                     / (evals * total["bfgs.lanes"]),
                     "span_s": spans})
    profiling.clear()
    return {"seed": seed, "window_s": time.perf_counter() - t_start, "requests": rows}


def traced(workload, seed):
    import torch

    from perfbench import run, trace
    from universal_differential_equations_torch.utils import profiling

    kept = {}
    fill = trace._fill

    def keep(tr, prof, names):
        fill(tr, prof, names)
        kept["trace"], kept["prof"] = tr, prof

    trace._fill = keep
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "51",
                   "--trace", "1"])
    tr, prof = kept["trace"], kept["prof"]
    lo, hi = tr.window
    rec = profiling.recorded()
    spans = [s for s in rec["spans"] if s[2] is not None and s[1] >= lo and s[2] <= hi]
    counts = {}
    for name, t, n in rec["counts"]:
        if lo <= t <= hi:
            counts[name] = counts.get(name, 0) + n
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    agree = {}
    for name in sorted({s[0] for s in spans}):
        mine = sorted((s, e) for n, s, e, _, _ in spans if n == name)
        theirs = sorted(events.get(name, []))
        # (ms into the window, record - event at the start, at the end, in us)
        gaps = [((a - lo) / 1e6, (a - c) / 1e3, (b - d) / 1e3)
                for (a, b), (c, d) in zip(mine, theirs)]
        worst = max((max(abs(g[1]), abs(g[2])) for g in gaps), default=None)
        agree[name] = {"spans": len(mine), "events": len(theirs), "worst_gap_us": worst,
                       "over_50us": sum(max(abs(g[1]), abs(g[2])) > 50 for g in gaps),
                       "gaps": gaps}
    return {"rc": rc, "window_s": tr.window_s, "busy_s": tr.busy_s(), "counts": counts,
            "graph_replays": sum(s[0] == "graph.replay" for s in spans), "agree": agree,
            "idle_s_by_innermost_span": _idle_by_span(tr, spans),
            "graph_launches": _graph_launches(tr)}


def _graph_launches(tr):
    """For each CUDA graph launch in the window, in ms: the launch call's
    host time, the idle in it, when the replay's first kernel starts after
    the call starts, and the idle from the call's end to the last kernel."""
    kernels = {}
    for _, s, e, corr in tr.kernels:
        kernels.setdefault(corr, []).append((s, e))
    gaps = tr.idle_gaps()

    def idle(a, b):
        return sum(max(0, min(b, e) - max(a, s)) for s, e in gaps) / 1e6

    rows = []
    for name, s, e, corr in tr.runtime:
        if name.startswith("cudaGraphLaunch") and corr in kernels:
            first = min(k[0] for k in kernels[corr])
            last = max(k[1] for k in kernels[corr])
            rows.append({"call_ms": (e - s) / 1e6, "idle_in_call_ms": idle(s, e),
                         "first_kernel_ms": (first - s) / 1e6,
                         "idle_after_call_ms": idle(e, last), "kernels": len(kernels[corr])})
    return rows


def _idle_by_span(tr, spans):
    """Seconds of the window's idle gaps by the host's innermost open program
    span (the latest started), ``waits`` spans marked, ``outside`` where
    none is open."""
    edges = sorted({tr.window[0], tr.window[1]} | {t for _, s, e, _, _ in spans
                                                   for t in (s, e)})
    out = {}
    gaps = tr.idle_gaps()
    for t0, t1 in zip(edges[:-1], edges[1:]):
        open_ = [(s, i) for i, (_, s, e, _, _) in enumerate(spans) if s <= t0 and e >= t1]
        if open_:
            name, _, _, _, waits = spans[max(open_)[1]]
            key = name + (" (waits)" if waits else "")
        else:
            key = "outside"
        idle = sum(max(0, min(t1, b) - max(t0, a)) for a, b in gaps)
        if idle:
            out[key] = out.get(key, 0) + idle / 1e9
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("cost", "chain", "traced"))
    ap.add_argument("--workload", default="lv_study.bfgs")
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from universal_differential_equations_torch.utils import card_name

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    out = {"device": card_name(torch.device("cuda", 0)), "torch": torch.__version__,
           "mode": args.mode}
    if args.mode == "cost":
        out.update(cost())
    elif args.mode == "chain":
        out.update(chain(args.seed, args.seconds, torch.device("cuda", 0)))
    else:
        out.update(workload=args.workload, **traced(args.workload, args.seed))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()

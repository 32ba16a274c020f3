#!/usr/bin/env python3
"""One-off probe of the PyTorch port's fused RHS kernels on one CUDA card.

    python3 tools/torch_rhs_probe.py [--parent-src OLD.cu] [--out build/local/rhs_probe.json]

Measures, with the card's name and power limit beside them:

1. Device time per call (``torch.profiler``, 50 calls) of kernel A
   (``csrc/updet_rhs.cu``) at widths (1,10,20,10,1) and (1,3,1), N in {26,
   1024, 131072, 2^20}, and of the plain PyTorch version; with
   ``--parent-src``, of the single runtime-width kernel the source held
   before it was compiled per width tuple (that source's C entry
   ``ude_updet_rhs(u, out, packed, n_packed, widths, n_layers, n, rows,
   stream)``, whose wrapper packs the weights with one ``torch.cat``; a
   source with today's C interface does not load here), built with the same
   ``nvcc`` flags.  Per-call CUDA-event medians beside them.
2. ``torch.compile`` of the plain version at N = 2^16, 2^18, 2^20: the
   yardstick (device time per call).  The port never calls it.
3. Kernel B (the tangent) against the plain tangent at (T, N) = (465, 26) and
   (16, 1024); the empty kernel's device time (the launch floor).
4. The MLP Levenberg-Marquardt main path at N = 26, in three wirings:
   ``plain`` (the PyTorch RHS), ``op`` (kernels A and B, the tangent
   through the ``torch.library`` custom operator ``updet_tangent``: the
   port's wiring) and ``function`` (kernels A and B, the tangent through an
   ``autograd.Function`` with a vmap rule, defined here only).  Wall and process
   CPU seconds per iteration, alternated: 12 rounds, each running the three
   wirings in the next of their six orders, 2 iterations each; the median
   over rounds of each kernel wiring's difference from plain, and of op's
   from function, in its round.
   Then a cProfile of one LM call of each, and one ``torch.profiler`` LM
   call (initial residuals, one Jacobian, one trial step) of each: device
   kernels launched, device time, and the device's busy share.

Writes every number to ``--out`` as JSON.  Imports no JAX.
"""
import argparse
import cProfile
import ctypes
import io
import itertools
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAPER = (1, 10, 20, 10, 1)
ROUNDS = 12  # each runs the three wirings once, 2 LM iterations each
WIRINGS = ("plain", "op", "function")


def log(msg):
    print(msg, flush=True)


def _device_events(prof):
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile(fn, calls=50, warm=5):
    """(device µs per call of each kernel name, device µs per call in all,
    kernels per call) over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    events = _device_events(prof)
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / calls
    return by_name, sum(by_name.values()), len(events) / calls


def event_us(fn, calls=50, reps=7):
    """Median over reps of the CUDA-event time of ``calls`` back-to-back calls, per call."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    return statistics.median(times)


def parent_kernel(src):
    """Build an earlier kernel source; return fn(u, taps, d0, mlp) -> out."""
    import torch
    from universal_differential_equations_torch.ops import _build

    lib_path = ROOT / "build" / "local" / "libparent_kernels.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build._FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ude_updet_rhs.argtypes = [p, p, p, i, ctypes.POINTER(i), i, i, i, p]
    lib.ude_updet_rhs.restype = i

    def run(u, taps, d0, mlp):
        packed = torch.cat([taps.reshape(3), d0.reshape(1)]
                           + [t.reshape(-1) for wb in mlp for t in wb])
        sizes = [1] + [w.shape[1] for w, _ in mlp]
        out = torch.empty_like(u)
        rc = lib.ude_updet_rhs(u.data_ptr(), out.data_ptr(), packed.data_ptr(), packed.numel(),
                               (i * len(sizes))(*sizes), len(sizes) - 1, u.shape[-1], 1,
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent kernel launch failed ({rc})")
        return out

    return run


def kernel_rows(args, res):
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from universal_differential_equations_torch.ops import stencil

    device = torch.device("cuda", 0)
    old = parent_kernel(args.parent_src) if args.parent_src else None
    rows = []
    for sizes in (PAPER, (1, 3, 1)):
        for n in (26, 1024, 131072, 1048576):
            a = cs._inputs(n, n, sizes, device)
            ref = stencil.updet_rhs_torch(*a)
            row = {"widths": sizes, "n": n}
            names, _, _ = profile(lambda: stencil.fused_updet_rhs(*a))
            row["kernel_us"] = sum(v for k, v in names.items() if "rhs_net" in k or "rhs_generic" in k)
            row["kernel_call_us"] = event_us(lambda: stencil.fused_updet_rhs(*a))
            _, row["plain_us"], row["plain_kernels"] = profile(lambda: stencil.updet_rhs_torch(*a))
            row["plain_call_us"] = event_us(lambda: stencil.updet_rhs_torch(*a))
            if old is not None:
                torch.testing.assert_close(old(*a), ref, rtol=2e-5, atol=2e-5)
                names, total, _ = profile(lambda: old(*a))
                row["old_kernel_us"] = names.get(
                    next((k for k in names if "updet_rhs_kernel" in k), ""), float("nan"))
                row["old_with_pack_us"] = total
                row["old_call_us"] = event_us(lambda: old(*a))
            b_ms, b_by = cs.bound_a(sizes, n)
            row["bound_us"], row["bound_by"] = b_ms * 1e3, b_by
            row["share"] = row["bound_us"] / row["kernel_us"]
            rows.append(row)
            log(f"[A] {sizes} N={n}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items() if k not in ("widths", "n")))
    res["kernel_a"] = rows

    comp = []
    for sizes in (PAPER, (1, 3, 1)):
        fn = torch.compile(stencil.updet_rhs_torch, dynamic=True)
        for n in (65536, 262144, 1048576):
            a = cs._inputs(n, n, sizes, device)
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            torch.testing.assert_close(out, stencil.updet_rhs_torch(*a), rtol=2e-5, atol=2e-5)
            names, total, kernels = profile(lambda: fn(*a))
            a_names, _, _ = profile(lambda: stencil.fused_updet_rhs(*a))
            k_us = sum(v for k, v in a_names.items() if "rhs_net" in k)
            comp.append({"widths": sizes, "n": n, "compile_us": total, "compile_kernels": kernels,
                         "kernel_us": k_us, "first_call_s": first_s})
            log(f"[compile] {sizes} N={n}: torch.compile {total:.2f} us device ({kernels:.0f} "
                f"kernels), kernel A {k_us:.2f} us; first call {first_s:.1f} s")
    res["torch_compile"] = comp

    tan = []
    for T, n in ((465, 26), (16, 1024)):
        u, taps, d0, mlp = cs._inputs(T + n, n, PAPER, device)
        t = cs._tangent_inputs(T + n + 1, T, u, taps, d0, mlp)
        names, _, _ = profile(lambda: stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, *t))
        k_us = sum(v for k, v in names.items() if "tan_net" in k)
        _, p_us, p_k = profile(lambda: stencil.updet_rhs_jvp(u, taps, d0, mlp, *t))
        b_ms, b_by = cs.bound_b(PAPER, T, n)
        row = {"T": T, "n": n, "kernel_us": k_us,
               "kernel_call_us": event_us(
                   lambda: stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, *t)),
               "plain_us": p_us, "plain_kernels": p_k,
               "plain_call_us": event_us(lambda: stencil.updet_rhs_jvp(u, taps, d0, mlp, *t)),
               "bound_us": b_ms * 1e3, "bound_by": b_by}
        tan.append(row)
        log(f"[B] (T, N)=({T}, {n}): {row}")
    res["kernel_b"] = tan
    names, _, _ = profile(lambda: stencil.empty_launch(device))
    res["empty_us"] = sum(names.values())
    res["empty_call_us"] = event_us(lambda: stencil.empty_launch(device))
    log(f"[floor] empty kernel {res['empty_us']:.3f} us device, {res['empty_call_us']:.2f} us "
        f"per call back to back")


def function_jvp():
    """A ``FusedUpdetRHS.jvp`` that sends the tangent to kernel B through an
    ``autograd.Function`` with a vmap rule (derivatives in PyTorch math)
    instead of the port's custom operator: the alternative wiring that the
    LM alternation times."""
    import torch
    from universal_differential_equations_torch.ops import stencil

    class UpdetTangent(torch.autograd.Function):
        @staticmethod
        def forward(u, taps, d0, du, dtaps, dd0, *flat):
            half = len(flat) // 2
            return stencil.fused_updet_rhs_tangent(u, taps, d0, stencil._pairs(flat[:half]), du,
                                                   dtaps, dd0, stencil._pairs(flat[half:]))

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)
            ctx.save_for_forward(*inputs)

        @staticmethod
        def jvp(ctx, *tangents):
            inputs = ctx.saved_tensors
            tangents = tuple(torch.zeros_like(x) if t is None else t
                             for x, t in zip(inputs, tangents))
            return torch.func.jvp(stencil._tangent_flat, inputs, tangents)[1]

        @staticmethod
        def backward(ctx, g):
            return torch.func.vjp(stencil._tangent_flat, *ctx.saved_tensors)[1](g)

        @staticmethod
        def vmap(info, in_dims, *args):
            half = (len(args) - 6) // 2
            tangent = [False] * 3 + [True] * 3 + [False] * half + [True] * half
            if any(d is not None for d, t in zip(in_dims, tangent) if not t):
                raise NotImplementedError("batched primals")
            B = info.batch_size

            def front(t, d):
                return t.movedim(d, 0) if d is not None else t.expand(B, *t.shape)

            moved = [front(a, d) if t else a for a, d, t in zip(args, in_dims, tangent)]
            moved[3] = moved[3].contiguous()
            return UpdetTangent.apply(*moved), 0

    def jvp(ctx, *tangents):
        primals = ctx.saved_tensors
        u, taps, d0, *flat = primals
        du, dtaps, dd0, *dflat = (torch.zeros_like(p) if t is None else t if t.dtype == p.dtype
                                  else t.to(p.dtype) for p, t in zip(primals, tangents))
        return UpdetTangent.apply(u, taps, d0, du, dtaps, dd0, *flat, *dflat)

    return staticmethod(jvp)


def lm_rows(res):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.models import fisher_kpp as fk

    from universal_differential_equations_torch.ops import stencil

    device = torch.device("cuda", 0)
    ts, ys = fk.generate_data(device=device)
    use_fused, op_jvp = fk._use_fused, vars(stencil.FusedUpdetRHS)["jvp"]
    jvp_through_function = function_jvp()

    def run(path, iters):
        if path == "plain":
            fk._use_fused = lambda u: False
        if path == "function":
            stencil.FusedUpdetRHS.jvp = jvp_through_function
        try:
            rhs, p0 = fk.make_model(torch.Generator().manual_seed(0), "mlp", device=device)
            return cs._timed_lm(cs._residual_fn(rhs, ts, ys), p0, maxiters=iters)
        finally:
            fk._use_fused, stencil.FusedUpdetRHS.jvp = use_fused, op_jvp

    for path in WIRINGS:
        before = stencil.tangent_launches
        run(path, 1)
        if (stencil.tangent_launches > before) != (path != "plain"):
            raise AssertionError(f"wiring {path} did not take the path it names")
    walls = {path: [] for path in WIRINGS}
    cpu = {path: [] for path in WIRINGS}
    orders = list(itertools.permutations(WIRINGS))
    for r in range(ROUNDS):
        for path in orders[r % len(orders)]:
            c0 = time.process_time()
            _, _, w = run(path, 2)
            walls[path].append(statistics.mean(w))
            cpu[path].append((time.process_time() - c0) / 2)
    res["lm_walls"], res["lm_cpu_s"] = walls, cpu
    for path in WIRINGS:
        log(f"[lm] {path}: s per iteration, median of {ROUNDS} rounds "
            f"{statistics.median(walls[path]):.4f} (min {min(walls[path]):.4f}); process CPU s "
            f"per iteration, median {statistics.median(cpu[path]):.4f} (min {min(cpu[path]):.4f})")
    for path, base in (("op", "plain"), ("function", "plain"), ("op", "function")):
        dw = [a - b for a, b in zip(walls[path], walls[base])]
        dc = [a - b for a, b in zip(cpu[path], cpu[base])]
        res[f"lm_{path}_minus_{base}"] = {"wall": dw, "cpu": dc}
        log(f"[lm] {path} - {base}, paired by round: wall median {statistics.median(dw):+.4f} s "
            f"({sum(d < 0 for d in dw)} of {ROUNDS} rounds faster), process CPU median "
            f"{statistics.median(dc):+.4f} s")
    for path in WIRINGS:
        prof = cProfile.Profile()
        prof.enable()
        run(path, 1)
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
        log(f"[lm cprofile] {path}, one LM call (tottime):\n" + out.getvalue()[-6000:])
    prof_rows = {}
    for path in WIRINGS:
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, _, _ = run(path, 1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _device_events(prof)
        busy_us = sum(e.time_range.elapsed_us() for e in ev)
        names = {}
        for e in ev:
            names.setdefault(e.name, [0, 0.0])
            names[e.name][0] += 1
            names[e.name][1] += e.time_range.elapsed_us()
        top = sorted(names.items(), key=lambda kv: -kv[1][0])[:8]
        prof_rows[path] = {"wall_s": wall, "device_kernels": len(ev), "device_ms": busy_us / 1e3,
                           "busy": busy_us / 1e6 / wall,
                           "launch_api_calls": sum(1 for e in prof.events()
                                                   if e.name in ("cudaLaunchKernel",
                                                                 "cudaLaunchKernelExC")),
                           "top": [(k[:80], c, us) for k, (c, us) in top]}
        log(f"[lm profile] {path}: {prof_rows[path]}")
    res["lm_profile"] = prof_rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "local" / "rhs_probe.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_rhs_probe.py measures on a CUDA card only", file=sys.stderr)
        return 2
    import universal_differential_equations_torch  # noqa: F401  (sets TF32 off)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    kernel_rows(args, res)
    lm_rows(res)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

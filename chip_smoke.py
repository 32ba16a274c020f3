#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``universal_differential_equations_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card must be present (it never carries on on the CPU).
   Prints ``nvidia-smi``'s name and power limit and the torch/CUDA versions.
2. Build: compiles ``csrc/updet_rhs.cu`` with ``nvcc`` for ``sm_90a`` from the
   checkout's sources and prints the build seconds, each kernel's ``ptxas``
   registers, stack frame and spills, and its FFMA and MUFU counts
   (``cuobjdump -sass``).  A kernel compiled for fixed widths with a nonzero
   stack frame or any spill fails the phase.
3. Kernels against plain, on the card, in float32:
   kernel A (the fused reaction+stencil RHS) against ``updet_rhs_torch`` at
   rtol = atol = 2e-5, for each compiled width tuple and the runtime-width
   path (1,7,5,1), N in {1, 26, 257, 1024, 131072, 1048576}, a (8, 1024)
   batch and the periodic wrap; kernel B (its tangent, T directions in one
   launch) against ``updet_rhs_jvp`` at (T, N) in {(1, 26), (465, 26),
   (16, 1024)}, rtol = atol = 1e-4; ``FusedUpdetRHS``'s JVP and gradient.
   Prints CUDA-event per-call medians of both kernels and their plain
   versions, and the empty kernel's time (the launch floor).
4. The main path: Fisher-KPP truth data, the paper's MLP model, and 5
   Levenberg-Marquardt iterations with forward-mode Jacobians through the
   adaptive Tsit5 stepper, all on ``cuda:0`` in float32.  The first
   Jacobian on the card equals the plain path's on the CPU (float32) to
   1e-3 of the largest entry of its ODE rows (the penalty row runs no
   kernel).  The launch counters are zeroed just before the LM run: after
   it kernel A's and kernel B's must be positive and the runtime-width
   count 0 (the paper net runs its compiled kernels); the final loss must
   be finite and no larger than the initial one.
5. ``bench.py``'s task on the port: the Fourier variant trained by LM to
   loss < 0.01 (at most 100 iterations), timed.
6. Lotka-Volterra scenario 1 on the card, every stage on ``cuda:0`` (this
   path runs no hand-written kernel; the kernels' counters are zeroed before
   and reported after):
   (a) Vern7 truth at 1e-12 in float64, equal to the CPU's to 1e-10;
   (b) the interpolating-adjoint gradient of the scenario's loss for the
       full 2→5→5→5→2 RBF model against the discrete adjoint (float32 at
       1e-6: relative 1e-3; float64 at 1e-8: relative 1e-6), against the
       CPU float64 port (relative 1e-9) and under ``torch.func.grad``
       (relative 1e-12), with the median seconds per gradient over 10 calls;
   (c) 20 ADAM steps (float32) and 20 BFGS iterations (float64): the loss is
       finite and falls;
   (d) SINDy (polynomial degree 5 + sin, the scenario's λ grid) on the true
       interactions selects exactly x·y per equation, at −0.9 and 0.8 to 1e-6;
   (e) that model refit by BFGS (≤ 50 iterations) on the noisy data and
       extrapolated to t = 50: the solve succeeds and the period is within
       10 % of the truth's;
   (f) a 4-lane ``bfgs_minimize_lanes`` over ``integrate_fixed`` equals the
       four single-lane ``bfgs_minimize`` runs to 1e-10 (float64, 5
       iterations).
   (c), (e) and (f) call the pipeline's own stages
   (``examples/lv_scenario_1.py``: ``make_loss``, ``refit``, ``extrapolate``,
   ``judge_loss``).

The line before the last is ``{"kernels": [...]}``, one entry per kernel with
its bound on the card (H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s float32); the
last line is ``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "universal_differential_equations_torch"
TOL = dict(rtol=2e-5, atol=2e-5)
PAPER = (1, 10, 20, 10, 1)
ODD = (1, 7, 5, 1)  # no compiled kernel: the runtime-width path
NS = (1, 26, 257, 1024, 131072, 1048576)
TAN_CASES = ((1, 26), (465, 26), (16, 1024))
TAN_TOL = dict(rtol=1e-4, atol=1e-4)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores, published


def log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, python {sys.version.split()[0]}")
    return card


def _ptxas_report(text):
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from ``-Xptxas -v``."""
    report, current = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^'\s]+)", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            report.setdefault(current, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            report.setdefault(current, {})["registers"] = int(m[1])
    return {k: v for k, v in report.items() if "registers" in v}


def _sass_counts(lib_path, nvcc):
    """{kernel: Counter of SASS opcodes} from ``cuobjdump -sass``."""
    out = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", lib_path],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[name][m.group(1)] += 1
    return counts


def _demangle(names):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=30, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {n: n for n in names}
    return {n: d.split("(")[0].replace("void ", "") for n, d in zip(names, out)}


def phase_build():
    from universal_differential_equations_torch.ops import _build

    info = _build.build(force=True)
    lib = _build.load()
    log(f"[build] nvcc sm_90a -> {info['path']} in {info['seconds']:.2f} s")
    report = _ptxas_report(info["log"])
    try:
        sass = _sass_counts(info["path"], _build.nvcc())
    except (OSError, subprocess.SubprocessError) as e:
        log(f"[build] cuobjdump -sass unavailable: {e}")
        sass = {}
    names = _demangle(list(report))
    bad = []
    for mangled, r in report.items():
        ops = sass.get(mangled, Counter())
        log(f"[build]   {names[mangled]}: {r['registers']} registers, stack frame "
            f"{r.get('stack', 0)} B, spill stores {r.get('spill_stores', 0)} B, spill loads "
            f"{r.get('spill_loads', 0)} B; SASS FFMA {ops['FFMA']}, FMUL {ops['FMUL']}, "
            f"FADD {ops['FADD']}, MUFU {ops['MUFU']}, LDS {ops['LDS']}, LDG {ops['LDG']}, "
            f"all {sum(ops.values())}")
        fixed = "rhs_net" in mangled or "tan_net" in mangled
        if fixed and (r.get("stack", 0) or r.get("spill_stores", 0) or r.get("spill_loads", 0)):
            bad.append(names[mangled])
    n_nets = len(lib.nets)
    if sum("rhs_net" in k for k in report) != n_nets or sum("tan_net" in k for k in report) != n_nets:
        raise AssertionError(f"expected {n_nets} compiled-width kernels of each kind, got "
                             f"{list(names.values())}")
    if bad:
        raise AssertionError(f"compiled-width kernels with a stack frame or spills: {bad}")


def _inputs(seed, n, sizes, device, rows=None):
    import torch
    from universal_differential_equations_torch.ops import stencil

    g = torch.Generator().manual_seed(seed)
    shape = (n,) if rows is None else (rows, n)
    u = torch.rand(shape, generator=g).to(device)
    taps = torch.tensor([6.25, -12.5, 6.25], device=device)
    d0 = torch.tensor(0.7, device=device)
    mlp = [(w, 0.1 * torch.randn(b.shape, generator=g).to(device))
           for w, b in stencil.make_pointwise_mlp_params(g, sizes, device=device)]
    return u, taps, d0, mlp


def _tangent_inputs(seed, T, u, taps, d0, mlp):
    """A block of T random directions: (du, dtaps, dd0, [(dw, db), ...])."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def draw(x):
        return torch.randn((T, *x.shape), generator=g).to(x.device)

    return draw(u), draw(taps), draw(d0), [(draw(w), draw(b)) for w, b in mlp]


def _median_ms(fn, calls=50, reps=7):
    """Median over ``reps`` of (CUDA-event time of ``calls`` back-to-back calls)/calls."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _layer_pairs(sizes):
    return list(zip(sizes[:-1], sizes[1:]))


def flop_per_point(sizes):
    """Kernel A's operations per point: layer FMAs (2 each), bias adds, one per
    tanh, 7 for the stencil (928 for the paper net)."""
    return sum(2 * a * b + b for a, b in _layer_pairs(sizes)) + sum(sizes[1:-1]) + 7


def flop_per_tangent_point(sizes):
    """Kernel B's operations per (direction, point) beyond the primal's, which
    the function needs once per point whatever T is: 4 per weight (dh·W and
    h·dW), one per bias tangent, 3 per tanh tangent and 15 for the stencil's
    tangent and the sum (1856 for the paper net)."""
    return sum(4 * a * b + b for a, b in _layer_pairs(sizes)) + 3 * sum(sizes[1:-1]) + 15


def n_params(sizes):
    return 4 + sum(a * b + b for a, b in _layer_pairs(sizes))


def bound_ms(flop, nbytes):
    """The least time on an H100 SXM: the larger of bytes over the memory rate
    and operations over the float32 rate; and which of the two it is."""
    t_ops, t_bytes = flop / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_a(sizes, n, rows=1):
    return bound_ms(rows * n * flop_per_point(sizes), 4 * (2 * rows * n + n_params(sizes)))


def bound_b(sizes, T, n):
    return bound_ms(n * flop_per_point(sizes) + T * n * flop_per_tangent_point(sizes),
                    4 * (n + 2 * T * n + (1 + T) * n_params(sizes)))


def phase_kernel(device):
    import torch
    from universal_differential_equations_torch.ops import stencil

    res = {"err_a": 0.0, "err_b": 0.0, "a": {}, "b": {}}
    for sizes in (*stencil._library().nets, ODD):
        for n in NS:
            args = _inputs(n, n, sizes, device)
            out = stencil.fused_updet_rhs(*args)
            ref = stencil.updet_rhs_torch(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, **TOL)
            res["err_a"] = max(res["err_a"], err)
            k_ms = _median_ms(lambda: stencil.fused_updet_rhs(*args))
            p_ms = _median_ms(lambda: stencil.updet_rhs_torch(*args))
            b_ms, b_by = bound_a(sizes, n)
            res["a"][(sizes, n)] = (k_ms, p_ms, b_ms, b_by)
            log(f"[kernel A] widths {sizes} N={n:>8}: max|kernel-plain| {err:.3e}  per call "
                f"kernel {k_ms * 1e3:9.2f} us  plain {p_ms * 1e3:9.2f} us  bound "
                f"{b_ms * 1e3:.3f} us ({b_by})")
    args = _inputs(7, 1024, PAPER, device, rows=8)
    out = stencil.fused_updet_rhs(*args)
    ref = stencil.updet_rhs_torch(*args)
    torch.testing.assert_close(out, ref, **TOL)
    err = (out - ref).abs().max().item()
    res["err_a"] = max(res["err_a"], err)
    log(f"[kernel A] batched (8, 1024): max|kernel-plain| {err:.3e}")

    zero = lambda: (torch.zeros(1, 1, device=device), torch.zeros(1, device=device))  # noqa: E731
    for mlp in ([zero()], [zero(), zero()]):  # widths (1, 1): runtime; (1, 1, 1): compiled
        for n in (26, 1024, 1031):
            for idx in (0, n - 1):
                u = torch.zeros(n, device=device)
                u[idx] = 1.0
                for taps, shift in (([1.0, 0.0, 0.0], 1), ([0.0, 0.0, 1.0], -1)):
                    out = stencil.fused_updet_rhs(u, torch.tensor(taps, device=device),
                                                  torch.tensor(1.0, device=device), mlp)
                    if not torch.equal(out, torch.roll(u, shift)):
                        raise AssertionError(f"periodic wrap wrong: {len(mlp)} layers, N={n}, "
                                             f"one-hot at {idx}, shift {shift}")
    log("[kernel A] periodic wrap: one-hot at 0 and N-1, N in (26, 1024, 1031), compiled and "
        "runtime widths: exact")

    for sizes in (PAPER, ODD):
        for T, n in TAN_CASES:
            u, taps, d0, mlp = _inputs(T + n, n, sizes, device)
            tangents = _tangent_inputs(T + n + 1, T, u, taps, d0, mlp)
            out = stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, *tangents)
            ref = stencil.updet_rhs_jvp(u, taps, d0, mlp, *tangents)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, **TAN_TOL)
            res["err_b"] = max(res["err_b"], err)
            k_ms = _median_ms(lambda: stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, *tangents))
            p_ms = _median_ms(lambda: stencil.updet_rhs_jvp(u, taps, d0, mlp, *tangents))
            b_ms, b_by = bound_b(sizes, T, n)
            res["b"][(sizes, T, n)] = (k_ms, p_ms, b_ms, b_by)
            log(f"[kernel B] widths {sizes} (T, N)=({T}, {n}): max|kernel-plain| {err:.3e}  "
                f"per call kernel {k_ms * 1e3:9.2f} us  plain {p_ms * 1e3:9.2f} us  bound "
                f"{b_ms * 1e3:.3f} us ({b_by})")

    res["floor_ms"] = _median_ms(lambda: stencil.empty_launch(device))
    singles = []
    for _ in range(101):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stencil.empty_launch(device)
        end.record()
        end.synchronize()
        singles.append(start.elapsed_time(end))
    res["floor_event_ms"] = statistics.median(singles)
    log(f"[kernel] empty kernel: {res['floor_ms'] * 1e3:.2f} us per call back to back, "
        f"{res['floor_event_ms'] * 1e3:.2f} us between two events around one launch "
        f"(median of 101)")

    u, taps, d0, mlp = _inputs(11, 1024, PAPER, device)
    primals = (u, taps, d0, *[x for wb in mlp for x in wb])
    g = torch.Generator().manual_seed(12)
    tangents = tuple(torch.randn(p.shape, generator=g).to(device) for p in primals)

    def plain(u_, t_, d_, *f):
        return stencil.updet_rhs_torch(u_, t_, d_, stencil._pairs(f))

    _, jvp_k = torch.func.jvp(stencil.FusedUpdetRHS.apply, primals, tangents)
    _, jvp_p = torch.func.jvp(plain, primals, tangents)
    torch.testing.assert_close(jvp_k, jvp_p, **TAN_TOL)
    leaves = [p.clone().requires_grad_(True) for p in primals]
    grads_k = torch.autograd.grad((stencil.FusedUpdetRHS.apply(*leaves) ** 2).sum(), leaves)
    grads_p = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    worst = 0.0
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item())
    log(f"[kernel] FusedUpdetRHS jvp max|diff| {(jvp_k - jvp_p).abs().max().item():.3e}, "
        f"grad worst relative diff {worst:.3e} (rtol 1e-4)")
    return res


def _residual_fn(rhs, ts, ys):
    """The residuals of examples/fisher_kpp/fisher_kpp.py:69-79, on the port."""
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.models import fisher_kpp as fk

    def residuals(p):
        sol = ude.solve(
            ude.ODEProblem(rhs, ys[0], (0.0, fk.T_END), p), ude.Tsit5(),
            saveat=ts, rtol=1e-4, atol=1e-6,
            adjoint=ude.ForwardSensitivity(), max_steps=192,
        )
        pen = torch.sqrt(fk.zero_sum_penalty(p) + 1e-30)
        r = torch.cat([(sol.ys - ys).reshape(-1), pen[None]])
        # unstable candidates that exhaust max_steps -> inf residuals
        return torch.where(sol.success, r, torch.inf)

    return residuals


def _timed_lm(residuals, params0, **kw):
    import torch
    import universal_differential_equations_torch as ude

    walls = []
    last = [time.perf_counter()]

    def on_iter(k, loss):
        now = time.perf_counter()
        walls.append(now - last[0])
        last[0] = now

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last[0] = t0
    res = ude.levenberg_marquardt(residuals, params0, callback=on_iter, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, walls


def phase_main_path(device):
    import torch
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import fisher_kpp as fk
    from universal_differential_equations_torch.ops import stencil

    t0 = time.perf_counter()
    ts, ys = fk.generate_data(device=device)  # raises unless the truth solve succeeded
    log(f"[main] truth data {tuple(ys.shape)} on {ys.device} in {time.perf_counter() - t0:.2f} s")
    rhs, params0 = fk.make_model(torch.Generator().manual_seed(0), "mlp", device=device)
    residuals = _residual_fn(rhs, ts, ys)

    # the residuals agree with the same model's plain path (CPU, float32) on
    # the initial parameters; the solves run at rtol=1e-4, so allow 1e-3
    r0 = residuals(params0)
    rhs_c, params_c = fk.make_model(torch.Generator().manual_seed(0), "mlp")
    r0_c = _residual_fn(rhs_c, ts.cpu(), ys.cpu())(params_c)
    if not torch.isfinite(r0).all() or r0.shape != (ys.numel() + 1,):
        raise AssertionError(f"initial residuals not finite or of shape {tuple(r0.shape)}")
    dr = (r0.cpu() - r0_c).abs().max().item()
    if dr > 1e-3:
        raise AssertionError(f"kernel-path residuals differ from the plain path by {dr}")
    loss0 = float(torch.sum(r0 * r0))
    log(f"[main] residuals {tuple(r0.shape)}, kernel path vs plain path max|diff| {dr:.3e}")

    # the first LM Jacobian (forward mode through the adaptive solve) against
    # the plain path's on the CPU, both float32, on the ODE rows: the last row
    # (the zero-sum penalty, entries of 100) passes through neither kernel.
    # The solves run at rtol 1e-4: where the two paths' rounding flips an
    # accept/reject, the step sequence and with it the sensitivities move at
    # that order, so the bound is 1e-3 of the ODE rows' largest entry
    x0, unravel = ravel_pytree(params0)
    J = torch.func.jacfwd(lambda x: residuals(unravel(x)))(x0)
    xc, unravel_c = ravel_pytree(params_c)
    res_c = _residual_fn(rhs_c, ts.cpu(), ys.cpu())
    J_c = torch.func.jacfwd(lambda x: res_c(unravel_c(x)))(xc)
    diff = (J.cpu() - J_c)[:-1].abs()
    scale = J_c[:-1].abs().max().item()
    dJ = diff.max().item() / scale
    if not (torch.isfinite(J).all() and dJ <= 1e-3):
        raise AssertionError(f"first Jacobian: kernel path vs plain path relative {dJ:.3e} > 1e-3")
    log(f"[main] first Jacobian {tuple(J.shape)}, ODE rows: kernel path vs plain CPU path "
        f"max|diff| {diff.max().item():.3e}, / max|J| ({scale:.4f}) {dJ:.3e} (bound 1e-3)")

    n_params = x0.numel()
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    res, wall, walls = _timed_lm(residuals, params0, maxiters=5)
    launches = {"a": stencil.launches, "b": stencil.tangent_launches,
                "generic": stencil.generic_launches}
    final = float(res.loss)
    log(f"[main] LM mlp ({n_params} params): loss {loss0:.6g} -> {final:.6g} in "
        f"{res.iterations} iterations, {wall:.2f} s; per iteration "
        f"{', '.join(f'{w:.3f}' for w in walls)} s")
    log(f"[main] launches during LM: kernel A {launches['a']}, kernel B {launches['b']}, "
        f"runtime-width {launches['generic']}")
    if launches["a"] <= 0 or launches["b"] <= 0:
        raise AssertionError("the main path did not launch both fused RHS kernels")
    if launches["generic"]:
        raise AssertionError("the paper net ran the runtime-width kernels, not its compiled ones")
    if not (math.isfinite(final) and final <= loss0):
        raise AssertionError(f"final loss {final} not finite or above the initial {loss0}")
    flat = ravel_pytree(res.params)[0]
    if not torch.isfinite(flat).all():
        raise AssertionError("final parameters not finite")
    return launches, walls, ts, ys


def phase_bench_task(device, card, ts, ys):
    import torch
    from universal_differential_equations_torch.models import fisher_kpp as fk

    rhs, params0 = fk.make_model(torch.Generator().manual_seed(0), "fourier", device=device)
    res, wall, walls = _timed_lm(_residual_fn(rhs, ts, ys), params0, maxiters=100,
                                 loss_tol=0.01)
    loss = float(res.loss)
    log(f"[bench] fourier train-to-loss 0.01 on the port: loss {loss:.6g} in "
        f"{res.iterations} LM iterations, {wall:.2f} s wall "
        f"(median iteration {statistics.median(walls):.3f} s) on {card}")
    if not loss < 0.01:
        raise AssertionError(f"fourier LM did not reach loss < 0.01: {loss}")


def _sync():
    import torch

    torch.cuda.synchronize()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)
    log(msg)


def phase_lv(device, card):
    """Phase 6: Lotka-Volterra scenario 1 on the card (see the module docstring)."""
    import numpy as np
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch import sindy as sd
    from universal_differential_equations_torch.examples import lv_scenario_1 as scen
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import lotka_volterra as lv
    from universal_differential_equations_torch.ops import stencil

    f64 = torch.float64
    stencil.launches = stencil.tangent_launches = 0
    t_phase = time.perf_counter()

    # (a) truth: Vern7 at 1e-12 in float64 (raises unless the solve succeeded)
    t0 = time.perf_counter()
    ts64, X_true, X_noisy64 = lv.generate_data(torch.Generator().manual_seed(scen.SEED),
                                               device=device)
    _sync()
    wall = time.perf_counter() - t0
    _, X_cpu, Xn_cpu = lv.generate_data(torch.Generator().manual_seed(scen.SEED))
    err = float((X_true.cpu() - X_cpu).abs().max())
    _check(err <= 1e-10 and X_true.device == device,
           f"[lv a] Vern7 truth {tuple(X_true.shape)} float64 on {X_true.device} in "
           f"{wall:.3f} s; max|card - cpu| {err:.3e} (bound 1e-10)")
    ts32, Xn32 = ts64.float(), X_noisy64.float()

    # (b) the interpolating-adjoint gradient of the scenario's loss
    rhs, params0, _ = lv.make_ude(torch.Generator().manual_seed(0), device=device)
    flat32, unravel = ravel_pytree(params0)

    def grad(flat, X, ts, tol, adjoint):
        x = flat.detach().clone().requires_grad_(True)
        sol = ude.solve(ude.ODEProblem(rhs, X[0], (0.0, 3.0), unravel(x)), ude.Tsit5(),
                        saveat=ts, rtol=tol, atol=tol, adjoint=adjoint)
        loss = torch.mean((sol.ys - X) ** 2)
        (g,) = torch.autograd.grad(loss, x)
        return loss.detach(), g

    def median_s(fn, calls=10):
        walls = []
        for _ in range(calls):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls)

    interp, disc = ude.InterpolatingAdjoint(), ude.DiscreteAdjoint()
    _, g_i32 = grad(flat32, Xn32, ts32, 1e-6, interp)
    _, g_d32 = grad(flat32, Xn32, ts32, 1e-6, disc)
    r32 = _rel(g_i32, g_d32)
    flat64 = flat32.double()
    _, g_i64 = grad(flat64, X_noisy64, ts64, 1e-8, interp)
    _, g_d64 = grad(flat64, X_noisy64, ts64, 1e-8, disc)
    r64 = _rel(g_i64, g_d64)
    x_c = flat64.cpu().requires_grad_(True)
    sol_c = ude.solve(ude.ODEProblem(rhs, Xn_cpu[0], (0.0, 3.0), unravel(x_c)), ude.Tsit5(),
                      saveat=ts64.cpu(), rtol=1e-8, atol=1e-8, adjoint=interp)
    (g_cpu,) = torch.autograd.grad(torch.mean((sol_c.ys - Xn_cpu) ** 2), x_c)
    r_cpu = _rel(g_i64.cpu(), g_cpu)
    # torch.func.grad through solve()'s default adjoint equals torch.autograd's
    g_fn = torch.func.grad(lambda x: torch.mean((ude.solve(
        ude.ODEProblem(rhs, X_noisy64[0], (0.0, 3.0), unravel(x)), ude.Tsit5(), saveat=ts64,
        rtol=1e-8, atol=1e-8).ys - X_noisy64) ** 2))(flat64)
    r_fn = _rel(g_fn, g_i64)
    s32 = median_s(lambda: grad(flat32, Xn32, ts32, 1e-6, interp))
    s64 = median_s(lambda: grad(flat64, X_noisy64, ts64, 1e-8, interp))
    _check(torch.isfinite(g_i32).all() and r32 <= 1e-3 and r64 <= 1e-6 and r_cpu <= 1e-9
           and r_fn <= 1e-12,
           f"[lv b] interpolating-adjoint gradient ({flat32.numel()} params): f32 vs "
           f"discrete rel {r32:.3e} (1e-3), f64 vs discrete rel {r64:.3e} (1e-6), "
           f"f64 card vs cpu rel {r_cpu:.3e} (1e-9), torch.func.grad vs autograd rel "
           f"{r_fn:.3e} (1e-12)")
    log(f"[lv b] seconds per gradient, median of 10: float32 {s32:.4f} s "
        f"({1 / s32:.3f} grad steps/s), float64 {s64:.4f} s on {card}")

    # (c) short training through the pipeline's loss: 20 ADAM steps (float32),
    # then 20 BFGS iterations (float64)
    t0 = time.perf_counter()
    loss32 = scen.make_loss(rhs, Xn32, ts32, 1e-6)
    l0 = float(loss32(params0))
    res1 = ude.fit(loss32, params0, lambda ps: torch.optim.Adam(ps, lr=0.1), 20,
                   callback_every=20)
    _sync()
    t_adam = time.perf_counter() - t0
    loss64 = scen.make_loss(rhs, X_noisy64, ts64, 1e-8)
    p64 = [{k: v.double() for k, v in layer.items()} for layer in res1.params]
    l1 = float(loss64(p64))
    t0 = time.perf_counter()
    res2 = ude.bfgs_minimize(loss64, p64, maxiters=20, initial_stepnorm=0.01, gtol=1e-12)
    _sync()
    t_bfgs = time.perf_counter() - t0
    l2 = float(res2.value)
    _check(math.isfinite(l2) and res1.final_loss < l0 and l2 < l1,
           f"[lv c] ADAM 20 steps (f32): loss {l0:.6g} -> {res1.final_loss:.6g} in "
           f"{t_adam:.2f} s; BFGS {int(res2.iterations)} iterations, "
           f"{int(res2.num_evals)} evaluations (f64): {l1:.6g} -> {l2:.6g} in {t_bfgs:.2f} s")

    # (d) SINDy on the true interactions
    basis = scen.scenario_basis()
    xy = X_true[:, 0] * X_true[:, 1]
    P = lv.P_TRUE.to(device)
    Y = torch.stack([-P[1] * xy, P[2] * xy], -1)
    t0 = time.perf_counter()
    res_sd = sd.sindy(sd.DirectDataDrivenProblem(X_true, Y), basis, sd.STLSQ(scen.LAMS),
                      normalize=True)
    t_sd = time.perf_counter() - t0
    j = basis.names.index("u1*u2")
    only_xy = all(np.flatnonzero(res_sd.active[:, e]).tolist() == [j] for e in (0, 1))
    cerr = float(np.abs(res_sd.coefficients[j] - np.array([-0.9, 0.8])).max())
    _check(only_xy and cerr <= 1e-6,
           f"[lv d] SINDy on the true interactions in {t_sd:.2f} s: "
           f"{res_sd.equations()}; max coefficient error {cerr:.3e} (1e-6)")

    # (e) the pipeline's refit of the recovered model on the noisy data, and its
    # extrapolation to t = 50 (which raises unless both solves finished)
    rec_rhs = lv.make_recovered_rhs(res_sd)
    u0 = X_noisy64[0]
    t0 = time.perf_counter()
    res3 = scen.refit(rec_rhs, torch.as_tensor(res_sd.parameters(), dtype=f64, device=device),
                      u0, X_noisy64, ts64, maxiters=50)
    ys_ex, per_rec, per_tru = scen.extrapolate(rec_rhs, res3.params, u0)
    _sync()
    t_ex = time.perf_counter() - t0
    per_err = abs(per_rec - per_tru) / per_tru
    _check(per_err <= 0.1 and bool(torch.isfinite(ys_ex).all()),
           f"[lv e] refit {int(res3.iterations)} BFGS iterations: loss {float(res3.value):.6g}, "
           f"params {res3.params.cpu().numpy()}; t=50 extrapolation finished, period "
           f"error {per_err:.3%} (10 %), {t_ex:.2f} s")

    # (f) the pipeline's lane-batched refit judge against single-lane runs
    C_true = torch.zeros(len(basis), 2, dtype=f64, device=device)
    C_true[j] = torch.tensor([-0.9, 0.8], dtype=f64, device=device)
    gen = torch.Generator().manual_seed(5)
    C0 = torch.stack([C_true + 0.05 * torch.randn(C_true.shape, generator=gen, dtype=f64)
                      .to(device) * (C_true != 0) for _ in range(4)])
    C0[1, basis.names.index("u1")] = torch.tensor([0.05, -0.02], dtype=f64, device=device)
    mask = (C0 != 0).to(f64)
    kw = dict(maxiters=5, initial_stepnorm=0.01)
    t0 = time.perf_counter()
    lanes = ude.bfgs_minimize_lanes(scen.judge_loss(basis, u0, X_noisy64, ts64, mask), C0, **kw)
    _sync()
    t_lanes = time.perf_counter() - t0
    worst, iters = 0.0, []
    t0 = time.perf_counter()
    for lane in range(4):
        single = ude.bfgs_minimize(scen.judge_loss(basis, u0, X_noisy64, ts64, mask[lane]),
                                   C0[lane], **kw)
        iters.append((int(lanes.iterations[lane]), int(single.iterations)))
        worst = max(worst, float((lanes.params[lane] - single.params).abs().max()),
                    abs(float(lanes.value[lane] - single.value)))
    _sync()
    t_single = time.perf_counter() - t0
    _check(worst <= 1e-10 and all(a == b for a, b in iters),
           f"[lv f] 4-lane BFGS over integrate_fixed vs 4 single-lane runs: iterations "
           f"{iters}, max|diff| {worst:.3e} (1e-10); {t_lanes:.2f} s batched, "
           f"{t_single:.2f} s serial")
    log(f"[lv] fused RHS kernel launches during phase 6: A {stencil.launches}, B "
        f"{stencil.tangent_launches} (this path runs no hand-written kernel); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


def main():
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke.py: the package {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    card = phase_device()
    device = torch.device("cuda", 0)
    import universal_differential_equations_torch  # noqa: F401  (sets TF32 off)

    phase_build()
    kern = phase_kernel(device)
    launches, _, ts, ys = phase_main_path(device)
    phase_bench_task(device, card, ts, ys)
    phase_lv(device, card)

    # each kernel at the main path's shape: N = 26, and T = 465 directions
    k_ms, p_ms, b_ms, b_by = kern["a"][(PAPER, 26)]
    kb_ms, pb_ms, bb_ms, bb_by = kern["b"][(PAPER, 465, 26)]
    source = f"{PKG}/csrc/updet_rhs.cu"
    print(json.dumps({"kernels": [{
        "name": "fused_updet_rhs",
        "route": "cuda",
        "source": source,
        "replaces": "universal_differential_equations_tpu/ops/pallas_stencil.py:58",
        "launches": launches["a"],
        "max_abs_err": kern["err_a"],
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }, {
        "name": "fused_updet_rhs_tangent",
        "route": "cuda",
        "source": source,
        "replaces": "universal_differential_equations_tpu/ops/pallas_stencil.py:153",
        "launches": launches["b"],
        "max_abs_err": kern["err_b"],
        "ms": kb_ms,
        "plain_ms": pb_ms,
        "bound_ms": bb_ms,
        "bound_by": bb_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

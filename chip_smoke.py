#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``universal_differential_equations_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA card must be present (it never carries on on the CPU).
   Prints ``nvidia-smi``'s name and power limit and the torch/CUDA versions.
2. Build: compiles ``csrc/updet_rhs.cu`` with ``nvcc`` for ``sm_90a`` from the
   checkout's sources and prints the build seconds and ``ptxas`` report.
3. Kernel against plain, on the card, in float32 (rtol = atol = 2e-5): the
   fused reaction+stencil RHS at the MLP widths (1,10,20,10,1) and (1,3,1),
   N in {26, 1024, 131072, 1048576}, a (8, 1024) batch, the periodic wrap,
   and ``FusedUpdetRHS``'s JVP and gradient.  Prints CUDA-event medians of
   kernel and plain times.
4. The main path: Fisher-KPP truth data, the paper's MLP model, and 5
   Levenberg-Marquardt iterations with forward-mode Jacobians through the
   adaptive Tsit5 stepper, all on ``cuda:0`` in float32.  The kernel's launch
   counter is zeroed just before and must be positive after; the final loss
   must be finite and no larger than the initial one.
5. ``bench.py``'s task on the port: the Fourier variant trained by LM to
   loss < 0.01 (at most 100 iterations), timed.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "universal_differential_equations_torch"
TOL = dict(rtol=2e-5, atol=2e-5)
PAPER = (1, 10, 20, 10, 1)
SIZES = (PAPER, (1, 3, 1))
NS = (26, 1024, 131072, 1048576)


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


def phase_build():
    from universal_differential_equations_torch.ops import _build

    info = _build.build(force=True)
    _build.load()
    log(f"[build] nvcc sm_90a -> {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")


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


def phase_kernel(device):
    import torch
    from universal_differential_equations_torch.ops import stencil

    max_err = 0.0
    timing = {}
    for sizes in SIZES:
        for n in NS:
            args = _inputs(n, n, sizes, device)
            out = stencil.fused_updet_rhs(*args)
            ref = stencil.updet_rhs_torch(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            torch.testing.assert_close(out, ref, **TOL)
            max_err = max(max_err, err)
            k_ms = _median_ms(lambda: stencil.fused_updet_rhs(*args))
            p_ms = _median_ms(lambda: stencil.updet_rhs_torch(*args))
            timing[(sizes, n)] = (k_ms, p_ms)
            log(f"[kernel] widths {sizes} N={n:>8}: max|kernel-plain| {err:.3e}  "
                f"kernel {k_ms * 1e3:9.2f} us  plain {p_ms * 1e3:9.2f} us  "
                f"({n * 8 / (k_ms * 1e-3) / 1e9:8.2f} GB/s of u+out)")
    args = _inputs(7, 1024, PAPER, device, rows=8)
    out = stencil.fused_updet_rhs(*args)
    ref = stencil.updet_rhs_torch(*args)
    torch.testing.assert_close(out, ref, **TOL)
    err = (out - ref).abs().max().item()
    max_err = max(max_err, err)
    log(f"[kernel] batched (8, 1024): max|kernel-plain| {err:.3e}")

    zero_mlp = [(torch.zeros(1, 1, device=device), torch.zeros(1, device=device))]
    for n in (26, 1024):
        for idx in (0, n - 1):
            u = torch.zeros(n, device=device)
            u[idx] = 1.0
            for taps, shift in (([1.0, 0.0, 0.0], 1), ([0.0, 0.0, 1.0], -1)):
                out = stencil.fused_updet_rhs(u, torch.tensor(taps, device=device),
                                              torch.tensor(1.0, device=device), zero_mlp)
                if not torch.equal(out, torch.roll(u, shift)):
                    raise AssertionError(f"periodic wrap wrong: N={n}, one-hot at {idx}, "
                                         f"shift {shift}")
    log("[kernel] periodic wrap: one-hot at 0 and N-1, N in (26, 1024): exact")

    u, taps, d0, mlp = _inputs(11, 1024, PAPER, device)
    primals = (u, taps, d0, *[x for wb in mlp for x in wb])
    g = torch.Generator().manual_seed(12)
    tangents = tuple(torch.randn(p.shape, generator=g).to(device) for p in primals)

    def plain(u_, t_, d_, *f):
        return stencil.updet_rhs_torch(u_, t_, d_, stencil._pairs(f))

    _, jvp_k = torch.func.jvp(stencil.FusedUpdetRHS.apply, primals, tangents)
    _, jvp_p = torch.func.jvp(plain, primals, tangents)
    torch.testing.assert_close(jvp_k, jvp_p, rtol=1e-4, atol=1e-4)
    leaves = [p.clone().requires_grad_(True) for p in primals]
    grads_k = torch.autograd.grad((stencil.FusedUpdetRHS.apply(*leaves) ** 2).sum(), leaves)
    grads_p = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    worst = 0.0
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)
        worst = max(worst, ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item())
    log(f"[kernel] FusedUpdetRHS jvp max|diff| {(jvp_k - jvp_p).abs().max().item():.3e}, "
        f"grad worst relative diff {worst:.3e} (rtol 1e-4)")
    return max_err, timing


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

    n_params = ravel_pytree(params0)[0].numel()
    stencil.launches = 0
    res, wall, walls = _timed_lm(residuals, params0, maxiters=5)
    launches = stencil.launches
    final = float(res.loss)
    log(f"[main] LM mlp ({n_params} params): loss {loss0:.6g} -> {final:.6g} in "
        f"{res.iterations} iterations, {wall:.2f} s; per iteration "
        f"{', '.join(f'{w:.3f}' for w in walls)} s")
    log(f"[main] fused RHS kernel launches during LM: {launches}")
    if launches <= 0:
        raise AssertionError("the main path did not launch the fused RHS kernel")
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
    max_err, timing = phase_kernel(device)
    launches, _, ts, ys = phase_main_path(device)
    phase_bench_task(device, card, ts, ys)

    k_ms, p_ms = timing[(PAPER, 26)]
    print(json.dumps({"kernels": [{
        "name": "fused_updet_rhs",
        "route": "cuda",
        "source": f"{PKG}/csrc/updet_rhs.cu",
        "replaces": "universal_differential_equations_tpu/ops/pallas_stencil.py:58",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

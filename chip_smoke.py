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
5. ``bench.py``'s task on the port, through the port benchmark's own
   ``train_run`` (``universal_differential_equations_torch/bench.py``) for
   seed 0: the Fourier variant trained by LM to loss < 0.01 (at most 100
   iterations), timed.
6. Lotka-Volterra scenario 1 on the card, every stage on ``cuda:0`` (this
   path runs no hand-written kernel; the kernels' counters are zeroed before
   and reported after):
   (a) Vern7 truth at 1e-12 in float64, equal to the CPU's to 1e-10;
   (b) the interpolating-adjoint gradient of the scenario's loss for the
       full 2→5→5→5→2 RBF model against the discrete adjoint (float32 at
       1e-6: relative 1e-3; float64 at 1e-8: relative 1e-6), against the
       CPU float64 port (relative 1e-9) and under ``torch.func.grad``
       (relative 1e-12), with the median seconds per gradient over 3 calls;
   (c) 5 ADAM steps (float32) and 3 BFGS iterations (float64): the loss is
       finite and falls;
   (d) SINDy (polynomial degree 5 + sin, the scenario's λ grid) on the true
       interactions selects exactly x·y per equation, at −0.9 and 0.8 to 1e-6;
   (e) that model refit by BFGS (≤ 50 iterations) on the noisy data and
       extrapolated to t = 50: the solve succeeds and the period is within
       10 % of the truth's;
   (f) a 4-lane ``bfgs_minimize_lanes`` over ``integrate_fixed`` equals the
       four single-lane ``bfgs_minimize`` runs to 1e-10 (float64, 2
       iterations).
   (c), (e) and (f) call the pipeline's own stages
   (``examples/lv_scenario_1.py``: ``make_loss``, ``refit``, ``extrapolate``,
   ``judge_loss``).
7. Lanes and shooting: ``torch.func.vmap`` over adaptive solves on the card.
   (a) 8 Lotka-Volterra lanes (float64, rtol 1e-8) under each adjoint: every
       lane takes its solo solve's accepted/rejected/RHS counts exactly, and
       its saved states to 1e-12 relative; ``vmap`` of ``grad`` equals the
       solo gradients (two lanes) to 1e-10 for the discrete and the three
       continuous adjoints;
   (b) 8 Fisher-KPP initial conditions of the MLP model (float32) in one
       vmapped solve: kernel A launches with rows = 8 (its multi-row grid),
       each lane's states agree with its solo solve's and with the plain
       RHS's vmapped solve on the CPU to 1e-3 of their largest value (rtol
       1e-4 in float32: a rounding difference may flip an accept/reject; the
       lanes with the solo solve's step counts are reported);
   (c) the Hudson Bay shooting loss's gradient (``examples/hudson_bay.py``'s
       ``shooting_loss``: one vmapped solve over 5 segments) in float32 and
       float64, against a Python loop over the 5 segment solves (float64,
       1e-10), timed;
   (d) two scenario-2 LM iterations (``examples/lv_scenario_2.py``'s
       residuals, 5 vmapped ``ForwardSensitivity`` segments under
       ``jacfwd``, float32): the loss is finite and does not rise.

8. Slice C2 and LV scenario 3 on the card (these paths run no hand-written
   kernel; the kernels' counters are zeroed before and must read 0 after),
   through the pipelines' own stages (``examples/seir_exposure.py``,
   ``examples/lv_scenario_3.py``):
   (a) the SEIR truth (Vern7, 1e-10/1e-12, steps on the save grid) in
       float64, equal to the CPU's to 1e-9 relative;
   (b) per variant, the training loss's gradient at full width (9,157 and
       4,481 parameters, float32, rtol 1e-6): interpolating against discrete
       adjoint within 1e-3 relative, with the median seconds of 2 calls;
   (c) per variant, ``train_variant`` with 5 ADAM steps and 5 BFGS
       iterations, with seconds per step and iteration: the loss is finite
       and falls below the initial one for the neural ODE; for the exposure
       UDE, whose first ADAM(0.01) steps overshoot, BFGS lowers ADAM's;
   (d) the weak pair with the SEIR features (float64) equal to the CPU's to
       1e-10 relative; the ideal-recovery SINDy selects the CPU's support;
   (e) the UDE arm's ladder and refit judge (``refit_all``, 5 refit
       iterations; the script's widths, float32): finite, timed; the ideal
       model's day-60 extrapolation finishes;
   (f) ``stability_selection``'s frequencies for one row mask and
       ``two_stage_recovery`` equal the CPU's to 1e-12 (float64);
   (g) scenario 3 in float32: 10 ADAM steps and 2 LM iterations leave a
       finite, non-rising loss; SINDy on pairs from the true reaction
       u(1−u) recovers it within 1e-3 on [0, 1].
9. The Fisher-KPP case study (``examples/fisher_kpp.py``), MLP variant,
   seed 0, float32: (a) one ADAM gradient of its loss through kernel A and
   ``FusedUpdetRHS``'s reverse rule equals the same gradient with the fused
   dispatch off (the plain RHS, on the card) to 1e-4 relative, timed against
   it; (b) the example's ``train`` with 5 ADAM steps and 3 LM iterations, the
   launch counters zeroed before and read after each stage: kernel A
   launches under ADAM, A and B under LM, the runtime-width count is 0 and
   the loss falls.
10. The ensemble runner (``ensemble/runner.py``): ``ensemble_run`` over
    Lotka-Volterra lanes whose initial states carry ``noise_schedule``'s
    levels (float32, rtol 1e-6), at L = 64 and L = 500 lanes drawn evenly
    from the 500-run study: every lane succeeds, 3 lanes equal their solo
    solves to 1e-5 relative, and the CUDA kernels (``torch.profiler``) at
    L = 500 are at most 1.5 times those at L = 64; wall, kernels and peak
    device memory are printed for each.
11. The new public surface: Dopri5, Bosh3, Heun (adaptive, rtol 1e-4) and
    Euler (1000 fixed steps) solve Lotka-Volterra on the card in float32 and
    match the port's float64 CPU solve to 1e-4 relative; ``StencilConv1D``
    (1e-6) and ``neural_ode`` (1e-4) match float64 CPU runs; a
    ``KeyedArchive`` and a ``save_pytree``/``load_pytree`` round-trip to the
    card in a temporary directory are exact.

12. The Lotka-Volterra 500-lane noise study (``examples/run_loops.py``) at
    full width on the 25 lanes the JAX study trained for
    ``lane_theta_samples.npz`` (lanes 0-4 of each level), its inputs from
    the JAX draw (``examples/data/lv_study_lanes.npz``), float32:
    (a) 10 ADAM steps, one BFGS round of 10 iterations and one LM round of
        3 iterations, on the card (their evaluations replayed as CUDA graphs,
        captured by a first call; ADAM's and BFGS's hold the lane kernel of
        ``ops/lv_lanes.py``) and on the CPU: every lane's loss (each
        stage's parameters scored by ``mean_loss``) is finite and does not
        rise from stage to stage, and the card's losses after
        ADAM equal the CPU's to 1e-4 relative; seconds per ADAM step, BFGS
        and LM iteration at 25 lanes, and per ADAM step and LM iteration at
        500 lanes;
    (b) ``recover_stage`` from the 25 archived trained weights: the card
        selects the CPU's supports on every lane (the agreement with the JAX
        ``recover_stage`` on the same weights, recorded in
        ``examples/data/lv_study_recover.npz``, and with the JAX study's
        trained arm is printed); the selections of (b) and (c) run in
        worker processes, one per stage and device: the CPU's from the
        phase's start, the card's side by side after (a), which only their
        start-up overlaps;
    (c) ``oracle_stage`` and ``weak_stage``: the card selects the CPU's
        supports, and at least 23 of 25 lanes per arm select the active sets
        the JAX study archived (``loop_study.npz``);
    (d) neither fused kernel launched, and the lane kernel did;
    (e) the lane kernel (``loss_and_grad`` on the card) against the graphed
        plain path (autograd through ``mean_loss``) on the same lanes, at 25
        and 500 lanes, each lane's loss and each gradient element (relative
        to the lane's gradient norm) within ``LANE_PLAIN_TOL``, and against
        the JAX package's float64 result on 25 lanes
        (``tests/data/lv_lanes_jax.npz``) within ``LANE_JAX_TOL``; CUDA-event
        milliseconds of one launch and of one plain replay at 500 lanes; in
        5 profiled ADAM steps the program counter ``lane_loss.kernel``
        equals the graph's replays.
13. The climate case study (``examples/climate_*.py``, ``models/climate_*``,
    the stabilized solvers), on the card against the CPU port; this path
    runs no hand-written kernel (both counters must read 0 after it):
    (a) ROCK4, ROCK2, RKC2 and RKC1 solves of the 32-level column's truth
        (``getops(32)``, ``true_rhs``, t in [0, 1.5], the solvers sized as
        the scripts size them): float64 at rtol 1e-5 with the CPU's
        accepted/rejected/RHS counts and its save values to 1e-9 relative,
        float32 at rtol 1e-4 within 1e-3 relative of the CPU's float32
        solve; no accepted step longer than ``dt_stab``;
    (b) ``climate_neural_pde`` at full width (30→8→30, 518 parameters,
        float32): one LM iteration leaves a finite, non-rising loss; the
        interpolating adjoint's loss and gradient, timed over 3 calls
        (``climate_adjoint_loss_grad``; the reference's Julia run 0.879 s),
        and in float64 equal to the CPU's to 1e-8 relative;
    (c) one RT chunk (10 Heun/Leray steps) at 128×2×128 from a random
        velocity state, periodic and rigid-lid, float32 within 1e-4
        relative of the CPU's; then the step times ``rt_datagen_ms_per_step``
        and ``rt_rigid_lid_ms_per_step`` at 128×2×128 (the reference's
        Julia run 8.5 ms) and ``tracer_datagen_ms_per_step_128cubed``
        (CUDA events, minimum of 5 chunks after a warm-up);
    (d) the committed JAX checkpoint ``examples/climate/data/dbdt_nn.npz``:
        its one-step loss over the 40 committed pairs and its 40-step
        rollout rel-L2 on the card within 1e-4 / 2e-3 of the CPU's, and the
        seconds per ADAM step of ``climate_training_rt``'s 40-pair vmapped
        loss.

14. Slice F, the stiff solvers, the BDF DAE solver and the FENE-P case study
    (``solvers/{rosenbrock,sdirk,esdirk,bdf}.py``, ``models/fenep.py``,
    ``examples/fenep.py``), on the card against the CPU port; the CPU
    references run in a worker process beside the card's work; this path
    runs no hand-written kernel (both counters must read 0 after it):
    (a) Robertson to t = 1e4 with Rosenbrock23, SDIRK3, Kvaerno3 and SDIRK4
        (float64, rtol 1e-6, atol 1e-10, ``NoAdjoint``): the CPU's accepted,
        rejected and RHS counts, ``y_final`` within 1e-9 relative of the
        CPU's and 1e-4 of the scipy Radau value, mass conserved to 1e-9;
    (b) the FENE-P truth through ``find_sigma_exact`` (50 points over one 2π
        cycle, γ̇ = 12·cos t, float32 inputs, ``x64_host=True``): the BDF
        solve runs in float64 on the card and returns float32 there, with
        the CPU's counts and τ12 within 1e-9 of its max|τ12|; the startup
        slope dτ12/dt(0) is 24 within 5 %; ``solve(DAEProblem)`` equals
        ``daeint`` with ``solve``'s defaults;
    (c) the ``DiscreteAdjoint`` gradient through Kvaerno3 and Rosenbrock23
        (float64, the decay problem of ``tests/test_stiff_dae.py:45-57``)
        equals the CPU's to 1e-8 relative; SDIRK4 on the index-1 reduction
        reproduces (b)'s BDF truth on its first 20 points (t ≤ 2.5) within
        1e-3;
    (d) ``fenep_surrogate_us_per_solve`` (``benchmarks/fenep_bench.py``'s
        configuration: one 2π cycle, 50 save points, Tsit5 at rtol 1e-5,
        atol 1e-7, ``NoAdjoint``, untrained ``make_surrogate`` weights;
        best of 5 after a warm-up) and ``dae_us_per_solve`` (the truth of
        (b), best of 2 after (b)'s identical call), and the seconds of one
        FENE-P ADAM step (``examples/fenep.py``'s loss over its 6 modes,
        ``DiscreteAdjoint``, float32; one step after a warm-up step).

15. Slice G, the SDE solvers, the deep-BSDE trainer and the 100-D HJB
    (``solvers/sde.py``, ``deepbsde/``, ``examples/hjb_100d.py``), on the
    card against the CPU port; the CPU references run in a worker process
    beside the card's work; this path runs no hand-written kernel (both
    counters must read 0 after it):
    (a) ``sdeint`` with EulerMaruyama and EulerHeun on OU (300 steps) and GBM
        (256 steps), 2000 paths in one ``torch.func.vmap`` call each, the
        increments drawn on the CPU and moved: float64 paths equal the CPU's
        to 1e-12 relative, float32 within 1e-5; EM's OU mean and variance at
        T = 3 meet ``tests/test_sde_deepbsde.py:41-42``'s bounds;
    (b) ``AdaptiveEM`` (grid 512, abstol 1e-4, reltol 1e-3) over 400 OU lanes
        in one vmapped call, float64: every lane's ``num_steps`` equals the
        CPU's, ``y_final`` to 1e-12, mean |adaptive − fixed| < 0.02 against
        ``sdeint`` on the same grid; the host reads of the solve are printed;
    (c) the HJB at full width (d = 100, m = 100, ``n_steps`` 20, float32):
        5 ADAM iterations from the same weights and draws, losses within
        1e-4 relative of the CPU's; the AdaptiveEM pilot's grid equals the
        CPU's from the same pilot draws; seconds per iteration at ``n_steps``
        20 and 50 (``utils.profiling.benchmark``, median of 20 after a
        warm-up);
    (d) ``mc_analytical_hjb`` at d = 100, 10^5 samples in float32, from the
        same draws: within 1e-5 relative of the CPU's.

16. Slice H.1, ``parallel/`` and every ``mesh=`` path, on a one-rank NCCL
    process group on ``cuda:0`` (``initialize_distributed`` with a
    ``localhost`` address; its collectives are real NCCL launches): each
    sharded path against its unsharded run on the card:
    (a) ``ensemble_run(sharded=True)`` over 64 LV lanes (float32): outputs
        within 1e-6 relative, the same success flags;
    (b) ``multiple_shoot(mesh=)``'s loss and ``torch.func.grad`` (17 points,
        group 3, float32) within 1e-6;
    (c) the deep-BSDE trainer at the 100-D HJB's width: 5 iterations with
        ``mesh`` on the same draws, losses within 1e-5; seconds per
        iteration with and without the mesh at ``n_steps`` 20 and 50;
    (d) ``run_loops``' recover stage with the study's judge on one chunk,
        the JAX study's 500 lanes after 5 ADAM steps: selections equal,
        coefficients within 1e-6 of the unsharded run, which a worker
        process computes on the same card meanwhile;
    (e) one RT chunk at 128×2×128 for both ``bc``s on the x-decomposed mesh
        (halo exchanges, the slab FFT): fields within 5e-5, and the ms per
        step with and without the mesh;
    (f) ``dryrun_multichip(2)`` on two gloo ranks of the host's CPU in a
        child process, beside (a)–(e): its six surfaces pass.
    The timings of (c) and (e) come first, before the child and the
    worker start.  The
    group is closed before the last lines; kernels A and B launch 0 times.

17. Slice H.2, ``viz.py`` and every example's figures (``--plot``):
    (a) the host's matplotlib and Pillow versions, or that they are absent;
    (b) Fisher-KPP ``mlp``: ``fisher_kpp.train`` with 3 ADAM steps, one LM
        iteration and the training dashboard (``make_dashboard``) as the
        ADAM warmup's ``fit`` callback, which writes ``dashboard.png``;
        kernel A launches under ADAM, A and B under LM; ``write_plots``'
        arrays (``learned_figures``): the reaction curve on 101 constant
        fields within 1e-5 of the plain RHS's on the card, the learned field
        within 1e-4 of the CPU's; the four figures;
    (c) ``run_loops``' ``loop_trajectories`` solves (the truth and six
        recovered models of the JAX archive ``loop_study.npz``, read only)
        within 1e-4 of the CPU's, relative to each run's largest value; the
        study's eight figures from that archive (``plot_archive``);
    (d) scenario 3's reaction curves and the climate column's flux curve,
        card against CPU within 1e-5; every other script's figure function
        on CUDA tensors made from a seed: each JAX file name written and
        non-empty, the GIF included.
    Where matplotlib or Pillow is absent the arrays of (b)–(d) are checked
    and the phase says that it rendered no figure; kernel A launches > 0.

The line before the last is ``{"kernels": [...]}``, one entry per kernel with
its bound on the card (the lane kernel's: its chain's latency, phase 12 (e);
its ``replays``: those of 12 (e)'s profiled steps) (H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s float32); the
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
    return {n: d.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
            for n, d in zip(names, out)}


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
    residuals = fk.make_residuals(rhs, ts, ys)

    # the residuals agree with the same model's plain path (CPU, float32) on
    # the initial parameters; the solves run at rtol=1e-4, so allow 1e-3
    r0 = residuals(params0)
    rhs_c, params_c = fk.make_model(torch.Generator().manual_seed(0), "mlp")
    r0_c = fk.make_residuals(rhs_c, ts.cpu(), ys.cpu())(params_c)
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
    res_c = fk.make_residuals(rhs_c, ts.cpu(), ys.cpu())
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
    """Phase 5: the port benchmark's ``train_run`` for seed 0."""
    import torch
    from universal_differential_equations_torch import bench
    from universal_differential_equations_torch.models import fisher_kpp as fk

    rhs, _ = fk.make_model(torch.Generator().manual_seed(0), "fourier", device=device)
    wall, res = bench.train_run(bench.initial_params(0, device), fk.make_residuals(rhs, ts, ys))
    loss = float(res.loss)
    log(f"[bench] fourier train-to-loss 0.01 on the port (bench.train_run, seed 0): loss "
        f"{loss:.6g} in {res.iterations} LM iterations, {wall:.2f} s wall on {card}")
    if not loss < 0.01:
        raise AssertionError(f"fourier LM did not reach loss < 0.01: {loss}")


def _sync():
    import torch

    torch.cuda.synchronize()


def median_s(fn, calls):
    """Median wall seconds of ``calls`` calls of ``fn``, the card synchronised
    around each."""
    walls = []
    for _ in range(calls):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


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
    s32 = median_s(lambda: grad(flat32, Xn32, ts32, 1e-6, interp), calls=3)
    s64 = median_s(lambda: grad(flat64, X_noisy64, ts64, 1e-8, interp), calls=3)
    _check(torch.isfinite(g_i32).all() and r32 <= 1e-3 and r64 <= 1e-6 and r_cpu <= 1e-9
           and r_fn <= 1e-12,
           f"[lv b] interpolating-adjoint gradient ({flat32.numel()} params): f32 vs "
           f"discrete rel {r32:.3e} (1e-3), f64 vs discrete rel {r64:.3e} (1e-6), "
           f"f64 card vs cpu rel {r_cpu:.3e} (1e-9), torch.func.grad vs autograd rel "
           f"{r_fn:.3e} (1e-12)")
    log(f"[lv b] seconds per gradient, median of 3: float32 {s32:.4f} s "
        f"({1 / s32:.3f} grad steps/s), float64 {s64:.4f} s on {card}")

    # (c) short training through the pipeline's loss: 5 ADAM steps (float32),
    # then 3 BFGS iterations (float64)
    t0 = time.perf_counter()
    loss32 = scen.make_loss(rhs, Xn32, ts32, 1e-6)
    l0 = float(loss32(params0))
    res1 = ude.fit(loss32, params0, lambda ps: torch.optim.Adam(ps, lr=0.1), 5,
                   callback_every=5)
    _sync()
    t_adam = time.perf_counter() - t0
    loss64 = scen.make_loss(rhs, X_noisy64, ts64, 1e-8)
    p64 = [{k: v.double() for k, v in layer.items()} for layer in res1.params]
    l1 = float(loss64(p64))
    t0 = time.perf_counter()
    res2 = ude.bfgs_minimize(loss64, p64, maxiters=3, initial_stepnorm=0.01, gtol=1e-12)
    _sync()
    t_bfgs = time.perf_counter() - t0
    l2 = float(res2.value)
    _check(math.isfinite(l2) and res1.final_loss < l0 and l2 < l1,
           f"[lv c] ADAM 5 steps (f32): loss {l0:.6g} -> {res1.final_loss:.6g} in "
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
    kw = dict(maxiters=2, initial_stepnorm=0.01)
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


def phase_lanes(device, card):
    """Phase 7: lanes and shooting (see the module docstring)."""
    import numpy as np
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.examples import hudson_bay as hb
    from universal_differential_equations_torch.examples import lv_scenario_2 as s2
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import fisher_kpp as fk
    from universal_differential_equations_torch.models import lotka_volterra as lv
    from universal_differential_equations_torch.ops import stencil

    f64 = torch.float64
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    t_phase = time.perf_counter()

    # (a) 8 LV lanes, each adjoint
    rng = np.random.default_rng(7)
    u0s = torch.tensor(rng.uniform(0.5, 3.0, (8, 2)), dtype=f64, device=device)
    ps = torch.tensor(np.array([1.3, 0.9, 0.8, 1.8]) * rng.uniform(0.8, 1.2, (8, 4)),
                      dtype=f64, device=device)
    ts = torch.linspace(0.0, 3.0, 7, dtype=f64, device=device)

    def lv_solve(u0, p, adj):
        sol = ude.solve(ude.ODEProblem(lv.lotka_rhs, u0, (0.0, 3.0), p), ude.Tsit5(),
                        saveat=ts, rtol=1e-8, atol=1e-8, adjoint=adj)
        return sol.ys, sol.num_accepted, sol.num_rejected, sol.num_rhs_evals

    def lv_loss(adj):
        return lambda p, u0: (lv_solve(u0, p, adj)[0] ** 2).sum()

    t0 = time.perf_counter()
    worst, steps = 0.0, {}
    for name in ("NoAdjoint", "DiscreteAdjoint", "ForwardSensitivity", "InterpolatingAdjoint",
                 "BacksolveAdjoint", "QuadratureAdjoint"):
        adj = getattr(ude, name)()
        ys, n_acc, n_rej, nfe = torch.func.vmap(lambda u0, p: lv_solve(u0, p, adj))(u0s, ps)
        for i in range(8):
            s_ys, *counts = lv_solve(u0s[i], ps[i], adj)
            if [int(c) for c in counts] != [int(n_acc[i]), int(n_rej[i]), int(nfe[i])]:
                raise AssertionError(f"[lanes a] {name} lane {i}: counts "
                                     f"{[int(n_acc[i]), int(n_rej[i]), int(nfe[i])]} vs solo "
                                     f"{[int(c) for c in counts]}")
            worst = max(worst, _rel(ys[i], s_ys))
        steps[name] = n_acc.tolist()
    g_worst = 0.0
    for name in ("DiscreteAdjoint", "InterpolatingAdjoint", "BacksolveAdjoint",
                 "QuadratureAdjoint"):
        loss = lv_loss(getattr(ude, name)())
        g = torch.func.vmap(torch.func.grad(loss))(ps, u0s)
        for i in (0, 7):
            g_worst = max(g_worst, _rel(g[i], torch.func.grad(loss)(ps[i], u0s[i])))
    _sync()
    _check(worst <= 1e-12 and g_worst <= 1e-10,
           f"[lanes a] 8 LV lanes x 6 adjoints: per-lane counts equal the solo solves' "
           f"(accepted {steps['NoAdjoint']}); states max rel {worst:.3e} (1e-12); vmap(grad) "
           f"vs solo max rel {g_worst:.3e} (1e-10); {time.perf_counter() - t0:.1f} s")

    # (b) 8 Fisher-KPP initial conditions through kernel A's rows
    ts_fk, ys_fk = fk.generate_data(device=device)
    rhs, params = fk.make_model(torch.Generator().manual_seed(0), "mlp", device=device)
    scale = torch.linspace(0.6, 1.3, 8, device=device)[:, None]
    u0s_fk = ys_fk[0] * scale

    def fk_solve(rhs_, p, u0, ts_):
        sol = ude.solve(ude.ODEProblem(rhs_, u0, (0.0, fk.T_END), p), ude.Tsit5(), saveat=ts_,
                        rtol=1e-4, atol=1e-6, adjoint=ude.NoAdjoint())
        return sol.ys, sol.num_accepted, sol.num_rejected

    rows = Counter()
    launch, a_before = stencil._launch, stencil.launches

    def spy(u, *args, **kw):
        rows[1 if u.ndim == 1 else u.shape[0]] += 1
        return launch(u, *args, **kw)

    stencil._launch = spy
    try:
        t0 = time.perf_counter()
        ys, n_acc, n_rej = torch.func.vmap(lambda u0: fk_solve(rhs, params, u0, ts_fk))(u0s_fk)
        _sync()
        t_vmap, a_vmap = time.perf_counter() - t0, stencil.launches - a_before
        rows_vmap = dict(rows)
        worst, same = 0.0, 0
        for i in range(8):
            s_ys, s_acc, s_rej = fk_solve(rhs, params, u0s_fk[i], ts_fk)
            same += (int(s_acc), int(s_rej)) == (int(n_acc[i]), int(n_rej[i]))
            worst = max(worst, _rel(ys[i], s_ys))
    finally:
        stencil._launch = launch
    rhs_c, params_c = fk.make_model(torch.Generator().manual_seed(0), "mlp")
    ys_c = torch.func.vmap(lambda u0: fk_solve(rhs_c, params_c, u0, ts_fk.cpu())[0])(
        u0s_fk.cpu())
    plain = _rel(ys.cpu(), ys_c)
    _check(set(rows_vmap) == {8} and a_vmap > 0 and worst <= 1e-3 and plain <= 1e-3,
           f"[lanes b] 8 Fisher-KPP lanes in one vmapped solve: kernel A {a_vmap} launches, "
           f"rows {rows_vmap}; accepted {n_acc.tolist()}, {same} of 8 lanes with the solo "
           f"solve's counts; states vs solo max rel {worst:.3e} (1e-3), vs the plain RHS on "
           f"the CPU {plain:.3e} (1e-3); {t_vmap:.2f} s")

    # (c) the Hudson Bay shooting gradient, float32 and float64
    net = hb.make_net()
    rhs_hb = hb.make_rhs(net)
    walls, grads = {}, {}
    for dt in (torch.float32, f64):
        t_hb, Xn_hb, _ = hb.load_data(dt, device)
        flat, unravel = ravel_pytree(hb.init_params(net, hb.SEEDS[0], dt, device))
        loss = hb.shooting_loss(rhs_hb, t_hb, Xn_hb)

        def grad():
            x = flat.clone().requires_grad_(True)
            return torch.autograd.grad(loss(unravel(x)), x)[0]

        grads[dt] = grad()
        runs = []
        for _ in range(3):
            _sync()
            t0 = time.perf_counter()
            grad()
            _sync()
            runs.append(time.perf_counter() - t0)
        walls[dt] = statistics.median(runs)

    # the same loss as a Python loop over the 5 segment solves (float64)
    idx, mask = ude.shooting_windows(Xn_hb.shape[0], hb.GROUP, device=device)

    def looped(p):
        preds, ok, err = [], [], []
        for k in range(idx.shape[0]):
            tw = t_hb[idx[k]]
            sol = ude.solve(ude.ODEProblem(rhs_hb, Xn_hb[idx[k, 0]], (tw[0], tw[-1]), p),
                            ude.Tsit5(), saveat=tw, rtol=1e-6, atol=1e-6,
                            adjoint=ude.DiscreteAdjoint(), max_steps=256)
            preds.append(sol.ys)
            ok.append(sol.success)
            err.append(sol.error_sum)
        preds, seg = torch.stack(preds), Xn_hb[idx]
        m = mask.to(f64)
        data = torch.sum(m[..., None] * (preds - seg) ** 2)
        cont = torch.sum(m[:-1, -1, None] * (preds[:-1, -1] - seg[1:, 0]) ** 2)
        failed = (~torch.stack(ok)).to(f64)
        return (data + hb.CONTINUITY * cont + 1e4 * failed.sum()
                + (failed * torch.stack(err)).sum() / 256 + hb.reg(p))

    def loop_grad():
        x = flat.clone().requires_grad_(True)
        return torch.autograd.grad(looped(unravel(x)), x)[0]

    _sync()
    t0 = time.perf_counter()
    g_loop = loop_grad()
    _sync()
    t_loop = time.perf_counter() - t0
    r_loop = _rel(grads[f64], g_loop)
    r_32 = _rel(grads[torch.float32].double(), grads[f64])
    _check(r_loop <= 1e-10 and r_32 <= 1e-2 and bool(torch.isfinite(grads[torch.float32]).all()),
           f"[lanes c] Hudson Bay shooting gradient ({flat.numel()} params, 5 vmapped "
           f"segments): {walls[torch.float32]:.3f} s float32, {walls[f64]:.3f} s float64 "
           f"(median of 3); the 5-solve loop {t_loop:.3f} s, equal to 1e-10 ({r_loop:.3e}); "
           f"float32 vs float64 rel {r_32:.3e} (1e-2)")

    # (d) two scenario-2 LM iterations (float32)
    gen = torch.Generator().manual_seed(s2.SEED)
    ts2, _, Xn2 = s2.make_data(gen, device=device)
    rhs2, p2, _ = s2.make_model(gen, device=device)
    res2 = s2.make_residuals(rhs2, *s2.segments(ts2, Xn2))
    r0 = res2(p2)
    l0 = float(torch.sum(r0 * r0))
    lm, wall, lm_walls = _timed_lm(res2, p2, maxiters=2)
    _check(math.isfinite(float(lm.loss)) and float(lm.loss) <= l0,
           f"[lanes d] scenario-2 LM, 2 iterations (88 params, 5 vmapped segments under "
           f"jacfwd): loss {l0:.6g} -> {float(lm.loss):.6g}; per iteration "
           f"{', '.join(f'{w:.3f}' for w in lm_walls)} s on {card}")
    log(f"[lanes] fused RHS kernel launches during phase 7: A {stencil.launches}, B "
        f"{stencil.tangent_launches}, runtime-width {stencil.generic_launches}; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if stencil.launches <= 0 or stencil.generic_launches:
        raise AssertionError("phase 7 did not run kernel A at its compiled widths")


def phase_seir_lv3(device, card):
    """Phase 8: slice C2 and LV scenario 3 (see the module docstring)."""
    import numpy as np
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch import sindy as sd
    from universal_differential_equations_torch.examples import lv_scenario_3 as s3
    from universal_differential_equations_torch.examples import seir_exposure as se
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import fisher_kpp as fk
    from universal_differential_equations_torch.models import seir
    from universal_differential_equations_torch.ops import stencil
    from universal_differential_equations_torch.sindy.select import _selection_frequencies

    f64, f32 = torch.float64, torch.float32
    cpu = torch.device("cpu")
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    t_phase = time.perf_counter()

    # (a) the SEIR truth: Vern7 at 1e-10/1e-12 on the daily grid, float64
    t0 = time.perf_counter()
    ts64, X, data64 = se.truth(torch.Generator().manual_seed(se.SEEDS["noise"]), device=device)
    _sync()
    wall = time.perf_counter() - t0
    _, X_c, data_c = se.truth(torch.Generator().manual_seed(se.SEEDS["noise"]))
    r = _rel(X.cpu(), X_c)
    _check(r <= 1e-9 and X.device == device,
           f"[seir a] Vern7 truth {tuple(X.shape)} float64 on {X.device} in {wall:.3f} s; "
           f"card vs cpu rel {r:.3e} (1e-9)")
    ts, data = ts64.float(), data64.float()

    # (b), (c) per variant: the training loss's gradient at full width, and
    # train_variant's own ADAM and BFGS with budgets passed in
    trained = {}
    for name, make in (("neural_ode", seir.make_neural_ode),
                       ("exposure_ude", seir.make_exposure_ude)):
        rhs, p0, net = make(torch.Generator().manual_seed(se.SEEDS[name]), device=device)
        flat, unravel = ravel_pytree(p0)

        def grad(adjoint):
            x = flat.clone().requires_grad_(True)
            loss = se.make_loss(rhs, ts, data, adjoint=adjoint)(unravel(x))
            return loss.detach(), torch.autograd.grad(loss, x)[0]

        runs = []
        for _ in range(2):
            _sync()
            t0 = time.perf_counter()
            l_i, g_i = grad(ude.InterpolatingAdjoint())
            _sync()
            runs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        l_d, g_d = grad(ude.DiscreteAdjoint(default_max_steps=4096))
        _sync()
        t_d = time.perf_counter() - t0
        rg = _rel(g_i, g_d)
        _check(bool(torch.isfinite(g_i).all()) and rg <= 1e-3,
               f"[seir b] {name} ({flat.numel()} params, float32, rtol 1e-6): loss "
               f"{float(l_i):.6g}, interpolating vs discrete adjoint gradient rel {rg:.3e} "
               f"(1e-3); seconds per gradient, median of 2: {statistics.median(runs):.3f} "
               f"(discrete {t_d:.3f}) on {card}")
        l0 = float(l_i)
        t0 = time.perf_counter()
        p_tr, info = se.train_variant(name, rhs, p0, ts, data, True, adam_steps=5,
                                      bfgs_iters=5, rounds=1)
        _sync()
        wall = time.perf_counter() - t0
        # the neural ODE's loss falls; the exposure UDE's first ADAM(0.01) steps
        # overshoot from its small initial loss (0.0275 -> 0.153 on the card),
        # so there BFGS must lower the loss ADAM left
        falls = info["bfgs_loss"] < (l0 if name == "neural_ode" else info["adam_loss"])
        _check(math.isfinite(info["bfgs_loss"]) and falls,
               f"[seir c] {name}: train_variant 5 ADAM steps {l0:.6g} -> "
               f"{info['adam_loss']:.6g} in {info['adam_s']:.2f} s "
               f"({info['adam_s'] / 5:.3f} s per step); BFGS {info['bfgs_iterations']} "
               f"iterations, {info['bfgs_evals']} evaluations -> {info['bfgs_loss']:.6g} in "
               f"{info['bfgs_s']:.2f} s ({info['bfgs_s'] / max(info['bfgs_iterations'], 1):.3f} s "
               f"per iteration); {wall:.1f} s")
        trained[name] = (rhs, p_tr, net)

    # (d) the weak pair with the SEIR features, and the ideal recovery
    basis = se.scenario_basis()
    t0 = time.perf_counter()
    G, y_w = se.weak_rows(ts64, data64, basis)
    _sync()
    t_w = time.perf_counter() - t0
    G_c, y_c = se.weak_rows(ts64.cpu(), data_c, basis)
    rw = max(_rel(G.cpu(), G_c), _rel(y_w.cpu(), y_c))
    feats, L_true = se.exposure_features(data64), 1e5 * seir.true_exposure(data64)
    t0 = time.perf_counter()
    ideal = se.ideal_recovery(feats, L_true, basis)
    t_i = time.perf_counter() - t0
    ideal_c = se.ideal_recovery(feats.cpu(), L_true.cpu(), basis)
    _check(rw <= 1e-10 and np.array_equal(ideal.active, ideal_c.active),
           f"[seir d] weak pair {tuple(G.shape)} in {t_w:.3f} s, card vs cpu rel {rw:.3e} "
           f"(1e-10); ideal recovery in {t_i:.2f} s, the same support as on the cpu: "
           f"{ideal.equations('dz')[0][:90]}")

    # (e) the UDE arm's ladder and refit judge at the script's widths with 5
    # refit iterations, on the exposure UDE of (c); then a day-60 extrapolation
    rhs_u, p_u, net_u = trained["exposure_ude"]
    rc = se.reconstruct(rhs_u, net_u, p_u, ts, data)
    t0 = time.perf_counter()
    lad = se.ladder(basis.theta(rc["feats_h"][1:]), rc["L_hat"][1:],
                    se.small_supports(len(basis)))
    C_sel, refit_loss, k_sel = se.judge(lad, basis, ts, data, refit_iters=5)
    _sync()
    t_j = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ok60, err60 = se.extrapolate(ideal, se.truth60(device=device))
    _sync()
    t_x = time.perf_counter() - t0
    _check(bool(torch.isfinite(C_sel).all()) and math.isfinite(float(refit_loss)) and ok60,
           f"[seir e] UDE-arm ladder ({int(lad[1].sum())} of {lad[0].shape[0]} rungs) and "
           f"refit judge (refit_all, 5 BFGS iterations, {(len(ts) - 1) * se.SUB} fixed Tsit5 "
           f"steps) in {t_j:.2f} s: k = {int(k_sel)}, refit loss {float(refit_loss):.4g}; the "
           f"ideal model's day-60 extrapolation finished (rel err on E,I,R {err60:.3e}) in "
           f"{t_x:.2f} s")

    # (f) stability selection and the two-stage recovery, card against cpu
    rng = np.random.default_rng(3)
    th = rng.standard_normal((60, 10))
    yy = 1.5 * th[:, 2] - 0.8 * th[:, 7] + 0.05 * rng.standard_normal(60)
    keep = torch.rand((64, 60), generator=torch.Generator().manual_seed(7)) < 0.7
    opt = sd.STLSQ(tuple(10.0 ** e for e in np.arange(-3.0, 1.0, 0.25)))
    t0 = time.perf_counter()
    freq = _selection_frequencies(torch.tensor(th, device=device), torch.tensor(yy, device=device),
                                  opt, keep, 4, True)
    _sync()
    t_s = time.perf_counter() - t0
    freq_c = _selection_frequencies(torch.tensor(th), torch.tensor(yy), opt, keep, 4, True)
    Xl = rng.uniform(0.2, 3.0, (200, 2))
    Yl = np.stack([1.5 * Xl[:, 0] - 0.7 * Xl[:, 0] * Xl[:, 1],
                   -2.0 * Xl[:, 1] + 0.4 * Xl[:, 0] * Xl[:, 1]], 1)
    Yl = Yl + 1e-3 * rng.standard_normal(Yl.shape)
    lv_basis = sd.polynomial_basis(2, 5) + sd.sin_basis(2)
    lams = tuple(10.0 ** e for e in np.arange(-7.0, 7.0, 0.1))
    t0 = time.perf_counter()
    C2 = sd.two_stage_recovery(lv_basis.theta(torch.tensor(Xl, device=device)),
                               torch.tensor(Yl, device=device), lams)
    _sync()
    t_2 = time.perf_counter() - t0
    C2_c = sd.two_stage_recovery(lv_basis.theta(torch.tensor(Xl)), torch.tensor(Yl), lams)
    r2 = _rel(C2.cpu(), C2_c)
    _check(_rel(freq.cpu(), freq_c) <= 1e-12 and r2 <= 1e-12
           and torch.equal(C2.cpu() != 0, C2_c != 0),
           f"[seir f] stability selection (64 subsets) in {t_s:.2f} s, frequencies "
           f"{freq.cpu().numpy().round(3).tolist()} equal the cpu's; two-stage recovery in "
           f"{t_2:.2f} s, card vs cpu rel {r2:.3e} (1e-12), {int((C2 != 0).sum())} terms")

    # (g) LV scenario 3 in float32: 10 ADAM steps and 2 LM iterations, and
    # SINDy on pairs from the true reaction
    ts3, data3 = fk.generate_data(dtype=f32, device=device)
    rhs3, p3, _ = s3.make_model(torch.Generator().manual_seed(s3.SEED), device=device)
    res3 = s3.make_residuals(rhs3, ts3, data3)
    r0 = res3(p3)
    l0 = float(torch.sum(r0 * r0))
    t0 = time.perf_counter()
    _, loss3, rounds3 = s3.train(res3, p3, True, rounds=1, adam_steps=10, lm_iters=2)
    _sync()
    t_3 = time.perf_counter() - t0
    u = data3.reshape(-1, 1)
    rec = s3.recover(u, u * (1 - u))
    ferr = s3.functional_error(rec, device=device)
    _check(math.isfinite(loss3) and rounds3[0][0] <= l0 and loss3 <= rounds3[0][0]
           and ferr <= 1e-3,
           f"[lv3 g] scenario 3 (float32, 80 params): 10 ADAM steps {l0:.6g} -> "
           f"{rounds3[0][0]:.6g}, 2 LM iterations -> {loss3:.6g}, {t_3:.2f} s; SINDy on the "
           f"true reaction: {rec.equations('dr')[0]}, max error on [0, 1] {ferr:.2e} (1e-3)")
    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[seir] fused RHS kernel launches during phase 8: A {launched[0]}, B {launched[1]}, "
        f"runtime-width {launched[2]} (this path runs no hand-written kernel); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(launched):
        raise AssertionError("phase 8 launched a fused RHS kernel; its paths reach none")


def _kernels_and_peak(fn, device):
    """``(CUDA kernels, peak device bytes)`` of one call of ``fn``: the kernels
    counted by ``torch.profiler``; the peak from the allocator's statistics,
    less what was allocated before the call, so it is the call's own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernels, torch.cuda.max_memory_allocated(device) - held


def phase_fkpp(device, card, ts, ys):
    """Phase 9: the Fisher-KPP case study's training through both kernels."""
    import torch
    from universal_differential_equations_torch.examples import fisher_kpp as fx
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import fisher_kpp as fk
    from universal_differential_equations_torch.ops import stencil

    t_phase = time.perf_counter()
    rhs, params0 = fk.make_model(torch.Generator().manual_seed(0), "mlp", device=device)
    residuals = fk.make_residuals(rhs, ts, ys)
    loss = fx.make_loss(residuals)
    flat, unravel = ravel_pytree(params0)

    def grad():
        x = flat.clone().requires_grad_(True)
        value = loss(unravel(x))
        return value.detach(), torch.autograd.grad(value, x)[0]

    # (a) one ADAM gradient through kernel A (forward) and FusedUpdetRHS's
    # reverse rule, against the same gradient with the fused dispatch off
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    l_k, g_k = grad()
    a_grad = stencil.launches
    s_k = median_s(grad, calls=3)
    use_fused = fk._use_fused
    fk._use_fused = lambda u: False
    try:
        l_p, g_p = grad()
        s_p = median_s(grad, calls=3)
    finally:
        fk._use_fused = use_fused
    rg = _rel(g_k, g_p)
    _check(a_grad > 0 and bool(torch.isfinite(g_k).all()) and rg <= 1e-4,
           f"[fkpp a] ADAM gradient of the mlp loss ({flat.numel()} params, float32): kernel A "
           f"{a_grad} launches; loss {float(l_k):.6g} (plain {float(l_p):.6g}); kernel vs plain "
           f"RHS gradient rel {rg:.3e} (1e-4); seconds per gradient, median of 3: kernel "
           f"{s_k:.3f}, plain {s_p:.3f} on {card}")

    # (b) the example's own training function: 5 ADAM steps, then 3 LM
    # iterations (no refine pass); the launch counters are read and zeroed
    # after each stage
    stages = []
    clock = [time.perf_counter()]

    def on_stage(name, value):
        now = time.perf_counter()
        stages.append((name, value, now - clock[0], stencil.launches, stencil.tangent_launches,
                       stencil.generic_launches))
        stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
        clock[0] = now

    loss0 = float(l_k)
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    _sync()
    clock[0] = time.perf_counter()
    _, final = fx.train("mlp", params0, residuals, adam_steps=5, lm_iters=3, refine_steps=0,
                        on_stage=on_stage)
    for name, value, wall, a, b, generic in stages:
        log(f"[fkpp b] {name}: loss {value:.6g}, {wall:.2f} s; launches kernel A {a}, kernel B "
            f"{b}, runtime-width {generic}")
    by = {name: (a, b, generic) for name, _, _, a, b, generic in stages}
    _check(by["adam"][0] > 0 and by["adam"][1] == 0 and by["lm"][0] > 0 and by["lm"][1] > 0
           and not any(v[2] for v in by.values())
           and math.isfinite(final) and final < loss0,
           f"[fkpp b] fisher_kpp.train (mlp): loss {loss0:.6g} -> {final:.6g}; kernel A under "
           f"ADAM, A and B under LM, runtime-width 0; phase wall "
           f"{time.perf_counter() - t_phase:.1f} s")


def phase_ensemble(device, card):
    """Phase 10: the ensemble runner over Lotka-Volterra lanes."""
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.ensemble import ensemble_run, noise_schedule
    from universal_differential_equations_torch.models import lotka_volterra as lv

    f32 = torch.float32
    ts = torch.linspace(0.0, 3.0, 31, dtype=f32, device=device)
    u0, p = lv.U0.to(device, f32), lv.P_TRUE.to(device, f32)
    study = 500  # the noise study's runs: 5 levels of 100
    z = torch.rand((study, 2), generator=torch.Generator().manual_seed(11), dtype=f32)
    z = (2.0 * z - 1.0).to(device)

    def run(args):
        i, zi = args
        x0 = u0 * (1.0 + 10.0 * noise_schedule(i).to(f32) * zi)
        sol = ude.solve(ude.ODEProblem(lv.lotka_rhs, x0, (0.0, 3.0), p), ude.Tsit5(),
                        saveat=ts, rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint())
        return sol.ys, sol.success

    rows = {}
    for lanes in (64, study):
        # the same spread of noise levels at both sizes: lanes drawn evenly
        # from the study's 500 runs
        idx = (torch.arange(lanes) * study // lanes).to(device)
        batch = (idx, z[idx])
        ensemble_run(run, batch)  # warm-up
        _sync()
        t0 = time.perf_counter()
        res = ensemble_run(run, batch)
        _sync()
        wall = time.perf_counter() - t0
        kernels, peak = _kernels_and_peak(lambda: ensemble_run(run, batch), device)
        worst = 0.0
        for k in (0, lanes // 2, lanes - 1):
            solo, _ = run((idx[k], z[idx[k]]))
            worst = max(worst, _rel(res.outputs[k], solo))
        rows[lanes] = (wall, kernels, peak)
        _check(res.num_success == lanes and worst <= 1e-5,
               f"[ensemble] L = {lanes}: {res.num_success} of {lanes} lanes succeed; 3 lanes "
               f"vs their solo solves rel {worst:.3e} (1e-5); {wall:.3f} s, {kernels} CUDA "
               f"kernels, peak device memory {peak / 2**20:.1f} MiB on {card}")
    ratio = rows[study][1] / rows[64][1]
    _check(ratio <= 1.5,
           f"[ensemble] L = {study} vs 64: kernels x{ratio:.3f} (bound 1.5), wall "
           f"x{rows[study][0] / rows[64][0]:.3f}, seconds per lane {rows[64][0] / 64:.2e} -> "
           f"{rows[study][0] / study:.2e}")


def phase_surface(device, card):
    """Phase 11: the RK tables, StencilConv1D, neural_ode and KeyedArchive."""
    import tempfile

    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.core.integrate import integrate_fixed
    from universal_differential_equations_torch.models import lotka_volterra as lv

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    tol = 1e-4
    ts = torch.linspace(0.0, 3.0, 13, dtype=f64)

    def lv_solve(solver, dtype, dev):
        prob = ude.ODEProblem(lv.lotka_rhs, lv.U0.to(dev, dtype), (0.0, 3.0),
                              lv.P_TRUE.to(dev, dtype))
        if isinstance(solver, ude.Euler):  # fixed-step use only
            return integrate_fixed(prob.f, prob.u0, 0.0, 3.0, prob.args, solver, 1000)[1][-1]
        sol = ude.solve(prob, solver, saveat=ts.to(dev, dtype), rtol=tol, atol=tol,
                        adjoint=ude.NoAdjoint(), max_steps=8192)
        if not bool(sol.success):
            raise AssertionError(f"[surface] {solver.name} solve on {dev} failed")
        return sol.ys

    for name in ("Dopri5", "Bosh3", "Euler", "Heun"):
        solver = getattr(ude, name)()
        t0 = time.perf_counter()
        ys = lv_solve(solver, f32, device)
        _sync()
        wall = time.perf_counter() - t0
        r = _rel(ys.cpu().double(), lv_solve(solver, f64, cpu))
        _check(r <= tol, f"[surface] {name} LV on the card (float32) vs the port's float64 CPU "
               f"solve: rel {r:.3e} ({tol:g}), {wall:.2f} s")

    conv = ude.StencilConv1D(3)
    w = conv.init(torch.Generator().manual_seed(0), f64)
    x = torch.rand((4, 26), generator=torch.Generator().manual_seed(1), dtype=f64)
    rc = _rel(conv({"w": w["w"].to(device, f32)}, x.to(device, f32)).cpu().double(),
              conv(w, x))
    net = ude.MLP([2, 8, 2], activation="tanh")
    p_net = net.init(torch.Generator().manual_seed(2), f32, device)
    sol = ude.neural_ode(net, p_net, torch.tensor([1.0, -1.0], device=device), (0.0, 1.0),
                         saveat=torch.linspace(0.0, 1.0, 5, device=device))
    p_cpu = [{k: v.cpu().double() for k, v in layer.items()} for layer in p_net]
    ref = ude.neural_ode(net, p_cpu, torch.tensor([1.0, -1.0], dtype=f64), (0.0, 1.0),
                         saveat=torch.linspace(0.0, 1.0, 5, dtype=f64))
    rn = _rel(sol.ys.cpu().double(), ref.ys)
    with tempfile.TemporaryDirectory() as tmp:
        arch = ude.KeyedArchive(tmp)
        arch.save("lane_0", params=p_net, loss=torch.tensor(0.25, device=device))
        got = arch.load("lane_0", device=device)
        ude.save_pytree(f"{tmp}/net", p_net)
        back = ude.load_pytree(f"{tmp}/net", like=p_net, device=device)
    same = (float(got["loss"]) == 0.25 and got["params__0"].device == device
            and all(torch.equal(la[k], lb[k]) for la, lb in zip(p_net, back) for k in la))
    _check(rc <= 1e-6 and bool(sol.success) and rn <= 1e-4 and same,
           f"[surface] StencilConv1D card vs float64 CPU rel {rc:.3e} (1e-6); neural_ode on the "
           f"card vs float64 CPU rel {rn:.3e} (1e-4); KeyedArchive and save/load_pytree "
           f"round-trip to {device}: exact")


STUDY_STAGES = ("recover_stage", "oracle_stage", "weak_stage")


def _study_train(s, data, theta0, sync):
    """Phase 12 (a)'s training stages on the stages ``s`` from ``theta0`` on
    ``data``: the lanes' losses after ADAM, BFGS and LM, and the seconds per
    ADAM step, BFGS iteration and LM iteration.  Each stage's parameters are
    scored by one function, ``mean_loss`` (on the card BFGS's own values come
    from the lane kernel, whose float32 rounding differs from the plain
    path's: a lane LM leaves where it is would read as risen)."""

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    (theta, _), t_adam = timed(lambda: s.adam_stage(theta0, data, steps=10))
    l_adam = s.mean_loss(theta, data).detach()
    (theta, _, _), t_bfgs = timed(lambda: s.bfgs_round(theta, data, maxiters=10))
    l_bfgs = s.mean_loss(theta, data).detach()
    (theta, _), t_lm = timed(lambda: s.lm_round(theta, data, maxiters=3))
    l_lm = s.mean_loss(theta, data).detach()
    return [x.cpu() for x in (l_adam, l_bfgs, l_lm)], (t_adam / 10, t_bfgs / 10, t_lm / 3)


def _study_cpu_training(lanes):
    """Phase 12 (a) on the CPU port, in a worker process beside the card's."""
    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT))
    from universal_differential_equations_torch.examples import run_loops as rl

    s = rl.build_stages(device="cpu")
    data, theta0, _ = s.lane_inputs(lanes, 100)
    return _study_train(s, data, theta0, lambda: None)


_STUDY = {}


def _study_stages(device):
    """The study's stages on ``device``, built once per worker process."""
    import torch

    if device not in _STUDY:
        if device == "cpu":
            torch.set_num_threads(2)
        sys.path.insert(0, str(ROOT))
        from universal_differential_equations_torch.examples import run_loops as rl

        _STUDY[device] = rl.build_stages(device=device)
    return _STUDY[device]


def _warm_study(device):
    """A worker's first task: build its stages before its real task comes."""
    _study_stages(device)


def _study_supports(device, name, lanes, theta_tr, loss_tr):
    """The port's selection of stage ``name`` for phase 12 (b) or (c) on
    ``device``, in a worker process beside the phase's other work (one per
    stage and device): ``(support 1, support 2, seconds)``."""
    import torch

    s = _study_stages(device)
    data, _, mags = s.lane_inputs(lanes, 100)
    theta, loss = (torch.as_tensor(a, device=device) for a in (theta_tr, loss_tr))
    calls = {"recover_stage": (lambda: s.recover_stage(theta, data, loss, mags), 3),
             "oracle_stage": (lambda: s.oracle_stage(data, mags), 2),
             "weak_stage": (lambda: s.weak_stage(data, mags), 2)}
    fn, i = calls[name]
    t0 = time.perf_counter()
    r = fn()
    c1, c2 = (r[j].cpu().numpy() != 0 for j in (i, i + 1))
    return c1, c2, time.perf_counter() - t0


# the lane kernel's latency bound: one lane's chain of dependent operations
# at an FMA's 4 cycles and 1.98 GHz, ~44 per net evaluation (three layers of
# dot product, bias, square and expf, the output layer, the stage sum) and ~28
# per stage VJP; 721 evaluations forward, 720 recomputed and 720 VJPs back
LANE_EVAL_OPS, LANE_VJP_OPS, OP_CYCLES, SM_HZ = 44, 28, 4, 1.98e9
# per lane and element (``_lane_gaps``): the kernel against the graphed plain
# path, both float32, reads 9.7e-6 (loss) and 1.64e-5 (gradient) at 500 lanes
LANE_PLAIN_TOL = (2.5e-5, 5e-5)
# against JAX's float64 result (tests/data/lv_lanes_jax.npz): 3.0e-6 and 1.34e-6
LANE_JAX_TOL = (1e-5, 5e-6)


def _lane_gaps(prog, ref):
    """``(loss, grad)`` against ``ref``: the worst lane's loss gap relative
    to its loss, the worst gradient element's gap relative to its lane's
    gradient norm, and the largest absolute gap of either."""
    (lp, gp), (lr, gr) = ((x.double().cpu() for x in pair) for pair in (prog, ref))
    return (float(((lp - lr).abs() / lr.abs()).max()),
            float(((gp - gr).abs().amax(1) / gr.norm(dim=1)).max()),
            max(float((lp - lr).abs().max()), float((gp - gr).abs().max())))


def _study_lane_kernel(s):
    """Phase 12 (e): the lane kernel (``s.loss_and_grad`` on the card) against
    the graphed plain path (autograd through ``s.mean_loss``, as the card ran
    it before the kernel) and against JAX; CUDA-event times at 500 lanes;
    the kernel's graph replays counted by ``lane_loss.kernel`` in 5 profiled
    ADAM steps.  Returns the kernels line's entry."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.ops import lv_lanes
    from universal_differential_equations_torch.utils import profiling

    def plain(th, d):
        with torch.enable_grad():
            x = th.detach().requires_grad_(True)
            loss = s.mean_loss(x, d)
            (g,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), g

    gaps = {}
    for n in (25, 500):
        data, theta, _ = s.lane_inputs(np.linspace(0, 499, n).astype(int), 100)
        g_plain = rl._Graphed(plain, theta, data)
        gaps[n] = _lane_gaps(s.loss_and_grad(theta, data), g_plain(theta, data))
        if n == 500:
            ms = _median_ms(lambda: s.loss_and_grad(theta, data))
            plain_ms = _median_ms(lambda: g_plain(theta, data), calls=3, reps=3)
        del g_plain
    with np.load(ROOT / "tests" / "data" / "lv_lanes_jax.npz") as z:
        lanes, ref = z["lanes"], (torch.from_numpy(z["loss"]), torch.from_numpy(z["grad"]))
    data, theta, _ = s.lane_inputs(lanes, 100)
    gaps["jax"] = _lane_gaps(s.loss_and_grad(theta, data), ref)
    s.adam_stage(theta, data, steps=1)  # captures the stage's graph
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        s.adam_stage(theta, data, steps=5)
        _sync()
    rec = profiling.recorded()
    profiling.clear()
    replays = sum(name == "graph.replay" for name, *_ in rec["spans"])
    counted = sum(n for name, _, n in rec["counts"] if name == "lane_loss.kernel")
    n_steps = 30 * rl.SUB
    bound_ms = ((2 * n_steps * 6 + 1) * LANE_EVAL_OPS + n_steps * 6 * LANE_VJP_OPS) \
        * OP_CYCLES / SM_HZ * 1e3
    flop_ms = 2 * 3 * sum(i * o for i, o in _layer_pairs(lv_lanes.WIDTHS)) \
        * (6 * n_steps + 1) * 500 / F32_FLOP_PER_S * 1e3
    ok = (all(g[0] <= LANE_PLAIN_TOL[0] and g[1] <= LANE_PLAIN_TOL[1] for g in
              (gaps[25], gaps[500]))
          and gaps["jax"][0] <= LANE_JAX_TOL[0] and gaps["jax"][1] <= LANE_JAX_TOL[1]
          and replays == counted == 5)
    _check(ok, f"[study e] lane kernel against the graphed plain path, worst lane's loss / "
               f"gradient element (over its lane's norm): 25 lanes {gaps[25][0]:.3e} / "
               f"{gaps[25][1]:.3e}, 500 lanes {gaps[500][0]:.3e} / {gaps[500][1]:.3e} "
               f"({LANE_PLAIN_TOL}); against JAX float64 on {len(lanes)} lanes "
               f"{gaps['jax'][0]:.3e} / {gaps['jax'][1]:.3e} ({LANE_JAX_TOL}); 500 lanes "
               f"{ms:.4f} ms a launch, the plain graph {plain_ms:.2f} ms a replay, bound "
               f"{bound_ms:.4f} ms (latency; FLOP {flop_ms:.5f} ms); 5 ADAM steps: "
               f"{replays} replays, lane_loss.kernel {counted}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bound_ms, flop_ms),
            "bound_by": "latency" if bound_ms >= flop_ms else "operations",
            "max_abs_err": gaps[500][2], "max_rel_err": max(gaps[500][:2]),
            "replays": counted}


def phase_lv_study(device, card):
    """Phase 12: the 500-lane noise study's stages (see the module docstring)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.ops import lv_lanes, stencil

    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    lv_lanes.launches = 0
    t_phase = time.perf_counter()
    results = ROOT / "examples" / "lotka_volterra" / "results"
    with np.load(results / "lane_theta_samples.npz") as z:
        lanes, theta_tr, loss_tr = z["lane"], z["theta"], z["loss"]
    with np.load(results / "loop_study.npz") as z:
        archive = {k: z[k][lanes] != 0 for k in z.files if k.startswith("coef")}
    # the JAX study's recover_stage on the same weights (tools/lv_study_lanes.py)
    with np.load(ROOT / PKG / "examples" / "data" / "lv_study_recover.npz") as z:
        jax_rec = (z["coef1"] != 0, z["coef2"] != 0)
    # the CPU's training stages (a) and selections (b), (c) run in workers
    # beside the card's, one per stage; the card's selections run in workers
    # of their own after (a), which only their start-up overlaps
    spawn = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(len(STUDY_STAGES) + 1, mp_context=spawn)
    card_pool = ProcessPoolExecutor(len(STUDY_STAGES), mp_context=spawn)
    try:
        cpu_train = pool.submit(_study_cpu_training, lanes)
        cpu_sel = {name: pool.submit(_study_supports, "cpu", name, lanes, theta_tr, loss_tr)
                   for name in STUDY_STAGES}
        for _ in STUDY_STAGES:
            card_pool.submit(_warm_study, str(device))
        s = rl.build_stages(device=device)

        def timed(fn):
            _sync()
            t0 = time.perf_counter()
            out = fn()
            _sync()
            return out, time.perf_counter() - t0

        # (a) the training stages at 25 lanes, card and CPU; on the card a first
        # call captures the evaluations' CUDA graphs, which the timed calls replay
        data, theta0, _ = s.lane_inputs(lanes, 100)
        s.adam_stage(theta0, data, steps=1)
        s.lm_round(theta0, data, maxiters=1)
        losses, walls = {}, {}
        losses["cuda"], walls["cuda"] = _study_train(s, data, theta0, _sync)
        data, theta0, _ = s.lane_inputs(np.arange(500), 100)
        s.adam_stage(theta0, data, steps=1)
        s.lm_round(theta0, data, maxiters=1)
        _, t_adam = timed(lambda: s.adam_stage(theta0, data, steps=1))
        _, t_lm = timed(lambda: s.lm_round(theta0, data, maxiters=1))
        log(f"[study a] 500 lanes on the card, graphs captured: {t_adam:.3f} s per ADAM step, "
            f"{t_lm:.3f} s for one LM iteration (25 lanes: {walls['cuda'][0]:.3f}, "
            f"{walls['cuda'][2]:.3f})")
        del data, theta0
        lane_kernel = _study_lane_kernel(s)
        del s

        # (b) the recovery stage from the archived trained weights, (c) the oracle
        # and weak arms: the card's selections against the CPU's and the archive,
        # the three stages side by side in workers on the card
        card_sel = {name: card_pool.submit(_study_supports, str(device), name, lanes, theta_tr,
                                           loss_tr) for name in STUDY_STAGES}
        card_sel = {name: f.result() for name, f in card_sel.items()}
        cpu_sel = {name: f.result() for name, f in cpu_sel.items()}
        losses["cpu"], walls["cpu"] = cpu_train.result()
    finally:
        pool.shutdown(cancel_futures=True)
        card_pool.shutdown(cancel_futures=True)
    la, lb, ll = losses["cuda"]
    finite = all(bool(torch.isfinite(x).all()) for x in (la, lb, ll))
    ok = finite and bool((lb <= la).all()) and bool((ll <= lb).all())
    rise = max(float(((lb - la) / la).max()), float(((ll - lb) / lb).max()))
    r_adam = _rel(la, losses["cpu"][0])
    _check(ok and r_adam <= 1e-4,
           f"[study a] 25 lanes: losses finite {finite}, not rising ADAM -> BFGS -> LM "
           f"{ok} (median {float(la.median()):.4g} -> {float(lb.median()):.4g} -> "
           f"{float(ll.median()):.4g}; the largest relative rise of a lane {rise:.3e}); "
           f"card vs CPU after ADAM rel {r_adam:.3e} (1e-4); "
           f"seconds per ADAM step / BFGS iteration / LM iteration: card "
           f"{walls['cuda'][0]:.3f} / {walls['cuda'][1]:.3f} / {walls['cuda'][2]:.3f}, CPU "
           f"{walls['cpu'][0]:.3f} / {walls['cpu'][1]:.3f} / {walls['cpu'][2]:.3f} on {card}")
    for name, arm in (("recover_stage", ""), ("oracle_stage", "_oracle"),
                      ("weak_stage", "_weak")):
        c1, c2, secs = card_sel[name]
        p1, p2, cpu_secs = cpu_sel[name]
        same = (c1 == p1).all(1) & (c2 == p2).all(1)
        agree = (c1 == archive[f"coef1{arm}"]).all(1) & (c2 == archive[f"coef2{arm}"]).all(1)
        for i in np.nonzero(~agree)[0]:
            log(f"[study] {name} lane {int(lanes[i])}: port {np.nonzero(c1[i])[0].tolist()} / "
                f"{np.nonzero(c2[i])[0].tolist()}, JAX "
                f"{np.nonzero(archive[f'coef1{arm}'][i])[0].tolist()} / "
                f"{np.nonzero(archive[f'coef2{arm}'][i])[0].tolist()}")
        if name == "recover_stage":
            # printed, no gate: the JAX study's trained arm was trained in its
            # 500-lane run, not from these weights
            rec = int(((c1 == jax_rec[0]).all(1) & (c2 == jax_rec[1]).all(1)).sum())
            _check(bool(same.all()),
                   f"[study b] {name}, 25 lanes: card selects the CPU's supports on "
                   f"{int(same.sum())}/25; {rec}/25 equal the JAX recover_stage's on the same "
                   f"weights, {int(agree.sum())}/25 the JAX study's trained arm; {secs:.2f} s "
                   f"card, {cpu_secs:.2f} s CPU")
        else:
            _check(bool(same.all()) and int(agree.sum()) >= 23,
                   f"[study c] {name}, 25 lanes: card selects the CPU's supports on "
                   f"{int(same.sum())}/25; {int(agree.sum())}/25 equal the JAX archive "
                   f"(>= 23); {secs:.2f} s card, {cpu_secs:.2f} s CPU")

    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[study] fused RHS kernel launches during phase 12: A {launched[0]}, B {launched[1]}, "
        f"runtime-width {launched[2]} (its paths reach none); lane kernel launches "
        f"{lv_lanes.launches} (ADAM's and BFGS's graphs hold it); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(launched):
        raise AssertionError("phase 12 launched a fused RHS kernel; its paths reach none")
    if not lv_lanes.launches:
        raise AssertionError("phase 12's training stages did not go through the lane kernel")
    lane_kernel["launches"] = lv_lanes.launches
    return lane_kernel


def phase_climate(device, card):
    """Phase 13: the climate case study (see the module docstring)."""
    import numpy as np
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.examples import climate_neural_pde as npde
    from universal_differential_equations_torch.examples import climate_training_rt as trt
    from universal_differential_equations_torch.io import load_pytree
    from universal_differential_equations_torch.models import climate_datagen as dg
    from universal_differential_equations_torch.models import climate_npde as cn
    from universal_differential_equations_torch.ops import stencil

    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t_phase = time.perf_counter()

    # (a) the four stabilized solvers on the column's truth, card against CPU
    _, _, eig = cn.getops(32)
    solvers = (ude.ROCK4.for_problem(eig * 1.1, (0.0, 1.5), n_steps_hint=40),
               ude.ROCK2.for_problem(eig * 1.1, (0.0, 1.5), n_steps_hint=40),
               ude.RKC2.for_problem(eig * 1.1, (0.0, 1.5), n_steps_hint=40),
               ude.RKC1(stages=16, rho=eig * 1.1))

    def column_solve(solver, dtype, dev, rtol):
        D1, D2, _ = cn.getops(32, dtype=dtype, device=dev)
        ts = torch.linspace(0.0, 1.5, 16, dtype=dtype, device=dev)
        sol = ude.solve(ude.ODEProblem(cn.true_rhs, cn.get_u0(32, dtype, dev), (0.0, 1.5),
                                       (D1, D2)), solver, saveat=ts, rtol=rtol,
                        atol=rtol * 1e-2, adjoint=ude.NoAdjoint(), max_steps=8192, dense=True)
        steps = sol.dense.ts[:int(sol.num_accepted) + 1]
        longest = float((steps[1:] - steps[:-1]).max())
        counts = (int(sol.num_accepted), int(sol.num_rejected), int(sol.num_rhs_evals))
        return sol.ys.cpu(), counts, longest, bool(sol.success)

    for solver in solvers:
        t0 = time.perf_counter()
        ys_c, n_c, longest, ok = column_solve(solver, f64, device, 1e-5)
        wall = time.perf_counter() - t0
        ys_p, n_p, _, _ = column_solve(solver, f64, cpu, 1e-5)
        y32_c, n32, long32, ok32 = column_solve(solver, f32, device, 1e-4)
        y32_p, _, _, _ = column_solve(solver, f32, cpu, 1e-4)
        r64, r32 = _rel(ys_c, ys_p), _rel(y32_c, y32_p)
        capped = max(longest, long32) <= solver.dt_stab * (1 + 1e-6)
        _check(ok and ok32 and n_c == n_p and r64 <= 1e-9 and r32 <= 1e-3 and capped,
               f"[climate a] {solver.name}: float64 accepted/rejected/RHS {n_c} (CPU {n_p}), "
               f"rel {r64:.2e} (1e-9), {wall:.2f} s on the card; float32 {n32}, rel "
               f"{r32:.2e} (1e-3); longest step {max(longest, long32):.5f} <= dt_stab "
               f"{solver.dt_stab:.5f}")

    # (b) the neural-PDE column at full width: one LM iteration, the adjoint timed
    D1, D2, eig, u0, ts = npde.problem(device=device)
    data = npde.truth(D1, D2, u0, ts)
    rhs, params0, _ = cn.make_neural_rhs(torch.Generator().manual_seed(npde.SEED),
                                         device=device)
    residuals = npde.make_residuals(rhs, u0, ts, data, D1, D2)
    l_init = float(torch.sum(residuals(params0) ** 2))
    t0 = time.perf_counter()
    res = ude.levenberg_marquardt(residuals, params0, maxiters=1, lam0=30.0)
    _sync()
    t_lm = time.perf_counter() - t0
    l_lm = float(res.loss)
    _check(math.isfinite(l_lm) and l_lm <= l_init,
           f"[climate b] one LM iteration at full width (518 parameters, float32): loss "
           f"{l_init:.5g} -> {l_lm:.5g} in {t_lm:.2f} s on {card}")
    vg = npde.adjoint_loss(rhs, u0, ts, data, D1, D2)
    npde.value_and_grad(vg, params0)
    t_adj = median_s(lambda: npde.value_and_grad(vg, params0), 3)
    cast = lambda x, dev: x.to(dtype=f64, device=dev)  # noqa: E731
    grads = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        p64 = [{k: cast(v, dev) for k, v in layer.items()} for layer in params0]
        ops = [cast(x, dev) for x in (D1, D2, u0, ts, data)]
        loss64 = npde.adjoint_loss(rhs, ops[2], ops[3], ops[4], ops[0], ops[1])
        grads[key] = torch.cat([g.reshape(-1) for g in
                                     npde.value_and_grad(loss64, p64)[1]]).cpu()
    r_g = _rel(grads["card"], grads["cpu"])
    _check(r_g <= 1e-8,
           f"[climate b] climate_adjoint_loss_grad {t_adj:.4f} s (median of 3 calls, float32; "
           f"the reference's Julia run 0.879 s) on {card}; float64 gradient card vs CPU "
           f"rel {r_g:.2e} (1e-8)")
    del grads

    # (c) one RT chunk at 128x2x128, card against CPU; the step-time rows
    rng = np.random.default_rng(13)
    vel = [rng.standard_normal((128, 2, 128)) * 0.1 for _ in range(3)]
    for bc in ("periodic", "rigid_lid"):
        outs = {}
        for key, dev in (("card", device), ("cpu", cpu)):
            state, _, chunk, _ = dg._rt_stepper((128, 2, 128), (1.0, 2 / 128, 1.0), 1e-4, 1e-4,
                                                1.0, 10, None, f32, bc=bc, device=dev)
            state = tuple(torch.as_tensor(a, dtype=f32, device=dev) for a in vel) + state[3:]
            new, umax = chunk(state, torch.tensor(1e-3, dtype=f32, device=dev))
            outs[key] = [x.cpu() for x in new]
        r_rt = max(_rel(a, b) for a, b in zip(outs["card"], outs["cpu"]))
        _check(r_rt <= 1e-4 and all(bool(torch.isfinite(x).all()) for x in outs["card"]),
               f"[climate c] one RT chunk at 128x2x128 ({bc}, float32): card vs CPU rel "
               f"{r_rt:.2e} (1e-4)")
    rt_ms = dg.rt_step_seconds((128, 2, 128), device=device) * 1e3
    rigid_ms = dg.rt_step_seconds((128, 2, 128), bc="rigid_lid", device=device) * 1e3
    tracer_ms = dg.tracer_step_seconds(128, device=device) * 1e3
    log(f"[climate c] rt_datagen_ms_per_step {rt_ms:.4f} ms at 128x2x128 (the reference's "
        f"Julia run 8.5 ms), rt_rigid_lid_ms_per_step {rigid_ms:.4f} ms, "
        f"tracer_datagen_ms_per_step_128cubed {tracer_ms:.4f} ms (CUDA events, minimum of 5 "
        f"chunks) on {card}")

    # (d) the committed JAX checkpoint, card against CPU; training_rt's ADAM step
    t, _, b = trt.load_or_generate(False, device=device)
    _, b_cs, n_pairs = trt.coarse_pairs(t, b, 16)
    net, prop = trt.make_model(16)
    evals = {}
    for key, dev in (("card", device), ("cpu", cpu)):
        bn = torch.as_tensor(b_cs[:n_pairs], dtype=f32, device=dev)
        bn1 = torch.as_tensor(b_cs[1:n_pairs + 1], dtype=f32, device=dev)
        like = net.init(torch.Generator().manual_seed(0), f32, dev)
        params = load_pytree(ROOT / "examples" / "climate" / "data" / "dbdt_nn.npz", like,
                             device=dev)
        loss_fn = trt.make_loss(prop, bn, bn1)
        with torch.no_grad():
            one_step = float(loss_fn(params))
        rel, _ = trt.rollout_rel(prop, params, b_cs, len(b_cs) - 1)
        evals[key] = (one_step, rel, loss_fn, params)
    (l_c, rel_c, loss_fn, params), (l_p, rel_p, _, _) = evals["card"], evals["cpu"]
    ude.fit(loss_fn, params, lambda ps: torch.optim.Adam(ps, lr=1e-3), 1)
    t_step = median_s(lambda: ude.fit(loss_fn, params, lambda ps: torch.optim.Adam(ps, lr=1e-3),
                                      1), 3)
    _check(abs(l_c - l_p) <= 1e-4 * l_p and abs(rel_c - rel_p) <= 2e-3,
           f"[climate d] committed dbdt_nn.npz: one-step loss {l_c:.6g} (CPU {l_p:.6g}, 1e-4 "
           f"relative), rollout rel-L2 {rel_c:.5f} (CPU {rel_p:.5f}, 2e-3); training_rt's "
           f"40-pair ADAM step {t_step:.4f} s on {card}")

    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[climate] fused RHS kernel launches during phase 13: A {launched[0]}, B {launched[1]}, "
        f"runtime-width {launched[2]} (this path runs no hand-written kernel); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    if any(launched):
        raise AssertionError("phase 13 launched a fused RHS kernel; its paths reach none")


STIFF = ("Rosenbrock23", "SDIRK3", "Kvaerno3", "SDIRK4")
ROBER_1E4 = (1.07300429e-01, 4.80016698e-07, 8.92699091e-01)  # tests/test_stiff_dae.py:23


def _rober_rhs(t, y, args):
    """Robertson's RHS (tests/test_stiff_dae.py:13-19), each rate term
    computed once; the same values as the row-by-row form."""
    import torch

    y0, y1, y2 = y.unbind(0)
    a, b, c = 0.04 * y0, 1e4 * y1 * y2, 3e7 * y1 ** 2
    return torch.stack([b - a, a - c - b, c])


def _robertson(name, device):
    """Robertson to t = 1e4 with solver ``name`` (float64, rtol 1e-6, atol
    1e-10): ``(counts, y_final, seconds)``."""
    import torch
    import universal_differential_equations_torch as ude

    t0 = time.perf_counter()
    sol = ude.solve(ude.ODEProblem(_rober_rhs, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64,
                                                            device=device), (0.0, 1e4)),
                    getattr(ude, name)(), rtol=1e-6, atol=1e-10, adjoint=ude.NoAdjoint(),
                    max_steps=4096)
    counts = (bool(sol.success), int(sol.num_accepted), int(sol.num_rejected),
              int(sol.num_rhs_evals))
    return counts, sol.y_final.cpu().numpy(), time.perf_counter() - t0


def _fenep_truth(device, ts=None):
    """``find_sigma_exact`` with γ̇ = 12·cos t on ``ts`` (default: 50 points
    over one 2π cycle) in float32 with ``x64_host=True``, the BDF solve
    recorded: ``(tau12, success, counts, tau12 of the solve itself, its
    dtype and device)``."""
    import torch
    from universal_differential_equations_torch.models import fenep as fp

    if ts is None:
        ts = torch.linspace(0.0, 6.2831, 50, dtype=torch.float32, device=device)
    seen, daeint = [], fp.daeint

    def spy(*args, **kw):
        seen.append(daeint(*args, **kw))
        return seen[-1]

    fp.daeint = spy
    try:
        tau, ok = fp.find_sigma_exact(ts, lambda t: 12.0 * torch.cos(t), x64_host=True)
    finally:
        fp.daeint = daeint
    sol = seen[-1]
    counts = (bool(sol.success), int(sol.num_accepted), int(sol.num_rejected),
              int(sol.num_rhs_evals))
    return tau, bool(ok), counts, sol.ys[:, 5].cpu().numpy(), sol.ys.dtype, sol.ys.device


def _decay_grad(name, device):
    """The ``DiscreteAdjoint`` gradient of y(1)[0] for y' = (-k·y0, k·y0 - 1e3·y1)
    at k = 0.5 through solver ``name`` (float64; tests/test_stiff_dae.py:45-57)."""
    import torch
    import universal_differential_equations_torch as ude

    k = torch.tensor(0.5, dtype=torch.float64, device=device, requires_grad=True)
    prob = ude.ODEProblem(lambda t, y, a: torch.stack([-a * y[0], a * y[0] - 1e3 * y[1]]),
                          torch.tensor([1.0, 0.0], dtype=torch.float64, device=device),
                          (0.0, 1.0), k)
    sol = ude.solve(prob, getattr(ude, name)(), rtol=1e-7, atol=1e-9,
                    adjoint=ude.DiscreteAdjoint(), max_steps=256)
    sol.ys[-1, 0].backward()
    return float(k.grad)


def _stiff_dae_cpu_refs():
    """The CPU port's references for phase 14, run in a worker process beside
    the card's work."""
    import torch

    torch.set_num_threads(4)
    sys.path.insert(0, str(ROOT))
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    rober = {name: _robertson(name, cpu)[:2] for name in STIFF}
    tau, ok, counts, tau64, _, _ = _fenep_truth(cpu)
    grads = {name: _decay_grad(name, cpu) for name in ("Kvaerno3", "Rosenbrock23")}
    return dict(rober=rober, fenep=(tau.numpy(), ok, counts, tau64), grads=grads,
                seconds=time.perf_counter() - t0)


def _best_s(fn, repeats=5, warm_up=True):
    """Best wall seconds of ``repeats`` calls (after one warm-up unless the
    caller has just made the same call), the card synchronised around each."""
    if warm_up:
        fn()
    best = float("inf")
    for _ in range(repeats):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_stiff_dae(device, card):
    """Phase 14: slice F (see the module docstring)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch.examples import fenep as ex
    from universal_differential_equations_torch.models import fenep as fp
    from universal_differential_equations_torch.ops import stencil

    f32, f64 = torch.float32, torch.float64
    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    t_phase = time.perf_counter()
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = pool.submit(_stiff_dae_cpu_refs)

        # (a) Robertson with the four implicit solvers
        rober = {name: _robertson(name, device) for name in STIFF}
        # (b) the FENE-P truth, float32 in, float64 on the card
        tau, ok, counts, tau64, work_dtype, work_device = _fenep_truth(device)
        ts_fine = torch.linspace(0.0, 0.01, 5, dtype=f32, device=device)
        s_fine, ok_fine, _, _, _, _ = _fenep_truth(device, ts_fine)
        slope = float((s_fine[1] - s_fine[0]) / (ts_fine[1] - ts_fine[0]))
        prob = ude.DAEProblem(lambda t, u, du, a: torch.stack([du[0] + u[0], u[0] + u[1] - 1.0]),
                              torch.tensor([1.0, 0.0], dtype=f64, device=device),
                              torch.tensor([-1.0, 0.0], dtype=f64, device=device), (0.0, 1.0),
                              differential_vars=torch.tensor([True, False], device=device))
        ts5 = torch.linspace(0.0, 1.0, 5, dtype=f64, device=device)
        via_solve = ude.solve(prob, saveat=ts5)
        direct = ude.daeint(prob, saveat=ts5, rtol=1e-3, atol=1e-6, max_steps=4096)
        # (c) gradients; SDIRK4 on the index-1 reduction over (0, 4)
        grads = {name: _decay_grad(name, device) for name in ("Kvaerno3", "Rosenbrock23")}
        ts50 = torch.linspace(0.0, 6.2831, 50, dtype=f32, device=device)
        s_ode, ok_ode = fp.find_sigma_exact_ode(ts50[:20], lambda t: 12.0 * torch.cos(t),
                                                ude.SDIRK4())
        x_rel = float((s_ode - tau[:20]).abs().max() / tau[:20].abs().max())
        # (d) the timing rows
        f1, f0, params = fp.make_surrogate(torch.Generator().manual_seed(0), device=device)

        def surrogate():
            def rhs(t, u, p):
                return f1.apply(p["f1"], torch.cat([u, (12.0 * torch.cos(t))[None]]))
            sol = ude.solve(ude.ODEProblem(rhs, torch.zeros(1, dtype=f32, device=device),
                                           (0.0, 6.2831), params), ude.Tsit5(), saveat=ts50,
                            rtol=1e-5, atol=1e-7, adjoint=ude.NoAdjoint(), max_steps=256)
            inp = torch.stack([sol.ys[:, 0], 12.0 * torch.cos(ts50)], dim=1)
            return f0.apply(params["f0"], inp).sum()

        sur_us = _best_s(surrogate) * 1e6
        # (b)'s truth was the same call: it is this row's warm-up
        dae_us = _best_s(lambda: fp.find_sigma_exact(ts50, lambda t: 12.0 * torch.cos(t)),
                         repeats=2, warm_up=False) * 1e6
        ts100 = torch.linspace(ex.TSPAN[0], ex.TSPAN[1], 100, dtype=f32, device=device)
        nf1, nf0, p_init = ex.initial_surrogate(False, "jax", device=device)
        # the step's work does not depend on the data's values
        loss, _ = ex.make_loss(nf1, nf0, ts100, torch.zeros(len(ex.OMEGAS), 100, dtype=f32,
                                                             device=device))
        adam = lambda: ude.fit(loss, p_init, lambda ps: torch.optim.Adam(ps, lr=0.015), 1)  # noqa: E731
        adam()
        adam_s = median_s(adam, 1)
        t_card = time.perf_counter() - t_phase
        refs = refs.result()
    finally:
        pool.shutdown(cancel_futures=True)

    for name in STIFF:
        (n_c, y_c, wall), (n_p, y_p) = rober[name], refs["rober"][name]
        r = float(np.max(np.abs(y_c - y_p)) / np.max(np.abs(y_p)))
        radau = bool(np.all(np.abs(y_c - np.asarray(ROBER_1E4)) <= 1e-4 * np.asarray(ROBER_1E4)))
        mass = abs(float(y_c.sum()) - 1.0)
        _check(n_c[0] and n_c == n_p and r <= 1e-9 and radau and mass <= 1e-9,
               f"[stiff a] Robertson {name}: success/accepted/rejected/RHS {n_c} (CPU {n_p}), "
               f"y_final rel {r:.2e} (1e-9), within 1e-4 of Radau {radau}, mass {mass:.1e}; "
               f"{wall:.2f} s on {card}")
    tau_p, ok_p, counts_p, tau64_p = refs["fenep"]
    r_tau = float(np.max(np.abs(tau64 - tau64_p)) / np.max(np.abs(tau64_p)))
    on_card = (work_dtype == f64 and work_device.type == "cuda" and tau.dtype == f32
               and tau.device.type == "cuda")
    _check(ok and ok_p and on_card and counts == counts_p and r_tau <= 1e-9,
           f"[stiff b] FENE-P truth (find_sigma_exact, float32 in): BDF solve in {work_dtype} on "
           f"{work_device}, returned {tau.dtype} on {tau.device}; success/accepted/rejected/RHS "
           f"{counts} (CPU {counts_p}); tau12 rel {r_tau:.2e} of max|tau12| (1e-9)")
    _check(bool(ok_fine) and abs(slope - 24.0) / 24.0 < 0.05,
           f"[stiff b] FENE-P startup slope {slope:.4f} (24 within 5 %)")
    same = (torch.equal(via_solve.ys, direct.ys)
            and int(via_solve.num_accepted) == int(direct.num_accepted)
            and int(via_solve.num_rejected) == int(direct.num_rejected))
    _check(same and bool(via_solve.success),
           f"[stiff b] solve(DAEProblem) equals daeint with solve's defaults "
           f"({int(direct.num_accepted)} accepted, {int(direct.num_rejected)} rejected)")
    for name, g in grads.items():
        g_p = refs["grads"][name]
        r_g = abs(g / g_p - 1.0)
        _check(r_g <= 1e-8 and abs(g + math.exp(-0.5)) < 1e-4,
               f"[stiff c] DiscreteAdjoint gradient through {name}: {g:.12f} (CPU {g_p:.12f}, "
               f"rel {r_g:.1e}; -exp(-0.5) = {-math.exp(-0.5):.12f})")
    _check(bool(ok_ode) and x_rel < 1e-3,
           f"[stiff c] SDIRK4 on the index-1 reduction vs (b)'s BDF truth on its first 20 "
           f"points: max rel dev {x_rel:.2e} (1e-3)")
    log(f"[stiff d] fenep_surrogate_us_per_solve {sur_us:.1f} us (best of 5 after a warm-up), "
        f"dae_us_per_solve {dae_us:.1f} us (best of 2 after (b)); FENE-P ADAM step (6 modes, "
        f"DiscreteAdjoint, float32) {adam_s:.4f} s (after a warm-up step) on {card}")
    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[stiff] fused RHS kernel launches during phase 14: A {launched[0]}, B {launched[1]}, "
        f"runtime-width {launched[2]} (this path runs no hand-written kernel); card work "
        f"{t_card:.1f} s, CPU references {refs['seconds']:.1f} s beside it; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(launched):
        raise AssertionError("phase 14 launched a fused RHS kernel; its paths reach none")


SDE_PATHS = 2000
ADAPTIVE_LANES = 400
HJB_ITERS = 5


def _sde_problems(dtype, device):
    """OU (tests/test_sde_deepbsde.py:24-31; 300 steps) and GBM (:45-53; 256
    steps): ``{name: (problem, n_steps)}``."""
    import torch
    import universal_differential_equations_torch as ude

    one = torch.tensor([1.0], dtype=dtype, device=device)
    return {"OU": (ude.SDEProblem(f=lambda t, y, a: -1.5 * y,
                                  g=lambda t, y, a: 0.4 * torch.ones_like(y),
                                  u0=one, tspan=(0.0, 3.0)), 300),
            "GBM": (ude.SDEProblem(f=lambda t, y, a: 0.8 * y, g=lambda t, y, a: 0.3 * y,
                                   u0=one, tspan=(0.0, 1.0)), 256)}


def _sde_paths(device):
    """Phase 15 (a): ``sdeint`` over 2000 paths in one vmapped call per
    problem, solver and dtype, on increments drawn on the CPU (seed 15) and
    moved to ``device``: ``{(dtype, problem, solver): ys (2000, 31, 1)}``
    on the CPU."""
    import torch
    from universal_differential_equations_torch.solvers import sde

    out = {}
    for dtype in (torch.float64, torch.float32):
        for name, (prob, n) in _sde_problems(dtype, device).items():
            t0, t1 = prob.tspan
            z = torch.randn((SDE_PATHS, n, 1), generator=torch.Generator().manual_seed(15),
                            dtype=torch.float64)
            dws = (z * math.sqrt((t1 - t0) / n)).to(dtype=dtype, device=device)
            ts = torch.linspace(t0, t1, 31, dtype=dtype, device=device)
            for solver in ("EulerMaruyama", "EulerHeun"):
                step = getattr(sde, solver)()
                sol = torch.func.vmap(lambda w: sde.sdeint(prob, step, dws=w, saveat=ts))(dws)
                out[(str(dtype), name, solver)] = sol.ys.cpu()
    return out


def _adaptive_lanes(device):
    """Phase 15 (b): ``AdaptiveEM`` (grid 512, abstol 1e-4, reltol 1e-3) over
    400 OU lanes in one vmapped call, float64, grid increments from seed 16,
    and ``sdeint`` on the same grid: ``(num_steps, y_final, fixed y_final,
    host reads)``."""
    import torch
    from universal_differential_equations_torch.solvers import sde

    prob, _ = _sde_problems(torch.float64, device)["OU"]
    z = torch.randn((ADAPTIVE_LANES, 512, 1), generator=torch.Generator().manual_seed(16),
                    dtype=torch.float64)
    incs = (z * math.sqrt(3.0 / 512)).to(device)
    alg = sde.AdaptiveEM(grid_resolution=512, abstol=1e-4, reltol=1e-3)
    reads = sde.host_reads
    sol = torch.func.vmap(lambda w: alg.solve(prob, dws=w))(incs)
    n_steps, y_final = sol.num_steps.cpu(), sol.y_final[:, 0].cpu()
    reads = sde.host_reads - reads
    fixed = torch.func.vmap(lambda w: sde.sdeint(prob, dws=w).y_final[0])(incs)
    return n_steps, y_final, fixed.cpu(), reads


def _hjb_normals():
    """Phase 15 (c)'s draws, on the CPU: 5 iterations' (100, 20, 100)
    normals and the pilot's (8, 1024, 100), float32, seed 17."""
    import torch

    g = torch.Generator().manual_seed(17)
    return (torch.randn((HJB_ITERS, 100, 20, 100), generator=g),
            torch.randn((8, 1024, 100), generator=g))


def _hjb_parity(device):
    """Phase 15 (c): the HJB at full width (d = 100, m = 100, n_steps = 20,
    float32) from ``torch.Generator(0)``'s initial weights: the losses of 5
    ADAM iterations on ``_hjb_normals``' draws, and the grid an AdaptiveEM
    pilot over 8 lanes picks from its pilot draws (tolerances 2e-2, one
    training iteration on that grid)."""
    import torch
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.examples import hjb_100d

    prob, alg = hjb_100d.hjb_problem(device)
    g = torch.Generator().manual_seed(0)
    params = {"u0": alg.u0_net.init(g, device=device), "grad": alg.grad_net.init(g, device=device)}
    iters, pilot = _hjb_normals()
    step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, 20)
    losses = [float(step(iters[i].to(device))) for i in range(HJB_ITERS)]

    def normals(stage, it, shape):
        return pilot if stage == "pilot" else torch.zeros(shape)

    res = deepbsde.solve_terminal_pde(prob, alg, params=params, normals=normals, maxiters=1,
                                      adaptive=True, sde_abstol=2e-2, sde_reltol=2e-2,
                                      max_refinements=0)
    return losses, res.n_steps, step, prob, alg, params


def _mc_draws():
    """Phase 15 (d)'s draws: 10 batches of 10^4 samples at d = 100, float32,
    seed 7, on the CPU."""
    import torch

    return torch.randn((10, 10**4, 100), generator=torch.Generator().manual_seed(7))


def _sde_bsde_cpu_refs():
    """The CPU port's references for phase 15, run in a worker process beside
    the card's work."""
    import torch
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.examples import hjb_100d

    torch.set_num_threads(4)
    sys.path.insert(0, str(ROOT))
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    paths = _sde_paths(cpu)
    lanes = _adaptive_lanes(cpu)
    losses, n_pilot = _hjb_parity(cpu)[:2]
    prob, _ = hjb_100d.hjb_problem(cpu)
    mc = deepbsde.mc_analytical_hjb(prob.g, prob.x0, 1.0, 1.0, normals=_mc_draws())
    return dict(paths=paths, lanes=lanes, losses=losses, n_pilot=n_pilot, mc=mc,
                seconds=time.perf_counter() - t0)


def phase_sde_bsde(device, card):
    """Phase 15: slice G (see the module docstring)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.ops import stencil
    from universal_differential_equations_torch.solvers import sde
    from universal_differential_equations_torch.utils import profiling

    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    t_phase = time.perf_counter()
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = pool.submit(_sde_bsde_cpu_refs)
        paths = _sde_paths(device)
        n_steps, y_final, fixed, reads = _adaptive_lanes(device)
        losses, n_pilot, _, prob, alg, params = _hjb_parity(device)
        timing = {}
        for n in (20, 50):
            z = torch.randn((100, n, 100), generator=torch.Generator().manual_seed(n)).to(device)
            step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, n)
            timing[n] = profiling.benchmark(step, z, repeats=20, warmup=1)
        mc = deepbsde.mc_analytical_hjb(prob.g, prob.x0, 1.0, 1.0, normals=_mc_draws())
        t_card = time.perf_counter() - t_phase
        refs = refs.result()
    finally:
        pool.shutdown(cancel_futures=True)

    for key, ys in paths.items():
        ref = refs["paths"][key]
        r = _rel(ys, ref)
        bound = 1e-12 if key[0] == "torch.float64" else 1e-5
        _check(torch.isfinite(ys).all() and r <= bound,
               f"[sde a] sdeint {key[2]} on {key[1]} in {key[0]}, {SDE_PATHS} paths in one vmapped "
               f"call: card against CPU rel {r:.2e} ({bound:g})")
    y_ou = paths[("torch.float64", "OU", "EulerMaruyama")][:, -1, 0]
    mean, var = float(y_ou.mean()), float(y_ou.var(correction=0))
    _check(abs(mean - math.exp(-4.5)) < 0.01 and abs(var - 0.4 ** 2 / 3.0) < 0.008,
           f"[sde a] EM OU at T = 3: mean {mean:.5f} (e^-4.5 = {math.exp(-4.5):.5f} within 0.01), "
           f"variance {var:.5f} ({0.4 ** 2 / 3.0:.5f} within 0.008)")
    n_ref, y_ref, _, _ = refs["lanes"]
    r = _rel(y_final, y_ref)
    gap = float((y_final - fixed).abs().mean())
    _check(torch.equal(n_steps, n_ref) and r <= 1e-12 and gap < 0.02,
           f"[sde b] AdaptiveEM over {ADAPTIVE_LANES} OU lanes in one vmapped call: every lane's "
           f"num_steps equals the CPU's ({int(n_steps.min())}-{int(n_steps.max())} steps), y_final "
           f"rel {r:.2e} (1e-12), mean |adaptive - fixed| {gap:.5f} (0.02); {reads} host reads "
           f"for the solve (one per {sde._BLOCK} attempts)")
    r_loss = max(abs(a / b - 1.0) for a, b in zip(losses, refs["losses"]))
    _check(all(math.isfinite(x) for x in losses) and r_loss <= 1e-4,
           f"[sde c] HJB d = 100, m = 100, n_steps = 20, float32: {HJB_ITERS} ADAM iterations, "
           f"losses {[round(x, 6) for x in losses]} within {r_loss:.1e} of the CPU's (1e-4)")
    _check(n_pilot == refs["n_pilot"],
           f"[sde c] AdaptiveEM pilot (8 lanes, 2e-2): n_steps {n_pilot} on the card, "
           f"{refs['n_pilot']} on the CPU")
    log(f"[sde c] deep-BSDE s per iteration (median of 20 after a warm-up): n_steps 20 "
        f"{timing[20]['median_s']:.5f} s, n_steps 50 {timing[50]['median_s']:.5f} s "
        f"(first calls {timing[20]['compile_s']:.3f} / {timing[50]['compile_s']:.3f} s) on {card}")
    r_mc = abs(mc / refs["mc"] - 1.0)
    _check(math.isfinite(mc) and r_mc <= 1e-5,
           f"[sde d] mc_analytical_hjb d = 100, 10^5 samples, float32: {mc:.6f} on the card, "
           f"{refs['mc']:.6f} on the CPU (rel {r_mc:.1e}, 1e-5)")
    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[sde] fused RHS kernel launches during phase 15: A {launched[0]}, B {launched[1]}, "
        f"runtime-width {launched[2]} (this path runs no hand-written kernel); card work "
        f"{t_card:.1f} s, CPU references {refs['seconds']:.1f} s beside it; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(launched):
        raise AssertionError("phase 15 launched a fused RHS kernel; its paths reach none")


RT_SHAPE = (128, 2, 128)


def _recover_unsharded(device, theta, data, loss, mags):
    """Phase 16 (d)'s unsharded recover stage, in a worker process on
    ``device`` beside the sharded run: ``(outputs on the host, seconds)``."""
    import torch

    s = _study_stages(device)
    args = [torch.as_tensor(a, device=device) for a in (theta, data, loss, mags)]
    if args[0].is_cuda:
        _sync()
    t0 = time.perf_counter()
    out = [o.cpu() for o in s.recover_stage(*args)]
    return out, time.perf_counter() - t0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_pair(fn, mesh):
    """``fn(None)`` and ``fn(mesh)``, with the host seconds of each (the card
    synchronised around each)."""
    out, secs = [], []
    for m in (None, mesh):
        _sync()
        t0 = time.perf_counter()
        out.append(fn(m))
        _sync()
        secs.append(time.perf_counter() - t0)
    return out, secs


def phase_parallel(device, card):
    """Phase 16: slice H.1 (see the module docstring)."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import torch
    import torch.distributed as dist
    import universal_differential_equations_torch as ude
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.ensemble import ensemble_run
    from universal_differential_equations_torch.examples import hjb_100d
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.models import climate_datagen as dg
    from universal_differential_equations_torch.models import lotka_volterra as lv
    from universal_differential_equations_torch.ops import stencil
    from universal_differential_equations_torch.parallel import (
        ensemble_mesh,
        initialize_distributed,
        process_count,
    )
    from universal_differential_equations_torch.utils import profiling

    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    t_phase = time.perf_counter()
    f32 = torch.float32
    dry = pool = None
    try:
        initialize_distributed(f"localhost:{_free_port()}", 1, 0, device=device)
        backend = "nccl" if device.type == "cuda" else "gloo"
        _check(dist.get_backend() == backend and process_count() == 1,
               f"[parallel] one-rank process group: backend {dist.get_backend()}, "
               f"{process_count()} rank")
        mesh = ensemble_mesh(device=device)
        xmesh = ensemble_mesh(axis="x", device=device)

        # the timings first, on a quiet host: with and without the mesh, in turns
        prob, alg = hjb_100d.hjb_problem(device)
        g = torch.Generator().manual_seed(0)
        params = {"u0": alg.u0_net.init(g, device=device),
                  "grad": alg.grad_net.init(g, device=device)}
        timing = {}
        for n in (20, 50):
            zn = torch.randn((100, n, 100), generator=torch.Generator().manual_seed(n)).to(device)
            for m in (None, mesh, mesh, None):
                step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, n, mesh=m)
                st = profiling.benchmark(step, zn, repeats=10, warmup=1)
                timing.setdefault((n, m is not None), []).append(st["median_s"])
        for n in (20, 50):
            plain, sharded = min(timing[(n, False)]), min(timing[(n, True)])
            log(f"[parallel c] deep-BSDE s per iteration at n_steps {n}: {plain * 1e3:.2f} ms "
                f"without the mesh, {sharded * 1e3:.2f} ms with it (one-rank NCCL; medians of "
                f"10, best of 2 alternated runs each; overhead {(sharded - plain) * 1e3:+.2f} "
                f"ms) on {card}")
        for bc in ("periodic", "rigid_lid"):
            ms = {False: [], True: []}
            for m in (None, xmesh, xmesh, None):
                ms[m is not None].append(dg.rt_step_seconds(RT_SHAPE, repeats=5, bc=bc, mesh=m,
                                                            device=device) * 1e3)
            log(f"[parallel e] RT ms per step {RT_SHAPE} bc={bc}: {min(ms[False]):.3f} ms "
                f"without the mesh, {min(ms[True]):.3f} ms with it (CUDA events, best of 5, "
                f"2 alternated runs each) on {card}")

        # the gloo dry run on the host's CPU, and (d)'s unsharded run in a
        # worker on the card, beside the checks
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        dry = subprocess.Popen([sys.executable, "-m", f"{PKG}.parallel.dryrun", "2"],
                               cwd=ROOT, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        pool.submit(_warm_study, str(device))

        # (d) run_loops' recover stage on one chunk of the JAX study's lanes,
        # sharded here while the worker runs it unsharded
        st = rl.build_stages(device=device, mesh=mesh)
        data_l, theta0, mags = st.lane_inputs(torch.arange(rl.CHUNK).numpy(), 100)
        theta, _ = st.adam_stage(theta0, data_l, steps=5)
        loss = torch.full((rl.CHUNK,), 1e-4, device=device)
        ref_f = pool.submit(_recover_unsharded, str(device),
                            *(x.cpu().numpy() for x in (theta, data_l, loss, mags)))
        _sync()
        t0 = time.perf_counter()
        rec = [o.cpu() for o in st.recover_stage(theta, data_l, loss, mags)]
        t_sharded = time.perf_counter() - t0

        # (a) ensemble_run over 64 LV lanes
        ts = torch.linspace(0.0, 3.0, 31, dtype=f32, device=device)
        p = lv.P_TRUE.to(device, f32)
        z = torch.rand((64, 2), generator=torch.Generator().manual_seed(16), dtype=f32)
        u0s = (lv.U0.to(f32) * (1.0 + 0.1 * (2.0 * z - 1.0))).to(device)

        def run(x0):
            sol = ude.solve(ude.ODEProblem(lv.lotka_rhs, x0, (0.0, 3.0), p), ude.Tsit5(),
                            saveat=ts, rtol=1e-6, atol=1e-6, adjoint=ude.NoAdjoint())
            return sol.ys, sol.success

        (ref, got), secs = _mesh_pair(
            lambda m: ensemble_run(run, u0s, mesh=m, sharded=m is not None), mesh)
        r = _rel(got.outputs, ref.outputs)
        _check(got.num_success == 64 and torch.equal(got.success, ref.success) and r <= 1e-6,
               f"[parallel a] ensemble_run(sharded=True) over 64 LV lanes on the one-rank mesh: "
               f"{got.num_success} succeed, rel {r:.1e} to unsharded (1e-6); "
               f"{secs[1]:.3f} s against {secs[0]:.3f} s")

        # (b) multiple_shoot, loss and gradient
        ts_ms = torch.linspace(0.0, 1.6, 17, dtype=f32, device=device)
        data = ude.solve(ude.ODEProblem(lv.lotka_rhs, lv.U0.to(device, f32), (0.0, 1.6), p),
                         ude.Tsit5(), saveat=ts_ms, rtol=1e-5, atol=1e-7,
                         adjoint=ude.NoAdjoint()).ys

        def shoot(m):
            return torch.func.grad_and_value(lambda q: ude.multiple_shoot(
                q, data, ts_ms, lv.lotka_rhs, group_size=3, continuity_term=10.0, rtol=1e-4,
                atol=1e-6, max_steps=64, mesh=m))(p * 1.1)

        ((g0, l0), (g1, l1)), _ = _mesh_pair(shoot, mesh)
        r = max(_rel(l1, l0), _rel(g1, g0))
        _check(bool(torch.isfinite(g1).all()) and r <= 1e-6,
               f"[parallel b] multiple_shoot(mesh=) loss {float(l1):.6f} and its torch.func.grad "
               f"(8 segments) rel {r:.1e} to unsharded (1e-6)")

        # (c) deep-BSDE at the HJB's width: 5 iterations on the same draws
        normals = torch.randn((5, 100, 20, 100), generator=torch.Generator().manual_seed(17))
        losses = []
        for m in (None, mesh):
            step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, 20, mesh=m)
            losses.append(torch.stack([step(normals[i].to(device)) for i in range(5)]))
        r = _rel(losses[1], losses[0])
        _check(bool(torch.isfinite(losses[1]).all()) and r <= 1e-5,
               f"[parallel c] deep-BSDE d = 100, m = 100, n_steps = 20: 5 iterations on the mesh, "
               f"losses rel {r:.1e} to unsharded (1e-5)")

        # (e) one RT chunk at 128x2x128, both boundary treatments
        for bc in ("periodic", "rigid_lid"):
            outs = []
            for m in (None, xmesh):
                state, _, chunk, _ = dg._rt_stepper(RT_SHAPE, (1.0, 2 / 128, 1.0), 1e-4, 1e-4,
                                                    1.0, 10, torch.Generator().manual_seed(4),
                                                    f32, mesh=m, bc=bc, device=device)
                outs.append(chunk(state, torch.tensor(2e-3, device=device)))
            r = max(_rel(a, b) for a, b in zip(outs[1][0], outs[0][0]))
            _check(r <= 5e-5 and _rel(outs[1][1], outs[0][1]) <= 1e-5,
                   f"[parallel e] RT chunk {RT_SHAPE} bc={bc} (10 Heun/Leray steps) on the "
                   f"x-decomposed one-rank mesh: fields rel {r:.1e} to unsharded (5e-5), umax "
                   f"{float(outs[1][1]):.4e}")
        rec_ref, t_ref = ref_f.result()
        same = all(torch.equal(a, b) or (a.dtype != torch.bool and _rel(a, b) <= 1e-6)
                   for a, b in zip(rec, rec_ref))
        _check(same, f"[parallel d] run_loops recover stage (the study's judge: K_SEL "
                     f"{rl.K_SEL}, refit budget {rl.REFIT_ITERS}, top {rl.REFIT_TOP}), one "
                     f"chunk of {rl.CHUNK} lanes split over the mesh: selections equal "
                     f"unsharded, coefficients within 1e-6; {t_sharded:.2f} s sharded here, "
                     f"{t_ref:.2f} s unsharded in the worker beside it")
        t_card = time.perf_counter() - t_phase
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        if dry is not None:
            try:
                out, _ = dry.communicate(timeout=240)
            finally:
                if dry.poll() is None:
                    dry.kill()
                    dry.communicate()
    lines = [line for line in out.splitlines() if line.startswith("dryrun_multichip(2)")]
    for line in lines:
        log(f"[parallel f] {line}")
    if dry.returncode != 0 or len(lines) != 6:
        raise AssertionError(f"dryrun_multichip(2) on gloo CPU ranks failed (rc "
                             f"{dry.returncode}):\n{out[-3000:]}")
    launched = (stencil.launches, stencil.tangent_launches, stencil.generic_launches)
    log(f"[parallel] fused RHS kernel launches during phase 16: A {launched[0]}, B "
        f"{launched[1]}, runtime-width {launched[2]} (this path runs no hand-written kernel); "
        f"card work {t_card:.1f} s; phase wall {time.perf_counter() - t_phase:.1f} s")
    if any(launched):
        raise AssertionError("phase 16 launched a fused RHS kernel; its paths reach none")


PLOT_NAMES = {  # the JAX scripts' figure files, by port script
    "lv_scenario_1": {"scenario_1_fit.pdf", "scenario_1_missing_term.pdf", "scenario_1_loss.pdf",
                      "scenario_1_extrapolation.pdf"},
    "lv_scenario_2": {"scenario_2_fit.pdf"},
    "lv_scenario_3": {"scenario_3_truth.pdf", "scenario_3_learned.pdf",
                      "scenario_3_reaction.pdf"},
    "hudson_bay": {"hudson_bay_fit.pdf", "hudson_bay_extrapolation.pdf"},
    "seir_exposure": {"seir_exposure_term.pdf", "seir_extrapolation.pdf"},
    "hjb_100d": {"hjb_loss.pdf"},
    "fenep": {"fenep_test_response.pdf"},
    "climate_neural_pde": {"npde_flux.pdf", "npde_rollout.pdf"},
    "climate_neural_pde_data": {"npde_data_truth.pdf", "npde_data_rollout.pdf"},
    "climate_training_rt": {"rt_data.pdf", "rt_rollout.pdf", "rt_profiles.pdf", "rt_rollout.gif"},
    "climate_data_generation": {"rt_averages.pdf"},
}
STUDY_NAMES = {"loop_success_exact.pdf", "loop_success_contains.pdf", "loop_coefficients.pdf",
               "loop_losses.pdf", "loop_err_aicc.pdf", "loop_loss_histories.pdf",
               "loop_sparsity.pdf", "loop_trajectories.pdf"}


def _figure_calls(device, curves):
    """Each other script's figure function on CUDA tensors made from a seed
    (numpy where the script hands its function numpy; ``curves``, the
    reaction and flux curves phase 17 (d) computed on the card):
    ``{script: call(outdir)}``."""
    import importlib

    import numpy as np
    import torch

    ex = {name: importlib.import_module(f"{PKG}.examples.{name}") for name in PLOT_NAMES}
    rng = np.random.default_rng(17)

    def t(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=device)

    def cuda(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    z = np.linspace(-0.5, 0.5, 64)
    return {
        "lv_scenario_1": lambda out: ex["lv_scenario_1"].write_plots(
            cuda(np.linspace(0.0, 3.0, 31)), t(31, 2, lo=1, hi=5), t(31, 2, lo=1, hi=5),
            t(31, 2), t(200), cuda(np.linspace(0.0, 50.0, 501)), t(501, 2), t(501, 2), 3.0, out),
        "lv_scenario_2": lambda out: ex["lv_scenario_2"].write_plots(
            cuda(np.arange(0.0, 6.01, 0.05)), t(121, 2), cuda(np.linspace(0.0, 6.0, 61)),
            t(61, 2), t(), out),
        "lv_scenario_3": lambda out: ex["lv_scenario_3"].write_plots(
            t(11, 26), t(11, 26), curves["lv_scenario_3"], out),
        "hudson_bay": lambda out: ex["hudson_bay"].write_plots(
            cuda(np.arange(21.0)), t(21, 2), t(41, 2), t(201, 2), out),
        "seir_exposure": lambda out: ex["seir_exposure"].write_plots(
            cuda(np.arange(22.0)), t(22), t(22), cuda(np.arange(61.0)), t(61, 7), t(61, 7), out),
        "hjb_100d": lambda out: ex["hjb_100d"].write_plots(t(1400), 4.59, 4.60, 0.002, out),
        "fenep": lambda out: ex["fenep"].write_plots(
            cuda(np.linspace(0.0, 10.0, 100)), t(100), rng.random(100), rng.random(100), out),
        "climate_neural_pde": lambda out: ex["climate_neural_pde"].write_plots(
            curves["climate_neural_pde"], t(30, 30), out),
        "climate_neural_pde_data": lambda out: ex["climate_neural_pde_data"].write_plots(
            z, 32, (0.0, 4.0), t(41, 30), t(41, 30), out),
        "climate_training_rt": lambda out: ex["climate_training_rt"].write_plots(
            np.arange(21) * 0.1, z, rng.random((21, 16)), rng.random((21, 16)), 16, out),
        "climate_data_generation": lambda out: ex["climate_data_generation"].write_plots(
            np.arange(41) * 0.1, z, rng.random((41, 64)), out),
    }


def phase_plots(device, card, ts, ys):
    """Phase 17: ``viz.py`` and every example's figures on the card."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import torch
    from universal_differential_equations_torch.examples import fisher_kpp as fx
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.flatten_util import tree_flatten
    from universal_differential_equations_torch.models import fisher_kpp as fk
    from universal_differential_equations_torch.ops import stencil

    t_phase = time.perf_counter()
    # (a) the host's plotting libraries: matplotlib renders, Pillow writes the GIF
    versions = {}
    for lib in ("matplotlib", "PIL"):
        if importlib.util.find_spec(lib) is not None:
            versions[lib] = __import__(lib).__version__
    render = "matplotlib" in versions and "PIL" in versions
    log(f"[plots a] matplotlib {versions.get('matplotlib', 'absent')}, Pillow "
        f"{versions.get('PIL', 'absent')} on this host"
        + ("" if render else ": the arrays are checked on the card, no figure is rendered"))
    tmp = Path(tempfile.mkdtemp(prefix="ude_plots_"))
    written = {}

    def names(case):
        return {p.name for p in (tmp / case).iterdir() if p.stat().st_size > 0}

    # (b) Fisher-KPP mlp: the dashboard as the ADAM warmup's callback, one LM
    # iteration, then the figures' arrays through kernel A against the plain
    # RHS on the card and against the CPU
    launches = []
    rhs, params0 = fk.make_model(torch.Generator().manual_seed(0), "mlp", device=device)
    dashboard = fx.make_dashboard("mlp", tmp / "fisher_kpp") if render else None

    def on_stage(name, value):
        launches.append((name, stencil.launches, stencil.tangent_launches))
        stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0

    stencil.launches = stencil.tangent_launches = stencil.generic_launches = 0
    params, final = fx.train("mlp", params0, fk.make_residuals(rhs, ts, ys), adam_steps=3,
                             lm_iters=1, refine_steps=0, on_stage=on_stage, dashboard=dashboard)
    by = {name: (a, b) for name, a, b in launches}
    dash_ok = dashboard is None or (len(dashboard.steps) >= 1
                                    and (tmp / "fisher_kpp" / "dashboard.png").exists())
    _check(by["adam"][0] > 0 and by["lm"][1] > 0 and math.isfinite(final) and dash_ok,
           f"[plots b] fisher_kpp.train (mlp, 3 ADAM steps, 1 LM iteration) with the dashboard: "
           f"kernel A {by['adam'][0]} launches under ADAM, A {by['lm'][0]} and B {by['lm'][1]} "
           f"under LM; loss {final:.6g}; dashboard.png "
           + (f"written at steps {dashboard.steps}" if dashboard else "not rendered"))
    stencil.launches = 0
    pred_k, u_grid, r_k = fx.learned_figures("mlp", ts, ys, params)
    a_fig = stencil.launches
    use_fused = fk._use_fused
    fk._use_fused = lambda u: False
    try:
        _, _, r_p = fx.learned_figures("mlp", ts, ys, params)
    finally:
        fk._use_fused = use_fused
    leaves, build = tree_flatten(params)
    cpu_params = build([leaf.cpu() for leaf in leaves])
    pred_c, _, _ = fx.learned_figures("mlp", ts.cpu(), ys.cpu(), cpu_params)
    err_r = float(np.abs(r_k - r_p).max())
    err_f = float(np.abs(pred_k - pred_c).max())
    _check(a_fig > 0 and err_r <= 1e-5 and err_f <= 1e-4,
           f"[plots b] write_plots' arrays (mlp): kernel A {a_fig} launches; reaction curve "
           f"(101 constant fields) against the plain RHS max |diff| {err_r:.2e} (1e-5); learned "
           f"field against the CPU's {err_f:.2e} (1e-4)")
    if render:
        fx.write_plots("mlp", ts, ys, params, tmp / "fisher_kpp")
        written["fisher_kpp"] = names("fisher_kpp")
        expect = {f"mlp_{n}.pdf" for n in ("truth", "learned", "error", "reaction")}
        _check(written["fisher_kpp"] == expect | {"dashboard.png"},
               f"[plots b] fisher_kpp figures: {sorted(written['fisher_kpp'])}")
    a_phase = sum(a for _, a, _ in launches) + a_fig

    # (c) the study's figures from the JAX archive (read only); the truth and
    # six recovered-model solves of loop_trajectories on the card and the CPU
    study = ROOT / "examples" / "lotka_volterra" / "results"
    with np.load(study / "loop_study.npz") as z:
        exact, c1, c2 = z["exact"], z["coef1"], z["coef2"]
    flat = exact.ravel().astype(bool)
    runs = np.concatenate([np.nonzero(flat)[0][:3],
                           np.nonzero(~flat & np.isfinite(c1[:, rl.I_XY]))[0][:3]])
    t0 = time.perf_counter()
    _, truth_k, ys_k = rl.recovered_trajectories(c1, c2, runs, device)
    s_k = time.perf_counter() - t0
    _, truth_c, ys_c = rl.recovered_trajectories(c1, c2, runs, "cpu")
    scale = np.maximum(1.0, np.abs(ys_c).max(axis=(1, 2)))
    err_t = max(float(np.abs(truth_k - truth_c).max()),
                float((np.abs(ys_k - ys_c).max(axis=(1, 2)) / scale).max()))
    _check(err_t <= 1e-4 and np.isfinite(ys_k).all(),
           f"[plots c] loop_trajectories' solves (runs {runs.tolist()}, float32): card against "
           f"CPU max |diff| {err_t:.2e} (1e-4, relative to each run's largest value); "
           f"{s_k:.2f} s on the card")
    if render:
        rl.plot_archive(study, outdir=tmp / "lotka_volterra", device=device)
        written["run_loops"] = names("lotka_volterra")
        _check(written["run_loops"] == STUDY_NAMES,
               f"[plots c] run_loops.plot_archive from the JAX archive: {len(STUDY_NAMES)} "
               f"figures")

    # (d) the other figures' device work, card against CPU: scenario 3's NN
    # and SINDy reaction curves, the climate column's flux curve; then, where
    # matplotlib is, every other script's figure function on CUDA tensors
    from universal_differential_equations_torch.examples import climate_neural_pde as npde
    from universal_differential_equations_torch.examples import lv_scenario_3 as s3

    curves, err_d = {}, 0.0
    u = torch.linspace(0.0, 1.0, 64, dtype=torch.float64)[:, None]
    rec = s3.recover(u, u * (1 - u))
    flux_data = torch.as_tensor(np.random.default_rng(5).uniform(-1.0, 1.5, (30, 30)),
                                dtype=torch.float32)
    for dev in (device, torch.device("cpu")):
        _, p3, rx = s3.make_model(torch.Generator().manual_seed(s3.SEED), device=dev)
        _, pn, net = npde.cn.make_neural_rhs(torch.Generator().manual_seed(0), device=dev)
        got = {"lv_scenario_3": s3.reaction_curves(rx, p3, rec),
               "climate_neural_pde": npde.flux_curves(net, pn, flux_data.to(dev))}
        if dev == device:
            curves = got
        else:
            err_d = max(float(np.abs(a - b).max()) for k in got
                        for a, b in zip(curves[k], got[k]))
    _check(err_d <= 1e-5, f"[plots d] scenario 3's reaction curves and the climate column's "
           f"flux curve, card against CPU: max |diff| {err_d:.2e} (1e-5)")
    if render:
        for script, call in _figure_calls(device, curves).items():
            out = tmp / script
            call(out)
            written[script] = names(script)
            _check(written[script] == PLOT_NAMES[script],
                   f"[plots d] {script}: {sorted(written[script])}")
    n_files = sum(len(v) for v in written.values())
    shutil.rmtree(tmp)
    log(f"[plots] {n_files} figure files written and non-empty (of the JAX scripts' 36)"
        if render else "[plots] no figure rendered: matplotlib or Pillow is absent on this host")
    _check(a_phase > 0, f"[plots] kernel A launches in phase 17: {a_phase}; phase wall "
           f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return n_files, a_phase


def main():
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke.py: the package {PKG}/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    device = torch.device("cuda", 0)
    import universal_differential_equations_torch  # noqa: F401  (sets TF32 off)

    phase_build()
    kern = phase_kernel(device)
    launches, _, ts, ys = phase_main_path(device)
    phase_bench_task(device, card, ts, ys)
    phase_lv(device, card)
    phase_lanes(device, card)
    phase_seir_lv3(device, card)
    phase_fkpp(device, card, ts, ys)
    phase_ensemble(device, card)
    phase_surface(device, card)
    lane_kernel = phase_lv_study(device, card)
    phase_climate(device, card)
    phase_stiff_dae(device, card)
    phase_sde_bsde(device, card)
    phase_parallel(device, card)
    phase_plots(device, card, ts, ys)
    log(f"[total] every phase passed in {time.perf_counter() - t_start:.1f} s")

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
    }, {
        "name": "lv_lanes_kernel",
        "route": "cuda",
        "source": f"{PKG}/csrc/lv_lanes.cu",
        "replaces": None,
        "library_ms": None,
        **lane_kernel,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

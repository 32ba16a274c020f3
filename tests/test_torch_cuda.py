"""PyTorch port on a CUDA card: the fused RHS kernel and the main path through it.

Every test needs a card and skips where there is none.  The file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)  The
reference is the plain PyTorch version of the same function, on the same
card, at the 2e-5 float32 bound of ``tests/test_ops_misc.py``.
"""
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
from universal_differential_equations_torch.models import fisher_kpp as tfk
from universal_differential_equations_torch.ops import stencil

pytestmark = pytest.mark.cuda

PAPER = (1, 10, 20, 10, 1)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(seed, n, device, sizes=PAPER, rows=None):
    g = torch.Generator().manual_seed(seed)
    shape = (n,) if rows is None else (rows, n)
    u = torch.rand(shape, generator=g).to(device)
    taps = torch.tensor([6.25, -12.5, 6.25], device=device)
    d0 = torch.tensor(0.7, device=device)
    mlp = [(w, 0.1 * torch.randn(b.shape, generator=g).to(device))
           for w, b in stencil.make_pointwise_mlp_params(g, sizes, device=device)]
    return u, taps, d0, mlp


def _flat(mlp):
    return [x for wb in mlp for x in wb]


@pytest.mark.parametrize("sizes", [PAPER, (1, 3, 1)])
@pytest.mark.parametrize("n", [26, 1024, 131072])
def test_kernel_matches_plain(cuda_device, sizes, n):
    args = _inputs(0, n, cuda_device, sizes)
    before = stencil.launches
    out = stencil.fused_updet_rhs(*args)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    torch.testing.assert_close(out, stencil.updet_rhs_torch(*args), **TOL)


def test_kernel_rows(cuda_device):
    args = _inputs(1, 1024, cuda_device, rows=8)
    torch.testing.assert_close(stencil.fused_updet_rhs(*args),
                               stencil.updet_rhs_torch(*args), **TOL)


@pytest.mark.parametrize("n", [26, 300])
@pytest.mark.parametrize("pick", ["left", "right"])
def test_kernel_periodic_wrap(cuda_device, n, pick):
    u = torch.zeros(n, device=cuda_device)
    u[0], u[-1] = 1.0, 2.0
    taps = torch.tensor([1.0, 0.0, 0.0] if pick == "left" else [0.0, 0.0, 1.0],
                        device=cuda_device)
    mlp = [(torch.zeros(1, 1, device=cuda_device), torch.zeros(1, device=cuda_device))]
    out = stencil.fused_updet_rhs(u, taps, torch.tensor(1.0, device=cuda_device), mlp)
    assert torch.equal(out, torch.roll(u, 1 if pick == "left" else -1))


def test_autograd_function_jvp_and_grad_match_plain(cuda_device):
    u, taps, d0, mlp = _inputs(2, 1024, cuda_device)
    primals = (u, taps, d0, *_flat(mlp))
    g = torch.Generator().manual_seed(20)
    tangents = tuple(torch.randn(p.shape, generator=g).to(cuda_device) for p in primals)

    def plain(u_, t_, d_, *f):
        return stencil.updet_rhs_torch(u_, t_, d_, stencil._pairs(f))

    _, jvp_k = torch.func.jvp(stencil.FusedUpdetRHS.apply, primals, tangents)
    _, jvp_p = torch.func.jvp(plain, primals, tangents)
    torch.testing.assert_close(jvp_k, jvp_p, rtol=1e-4, atol=1e-4)
    leaves = [p.clone().requires_grad_(True) for p in primals]
    grads_k = torch.autograd.grad((stencil.FusedUpdetRHS.apply(*leaves) ** 2).sum(), leaves)
    grads_p = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    for a, b in zip(grads_k, grads_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


def test_vmap_rule_sends_states_as_rows(cuda_device):
    u, taps, d0, mlp = _inputs(3, 512, cuda_device, rows=4)
    before = stencil.launches
    out = torch.func.vmap(lambda uu: stencil.FusedUpdetRHS.apply(uu, taps, d0, *_flat(mlp)))(u)
    assert stencil.launches == before + 1
    torch.testing.assert_close(out, stencil.updet_rhs_torch(u, taps, d0, mlp), **TOL)


def test_kernel_raises_instead_of_falling_back(cuda_device):
    u, taps, d0, mlp = _inputs(4, 64, cuda_device, sizes=(1, 3, 1))
    with pytest.raises(TypeError):
        stencil.fused_updet_rhs(u.double(), taps.double(), d0.double(),
                                [(w.double(), b.double()) for w, b in mlp])
    strided = torch.stack([u, u], dim=1)[:, 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        stencil.fused_updet_rhs(strided, taps, d0, mlp)
    wide = [(torch.zeros(1, 65, device=cuda_device), torch.zeros(65, device=cuda_device)),
            (torch.zeros(65, 1, device=cuda_device), torch.zeros(1, device=cuda_device))]
    with pytest.raises(ValueError):
        stencil.fused_updet_rhs(u, taps, d0, wide)


ODD = (1, 7, 5, 1)  # no compiled kernel: the runtime-width path


@pytest.mark.parametrize("sizes", [tuple(v) for v in tfk._MLP_VARIANTS.values()] + [ODD])
@pytest.mark.parametrize("n", [1, 26, 257, 1048576])
def test_each_compiled_net_and_the_generic_path_match_plain(cuda_device, sizes, n):
    args = _inputs(5, n, cuda_device, sizes)
    before, generic = stencil.launches, stencil.generic_launches
    out = stencil.fused_updet_rhs(*args)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    assert stencil.generic_launches == generic + (sizes == ODD)
    torch.testing.assert_close(out, stencil.updet_rhs_torch(*args), **TOL)


def _tangents(seed, T, u, taps, d0, mlp):
    g = torch.Generator().manual_seed(seed)
    draw = lambda shape: torch.randn((T, *shape), generator=g).to(u.device)  # noqa: E731
    return (draw(u.shape), draw(taps.shape), draw(d0.shape),
            [(draw(w.shape), draw(b.shape)) for w, b in mlp])


@pytest.mark.parametrize("sizes", [PAPER, ODD])
def test_tangent_kernel_matches_plain_at_the_main_path_shape(cuda_device, sizes):
    # kernel B: T = 465 directions (the paper net's parameter count) at N = 26,
    # in one launch, against the plain tangent; rtol = atol = 1e-4
    u, taps, d0, mlp = _inputs(6, 26, cuda_device, sizes)
    du, dtaps, dd0, dmlp = _tangents(60, 465, u, taps, d0, mlp)
    before = stencil.tangent_launches
    out = stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, du, dtaps, dd0, dmlp)
    torch.cuda.synchronize()
    assert stencil.tangent_launches == before + 1
    ref = stencil.updet_rhs_jvp(u, taps, d0, mlp, du, dtaps, dd0, dmlp)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_jacfwd_through_the_model_rhs_matches_cpu(cuda_device):
    # the LM main path's transform on one RHS call: kernel A for the primal,
    # kernel B for all 465 directions, against the plain path on the CPU
    from universal_differential_equations_torch.flatten_util import ravel_pytree

    rhs, params = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)
    rhs_cpu, params_cpu = tfk.make_model(torch.Generator().manual_seed(0), "mlp")
    u = torch.rand(tfk.NX, generator=torch.Generator().manual_seed(2))
    flat, unravel = ravel_pytree(params)
    flat_cpu, unravel_cpu = ravel_pytree(params_cpu)
    before = (stencil.launches, stencil.tangent_launches)
    J = torch.func.jacfwd(lambda x: rhs(0.0, u.to(cuda_device), unravel(x)))(flat)
    torch.cuda.synchronize()
    assert (stencil.launches, stencil.tangent_launches) == (before[0] + 1, before[1] + 1)
    J_cpu = torch.func.jacfwd(lambda x: rhs_cpu(0.0, u, unravel_cpu(x)))(flat_cpu)
    assert J.shape == (tfk.NX, 465)
    torch.testing.assert_close(J.cpu(), J_cpu, rtol=1e-4, atol=1e-4)


def test_compiled_kernel_with_other_widths_raises(cuda_device):
    # a launch of a compiled net with widths it was not compiled for raises;
    # it does not switch to the runtime-width kernel or to PyTorch
    u, taps, d0, mlp = _inputs(7, 64, cuda_device, sizes=(1, 3, 1))
    paper = stencil._library().nets.index(PAPER)
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil._launch(u, taps, d0, mlp, (1, 3, 1), net=paper)
    du, dtaps, dd0, dmlp = _tangents(70, 2, u, taps, d0, mlp)
    with pytest.raises(RuntimeError, match="launch failed"):
        stencil._launch_tangent(u, taps, d0, mlp, (1, 3, 1), du, dtaps, dd0, dmlp, net=paper)
    with pytest.raises(ValueError):
        stencil.fused_updet_rhs_tangent(u, taps, d0, mlp, du.transpose(0, 1).contiguous()
                                        .transpose(0, 1), dtaps, dd0, dmlp)


def test_model_rhs_goes_through_the_kernel(cuda_device):
    rhs, params = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)
    rhs_cpu, params_cpu = tfk.make_model(torch.Generator().manual_seed(0), "mlp")
    u = torch.rand(tfk.NX, generator=torch.Generator().manual_seed(1))
    assert tfk._use_fused(u.to(cuda_device)) and not tfk._use_fused(u)
    before = stencil.launches
    out = rhs(0.0, u.to(cuda_device), params)
    torch.cuda.synchronize()
    assert stencil.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), rhs_cpu(0.0, u, params_cpu).numpy(), **TOL)


def test_lm_main_path_goes_through_the_kernel(cuda_device):
    ts, ys = tfk.generate_data(device=cuda_device)
    rhs, params0 = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)

    def residuals(p):
        sol = tude.solve(tude.ODEProblem(rhs, ys[0], (0.0, tfk.T_END), p), tude.Tsit5(),
                         saveat=ts, rtol=1e-4, atol=1e-6,
                         adjoint=tude.ForwardSensitivity(), max_steps=192)
        pen = torch.sqrt(tfk.zero_sum_penalty(p) + 1e-30)
        r = torch.cat([(sol.ys - ys).reshape(-1), pen[None]])
        return torch.where(sol.success, r, torch.inf)

    loss0 = float(torch.sum(residuals(params0) ** 2))
    before = stencil.launches
    res = tude.levenberg_marquardt(residuals, params0, maxiters=2)
    assert stencil.launches > before
    assert np.isfinite(float(res.loss)) and float(res.loss) <= loss0



def test_adam_gradient_of_the_case_study_goes_through_the_kernel(cuda_device, monkeypatch):
    # examples/fisher_kpp.py's ADAM warmup: the MLP loss's gradient through
    # kernel A and FusedUpdetRHS.backward equals the plain RHS's on the card
    from universal_differential_equations_torch.examples import fisher_kpp as fx
    from universal_differential_equations_torch.flatten_util import ravel_pytree

    ts, ys = tfk.generate_data(device=cuda_device)
    rhs, params0 = tfk.make_model(torch.Generator().manual_seed(0), "mlp", device=cuda_device)
    loss = fx.make_loss(tfk.make_residuals(rhs, ts, ys))
    flat, unravel = ravel_pytree(params0)

    def grad():
        x = flat.clone().requires_grad_(True)
        return torch.autograd.grad(loss(unravel(x)), x)[0]

    before = stencil.launches
    g_kernel = grad()
    assert stencil.launches > before
    monkeypatch.setattr(tfk, "_use_fused", lambda u: False)
    g_plain = grad()
    assert torch.isfinite(g_kernel).all()
    # float32 through the adaptive solve: 1e-4 of the largest entry
    assert float((g_kernel - g_plain).abs().max()) <= 1e-4 * float(g_plain.abs().max())

def _lv_grad(device, dtype, adjoint):
    """The gradient of LV scenario 1's loss for the full RBF model, at 1e-8."""
    from universal_differential_equations_torch.flatten_util import ravel_pytree
    from universal_differential_equations_torch.models import lotka_volterra as lv

    ts, _, X = lv.generate_data(torch.Generator().manual_seed(1234), dtype=dtype,
                                device=device)
    rhs, params, _ = lv.make_ude(torch.Generator().manual_seed(0), dtype=dtype,
                                 device=device)
    flat, unravel = ravel_pytree(params)
    x = flat.clone().requires_grad_(True)
    sol = tude.solve(tude.ODEProblem(rhs, X[0], (0.0, 3.0), unravel(x)), tude.Tsit5(),
                     saveat=ts, rtol=1e-8, atol=1e-8, adjoint=adjoint)
    (g,) = torch.autograd.grad(torch.mean((sol.ys - X) ** 2), x)
    return g


def test_lv_interpolating_adjoint_gradient_matches_cpu(cuda_device):
    # float64 on the card against the CPU port: relative 1e-9
    g_card = _lv_grad(cuda_device, torch.float64, tude.InterpolatingAdjoint())
    g_cpu = _lv_grad(None, torch.float64, tude.InterpolatingAdjoint())
    assert g_card.device == cuda_device
    rel = (g_card.cpu() - g_cpu).abs().max() / g_cpu.abs().max()
    assert float(rel) <= 1e-9


def test_lane_batched_bfgs_matches_single_lanes(cuda_device):
    # three independent quartic-plus-quadratic problems as lanes, float64
    g = torch.Generator().manual_seed(3)
    A = torch.tensor([[3.0, 1.0], [1.0, 2.0]], dtype=torch.float64, device=cuda_device)
    b = torch.randn(3, 2, generator=g, dtype=torch.float64).to(cuda_device)
    x0 = torch.randn(3, 2, generator=g, dtype=torch.float64).to(cuda_device)

    def lanes(X):
        return 0.5 * torch.einsum("li,ij,lj->l", X, A, X) - (b * X).sum(-1) + (X ** 4).sum(-1)

    res = tude.bfgs_minimize_lanes(lanes, x0, maxiters=50, initial_stepnorm=0.01)
    for lane in range(3):
        one = tude.bfgs_minimize(
            lambda x, lane=lane: 0.5 * x @ A @ x - b[lane] @ x + (x ** 4).sum(), x0[lane],
            maxiters=50, initial_stepnorm=0.01)
        assert int(res.iterations[lane]) == int(one.iterations)
        torch.testing.assert_close(res.params[lane], one.params, rtol=1e-10, atol=1e-10)


def test_sdeint_float32_matches_cpu(cuda_device):
    # 256 Euler-Maruyama OU paths in one vmapped call, the same increments
    from universal_differential_equations_torch.solvers import sde

    z = torch.randn((256, 300, 1), generator=torch.Generator().manual_seed(5)) * (0.01 ** 0.5)

    def paths(device):
        prob = tude.SDEProblem(f=lambda t, y, a: -1.5 * y,
                               g=lambda t, y, a: 0.4 * torch.ones_like(y),
                               u0=torch.ones(1, device=device), tspan=(0.0, 3.0))
        ts = torch.linspace(0.0, 3.0, 31, device=device)
        return torch.func.vmap(lambda w: sde.sdeint(prob, dws=w, saveat=ts).ys)(z.to(device))

    card = paths(cuda_device)
    assert card.device == cuda_device
    torch.testing.assert_close(card.cpu(), paths(torch.device("cpu")), rtol=1e-5, atol=1e-5)


def test_deep_bsde_iteration_matches_cpu(cuda_device):
    # the 100-D HJB at full width: two ADAM iterations from the same weights
    # and draws; the loss before any update to 1e-5, after one to 1e-4
    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.examples import hjb_100d

    z = torch.randn((2, 100, 20, 100), generator=torch.Generator().manual_seed(6))

    def losses(device):
        prob, alg = hjb_100d.hjb_problem(device)
        g = torch.Generator().manual_seed(0)
        params = {"u0": alg.u0_net.init(g, device=device),
                  "grad": alg.grad_net.init(g, device=device)}
        step, _ = deepbsde.make_train_step(prob, alg, prob.x0, params, 20)
        return [float(step(z[i].to(device))) for i in range(2)]

    card, cpu = losses(cuda_device), losses(torch.device("cpu"))
    assert abs(card[0] / cpu[0] - 1.0) <= 1e-5 and abs(card[1] / cpu[1] - 1.0) <= 1e-4


def test_program_spans_match_the_profiler_on_the_card(cuda_device):
    # the training loops' spans, traced with the card's activity: each
    # record within 50 us of the profiler's own event at both ends, and a
    # device-tensor count read with the record
    from torch.profiler import ProfilerActivity, profile

    from universal_differential_equations_torch import deepbsde
    from universal_differential_equations_torch.examples import hjb_100d
    from universal_differential_equations_torch.utils import profiling

    prob, alg = hjb_100d.hjb_problem(cuda_device)
    x0 = torch.tensor([[3.0, -2.0], [0.0, 4.0], [-1.0, 1.0]], device=cuda_device)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("session"):
            res = tude.bfgs_minimize_lanes(lambda x: ((x - 1.0) ** 2 * x.abs()).sum(-1), x0,
                                           maxiters=4, initial_stepnorm=0.01)
            deepbsde.solve_terminal_pde(prob, alg, trajectories=16, n_steps=5, maxiters=3,
                                        pabstol=0.0)
            torch.cuda.synchronize()
    rec = profiling.recorded()
    profiling.clear()
    trials = [n for name, _, n in rec["counts"] if name == "bfgs.lane_trials"]
    assert trials == [int((res.num_evals - 1).sum())]
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    names = {s[0] for s in rec["spans"]}
    assert {"bfgs.read", "bfgs.evaluate", "bsde.iteration", "bsde.backward"} <= names
    for name in names:
        mine = sorted((s, e) for n, s, e, _, _ in rec["spans"] if n == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert abs(s - ps) <= 50_000 and abs(e - pe) <= 50_000, (name, s - ps, e - pe)


# ---------------------------------------------------------------------------
# the LV study's lane kernel (ops/lv_lanes.py)
# ---------------------------------------------------------------------------
LANE_LOSS_GAP, LANE_GRAD_GAP = 1e-5, 8e-6  # perfbench/checks/lv_study.adam.json
# each lane on its own (``_per_lane_gaps``): the kernel against the graphed
# plain path, both float32, reads 9.7e-6 and 1.64e-5 at 500 lanes (H100)
PLAIN_LOSS_TOL, PLAIN_GRAD_TOL = 2.5e-5, 5e-5
# the kernel against JAX's float64 result (tests/data/lv_lanes_jax.npz, written
# and checked by tests/test_torch_lv_lanes.py) reads 3.0e-6 and 1.34e-6 (H100)
JAX_LOSS_TOL, JAX_GRAD_TOL = 1e-5, 5e-6


@pytest.fixture(scope="module")
def card_study():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from universal_differential_equations_torch.examples import run_loops as rl

    return rl.build_stages(device="cuda")


def _lane_gaps(prog, ref):
    """The benchmark's ``loss_gap`` (losses summed over lanes) and
    ``grad_gap`` (per leaf of every lane, ``|‖p‖ − ‖r‖|`` over the larger of
    ``‖r‖`` and the median leaf's; the worst leaf) of ``(loss, grad)``s."""
    import statistics

    from universal_differential_equations_torch.ops import lv_lanes

    (lp, gp), (lr, gr) = prog, ref
    loss_gap = abs(float(lp.double().sum() - lr.double().sum())) / abs(float(lr.double().sum()))
    n_p, n_r = ([float(t.norm()) for w, b in lv_lanes._layers(g) for t in (b, w)]
                for g in (gp, gr))
    med = statistics.median(n_r)
    return loss_gap, max(abs(p - r) / max(r, med) for p, r in zip(n_p, n_r))


def _per_lane_gaps(prog, ref):
    """The worst lane's loss gap relative to its loss, and the worst gradient
    element's gap relative to its lane's gradient norm: a lane's result in
    another lane's slot, or a transposed leaf, shows here."""
    (lp, gp), (lr, gr) = ((torch.as_tensor(x).double().cpu() for x in pair)
                          for pair in (prog, ref))
    return (float(((lp - lr).abs() / lr.abs()).max()),
            float(((gp - gr).abs().amax(1) / gr.norm(dim=1)).max()))


@pytest.mark.parametrize("lanes", [25, 500])
def test_lane_kernel_matches_the_graphed_plain_path(card_study, lanes):
    from universal_differential_equations_torch.examples import run_loops as rl

    data, theta, _ = card_study.lane_inputs(np.linspace(0, 499, lanes).astype(int), 100)

    def plain(th, d):
        with torch.enable_grad():
            x = th.detach().requires_grad_(True)
            loss = card_study.mean_loss(x, d)
            (g,) = torch.autograd.grad(loss.sum(), x)
        return loss.detach(), g

    ref = rl._Graphed(plain, theta, data)(theta, data)
    graphed = rl._Graphed(card_study.loss_and_grad, theta, data)
    prog = graphed(theta, data)
    assert graphed.ops <= 10 and graphed.lane_kernels == 1
    assert all(torch.isfinite(x).all() for x in prog)
    loss_gap, grad_gap = _lane_gaps(prog, ref)
    assert loss_gap <= LANE_LOSS_GAP and grad_gap <= LANE_GRAD_GAP, (loss_gap, grad_gap)
    loss_gap, grad_gap = _per_lane_gaps(prog, ref)
    assert loss_gap <= PLAIN_LOSS_TOL and grad_gap <= PLAIN_GRAD_TOL, (loss_gap, grad_gap)


def test_lane_kernel_matches_jax(card_study):
    """The kernel on 25 study lanes against the JAX package's float64
    ``jax.vmap(jax.value_and_grad)`` of the same lane loss, lane by lane."""
    from pathlib import Path

    with np.load(Path(__file__).resolve().parent / "data" / "lv_lanes_jax.npz") as z:
        lanes, ref = z["lanes"], (torch.from_numpy(z["loss"]), torch.from_numpy(z["grad"]))
    data, theta, _ = card_study.lane_inputs(lanes, 100)
    prog = card_study.loss_and_grad(theta, data)
    loss_gap, grad_gap = _per_lane_gaps(prog, ref)
    assert loss_gap <= JAX_LOSS_TOL and grad_gap <= JAX_GRAD_TOL, (loss_gap, grad_gap)
    loss_gap, grad_gap = _lane_gaps(tuple(x.cpu() for x in prog), ref)
    assert loss_gap <= LANE_LOSS_GAP and grad_gap <= LANE_GRAD_GAP, (loss_gap, grad_gap)


def test_lane_kernel_counts_launches_and_replays(card_study):
    from torch.profiler import ProfilerActivity, profile

    from universal_differential_equations_torch.ops import lv_lanes
    from universal_differential_equations_torch.utils import profiling

    data, theta, _ = card_study.lane_inputs(np.arange(25), 100)
    before = lv_lanes.launches
    for _ in range(3):
        card_study.loss_and_grad(theta, data)
    assert lv_lanes.launches == before + 3
    card_study.adam_stage(theta, data, steps=1)  # captures the stage's graph
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        card_study.adam_stage(theta, data, steps=4)
        torch.cuda.synchronize()
    rec = profiling.recorded()
    profiling.clear()
    replays = sum(name == "graph.replay" for name, *_ in rec["spans"])
    kernels = sum(n for name, _, n in rec["counts"] if name == "lane_loss.kernel")
    assert replays == kernels == 4
    with pytest.raises(TypeError):
        card_study.loss_and_grad(theta.double(), data.double())
    with pytest.raises(ValueError):
        card_study.loss_and_grad(theta, data.cpu())


def test_lane_kernel_gives_a_lane_the_same_result_at_any_lane_count(card_study):
    data, theta, _ = card_study.lane_inputs(np.arange(500), 100)
    pick = torch.arange(0, 500, 20, device=data.device)
    loss, grad = card_study.loss_and_grad(theta, data)
    loss_25, grad_25 = card_study.loss_and_grad(theta[pick].contiguous(), data[pick].contiguous())
    assert torch.equal(loss_25, loss[pick]) and torch.equal(grad_25, grad[pick])

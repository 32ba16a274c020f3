"""PyTorch port: SDE solvers, tree helpers and profiling against the JAX package.

The same increments go through both packages: the JAX package draws them
(``sdeint(..., return_increments=True)``, or ``jax.random.normal`` on
``AdaptiveEM``'s grid, as ``_brownian_increments`` draws them) and the port
takes them as ``dws=``.  float64; paths to 1e-12, pathwise gradients to
1e-10, ``AdaptiveEM``'s step counts exactly.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch import utils as tutils
from universal_differential_equations_torch.solvers import sde as tsde
from universal_differential_equations_torch.utils import profiling as tprof
from universal_differential_equations_tpu import utils as jutils
from universal_differential_equations_tpu.solvers import sde as jsde
from universal_differential_equations_tpu.utils import profiling as jprof

F64 = torch.float64


def _close(port, ref, rtol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=rtol, atol=rtol)


def _problems(noise):
    """The same SDE in both packages: a 2-state system with state-dependent
    noise, diagonal or general of width 3."""
    A = np.array([[-1.0, 0.4], [-0.3, -0.8]])
    B = np.array([[0.3, 0.1, -0.2], [0.05, 0.25, 0.15]])

    def pair(xp, mat):
        f = lambda t, y, a: mat(A) @ y + 0.2 * xp.sin(t) * y  # noqa: E731
        if noise == "diagonal":
            g = lambda t, y, a: 0.3 * y + 0.1  # noqa: E731
        else:
            g = lambda t, y, a: mat(B) * (1.0 + 0.5 * y[:, None])  # noqa: E731
        return f, g

    nd = None if noise == "diagonal" else 3
    jf, jg = pair(jnp, jnp.asarray)
    tf, tg = pair(torch, lambda x: torch.tensor(x, dtype=F64))
    jprob = jude.SDEProblem(f=jf, g=jg, u0=jnp.array([1.0, -0.5]), tspan=(0.0, 1.5), noise_dim=nd)
    tprob = tude.SDEProblem(f=tf, g=tg, u0=torch.tensor([1.0, -0.5], dtype=F64),
                            tspan=(0.0, 1.5), noise_dim=nd)
    return jprob, tprob


@pytest.mark.parametrize("noise", ["diagonal", "general"])
@pytest.mark.parametrize("solver", ["EulerMaruyama", "EulerHeun"])
def test_sdeint_matches_jax_on_its_increments(solver, noise):
    jprob, tprob = _problems(noise)
    saveat = np.array([0.0, 0.11, 0.5, 0.77, 1.2, 1.5])  # off-grid times snap to the grid
    jsol, dws = jsde.sdeint(jprob, getattr(jsde, solver)(), key=jax.random.PRNGKey(4),
                            n_steps=40, saveat=jnp.asarray(saveat), return_increments=True)
    tsol, used = tsde.sdeint(tprob, getattr(tsde, solver)(), dws=torch.tensor(np.asarray(dws)),
                             n_steps=40, saveat=torch.tensor(saveat), return_increments=True)
    assert torch.equal(used, torch.tensor(np.asarray(dws)))
    _close(tsol.ts, jsol.ts, 1e-15)
    _close(tsol.ys, jsol.ys, 1e-12)
    _close(tsol.y_final, jsol.y_final, 1e-12)
    assert bool(tsol.success) and int(tsol.num_steps) == int(jsol.num_steps) == 40


def _ou(xp):
    return dict(f=lambda t, y, a: -a * y, g=lambda t, y, a: 0.2 * xp.ones_like(y),
                tspan=(0.0, 1.0))


@pytest.mark.parametrize("mode", ["autograd", "torch.func"])
def test_pathwise_gradient_matches_jax_grad(mode):
    # d E[X_T] / dθ over 32 paths, on JAX's increments; autograd runs the
    # checkpointed steps, torch.func.grad(vmap(...)) the plain ones
    keys = jax.random.split(jax.random.PRNGKey(0), 32)
    jprob = jude.SDEProblem(u0=jnp.array([1.0]), args=1.0, **_ou(jnp))
    dws = jax.vmap(lambda k: jsde.sdeint(jprob, key=k, n_steps=24, return_increments=True)[1])(keys)

    def jmean(theta):
        prob = jude.SDEProblem(u0=jnp.array([1.0]), args=theta, **_ou(jnp))
        return jax.vmap(lambda k: jsde.sdeint(prob, key=k, n_steps=24).y_final[0])(keys).mean()

    g_jax = float(jax.grad(jmean)(jnp.asarray(1.0)))
    tdws = torch.tensor(np.asarray(dws))

    def tmean(theta, checkpoint=True):
        prob = tude.SDEProblem(u0=torch.tensor([1.0], dtype=F64), args=theta, **_ou(torch))
        if mode == "autograd":
            return torch.stack([tsde.sdeint(prob, dws=w, checkpoint=checkpoint).y_final[0]
                                for w in tdws]).mean()
        return torch.func.vmap(lambda w: tsde.sdeint(prob, dws=w).y_final[0])(tdws).mean()

    theta = torch.tensor(1.0, dtype=F64)
    if mode == "autograd":
        th = theta.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(tmean(th), th)
        th2 = theta.clone().requires_grad_(True)
        (g_plain,) = torch.autograd.grad(tmean(th2, checkpoint=False), th2)
        assert torch.equal(g, g_plain)  # checkpointing changes memory, never values
    else:
        g = torch.func.grad(tmean)(theta)
    assert abs(float(g) - g_jax) <= 1e-10 * abs(g_jax)


def _ou_pair():
    jprob = jude.SDEProblem(f=lambda t, y, a: -1.5 * y, g=lambda t, y, a: 0.4 * jnp.ones_like(y),
                            u0=jnp.array([1.0]), tspan=(0.0, 3.0))
    tprob = tude.SDEProblem(f=lambda t, y, a: -1.5 * y,
                            g=lambda t, y, a: 0.4 * torch.ones_like(y),
                            u0=torch.tensor([1.0], dtype=F64), tspan=(0.0, 3.0))
    return jprob, tprob


def test_adaptive_em_vmap_matches_jax_vmap():
    # tests/test_sde_deepbsde.py's settings, 64 lanes; JAX's grid increments
    jprob, tprob = _ou_pair()
    kw = dict(grid_resolution=512, abstol=1e-4, reltol=1e-3)
    keys = jax.random.split(jax.random.PRNGKey(2), 64)
    saveat = np.linspace(0.0, 3.0, 7)
    jsol = jax.vmap(lambda k: jsde.AdaptiveEM(**kw).solve(jprob, key=k,
                                                          saveat=jnp.asarray(saveat)))(keys)
    h = jnp.asarray(3.0 / 512)
    incs = torch.tensor(np.stack([np.array(jax.random.normal(k, (512, 1), jnp.float64)
                                           * jnp.sqrt(h)) for k in keys]))
    alg = tsde.AdaptiveEM(**kw)
    reads = tsde.host_reads
    tsol = torch.func.vmap(lambda w: alg.solve(tprob, dws=w, saveat=torch.tensor(saveat)))(incs)
    reads = tsde.host_reads - reads
    assert np.array_equal(tsol.num_steps.numpy(), np.asarray(jsol.num_steps))
    _close(tsol.ys, jsol.ys, 1e-12)
    _close(tsol.y_final, jsol.y_final, 1e-12)
    assert bool(tsol.success.all())
    # one host read per block of attempts, for all lanes together
    assert reads == -(-int(tsol.num_steps.max()) // tsde._BLOCK)
    # a plain loop over lanes gives each lane's vmapped solve
    for lane in (0, 17):
        one = alg.solve(tprob, dws=incs[lane], saveat=torch.tensor(saveat))
        assert int(one.num_steps) == int(tsol.num_steps[lane])
        torch.testing.assert_close(one.ys, tsol.ys[lane], rtol=1e-15, atol=1e-15)
    # the fixed grid on the same increments is pathwise close, and the
    # adaptive solve takes fewer steps (test_adaptive_em_matches_fixed)
    fixed = torch.func.vmap(lambda w: tsde.sdeint(tprob, dws=w).y_final[0])(incs)
    assert float((tsol.y_final[:, 0] - fixed).abs().mean()) < 0.02
    assert int(tsol.num_steps[0]) < 512


def test_adaptive_em_exact_zero_state_not_forward_filled():
    # tests/test_sde_deepbsde.py:194-229 on the port: dy = -dt on a binary
    # grid puts exactly 0.0 into visited slot 124; bit for bit JAX's solve
    jprob = jude.SDEProblem(f=lambda t, y, a: -jnp.ones_like(y), g=lambda t, y, a: jnp.zeros_like(y),
                            u0=jnp.array([0.96875]), tspan=(0.0, 2.0))
    tprob = tude.SDEProblem(f=lambda t, y, a: -torch.ones_like(y),
                            g=lambda t, y, a: torch.zeros_like(y),
                            u0=torch.tensor([0.96875], dtype=F64), tspan=(0.0, 2.0))
    kw = dict(grid_resolution=256, abstol=1e-6, reltol=1e-5)
    ts = [0.0, 1.5, 2.0]
    jsol = jsde.AdaptiveEM(**kw).solve(jprob, key=jax.random.PRNGKey(0), saveat=jnp.asarray(ts))
    tsol = tsde.AdaptiveEM(**kw).solve(tprob, generator=torch.Generator().manual_seed(0),
                                       saveat=torch.tensor(ts, dtype=F64))
    assert bool(tsol.success)
    assert float(tsol.ys[1, 0]) == 0.0
    assert np.array_equal(tsol.ys.numpy(), np.asarray(jsol.ys))
    assert np.array_equal(tsol.y_final.numpy(), np.asarray(jsol.y_final))
    assert int(tsol.num_steps) == int(jsol.num_steps)


def test_noise_is_given_exactly_once():
    _, tprob = _ou_pair()
    with pytest.raises(ValueError, match="exactly one"):
        tsde.sdeint(tprob, n_steps=4)
    with pytest.raises(ValueError, match="exactly one"):
        tsde.sdeint(tprob, n_steps=4, dws=torch.zeros(4, 1, dtype=F64),
                    generator=torch.Generator())
    with pytest.raises(ValueError, match="shape"):
        tsde.AdaptiveEM(grid_resolution=8).solve(tprob, dws=torch.zeros(4, 1, dtype=F64))


def test_solve_rejects_sde_problem_naming_sdeint():
    _, tprob = _ou_pair()
    with pytest.raises(TypeError, match="sdeint"):
        tude.solve(tprob)


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = {"w": rng.normal(size=(3, 2)), "b": [rng.normal(size=4), rng.normal(size=())]}
    b = {"w": rng.normal(size=(3, 2)), "b": [rng.normal(size=4), rng.normal(size=())]}
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = tude.params_from_jax(a, dtype=F64), tude.params_from_jax(b, dtype=F64)
    assert tutils.flat_dim(ta) == jutils.flat_dim(ja) == 11
    pairs = [(tutils.zeros_like_tree(ta), jutils.zeros_like_tree(ja)),
             (tutils.tree_where(torch.tensor(False), ta, tb), jutils.tree_where(False, ja, jb)),
             (tutils.tree_add(ta, tb), jutils.tree_add(ja, jb)),
             (tutils.tree_scale(2.5, ta), jutils.tree_scale(2.5, ja))]
    for t_tree, j_tree in pairs:
        t_leaves = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), t_tree))
        for x, y in zip(t_leaves, jax.tree.leaves(j_tree), strict=True):
            assert np.array_equal(x, np.asarray(y))


def test_benchmark_reports_jax_keys():
    x = torch.arange(4.0)
    out = tprof.benchmark(lambda v: v * 2.0, x, repeats=3, warmup=1)
    ref = jprof.benchmark(lambda v: v * 2.0, jnp.arange(4.0), repeats=3, warmup=1)
    assert set(out) == set(ref)
    assert 0.0 <= out["min_s"] <= out["median_s"] and out["compile_s"] >= 0.0


def test_step_timer_rates(monkeypatch):
    clock = iter([0.0, 0.1, 0.3, 0.6, 1.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timer = tprof.StepTimer(window=3)
    assert np.isnan(timer.ms_per_step) and np.isnan(timer.steps_per_sec)
    for _ in range(5):
        timer.tick()
    # the window keeps the last three intervals: 0.2, 0.3, 0.4 s
    assert timer.ms_per_step == pytest.approx(300.0)
    assert timer.steps_per_sec == pytest.approx(1.0 / 0.3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("sum" in e.key for e in prof.key_averages())

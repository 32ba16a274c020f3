"""PyTorch port: the climate column model (``models/climate_npde.py``) and
the neural-PDE case study (``examples/climate_neural_pde.py``) against the
JAX package.

``getops``, its eigenvalue, ``get_u0``, ``true_rhs`` and ``eigen_est`` equal
JAX's; ``make_neural_rhs`` with JAX's ``params0`` gives JAX's RHS; the
case study's residual vector (forward sensitivities through Tsit5, float64)
equals the JAX script's, and one Levenberg-Marquardt iteration from the same
parameters (λ₀ = 30) gives JAX's loss to 1e-8 relative.

The adjoint-cost counts (the interpolating adjoint against the discrete one
on this loss, N = 32, 518 parameters, float64): forward accepted steps,
backward accepted steps and RHS vector-Jacobian products per gradient are
counted in both packages and must be equal.  The script runs end to end on
the CPU at a tiny budget.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.adjoint import sensitivity as tsens
from universal_differential_equations_torch.convert import params_from_jax
from universal_differential_equations_torch.examples import climate_neural_pde as tx
from universal_differential_equations_torch.flatten_util import ravel_pytree as travel
from universal_differential_equations_torch.models import climate_npde as tcn
from universal_differential_equations_tpu.adjoint import sensitivity as jsens
from universal_differential_equations_tpu.models import climate_npde as jcn

torch.set_num_threads(1)

F64 = torch.float64


@pytest.mark.parametrize("dtypes", [(jnp.float64, F64), (jnp.float32, torch.float32)])
@pytest.mark.parametrize("n_grid", [16, 32])
def test_operators_bump_and_truth_rhs_equal_jax(dtypes, n_grid):
    jdt, tdt = dtypes
    D1j, D2j, eig_j = jcn.getops(n_grid, dtype=jdt)
    D1t, D2t, eig_t = tcn.getops(n_grid, dtype=tdt)
    assert eig_t == eig_j
    np.testing.assert_array_equal(D1t.numpy(), np.asarray(D1j))
    np.testing.assert_array_equal(D2t.numpy(), np.asarray(D2j))
    rtol = 1e-14 if tdt == F64 else 1e-6
    u0j, u0t = jcn.get_u0(n_grid, jdt), tcn.get_u0(n_grid, tdt)
    np.testing.assert_allclose(u0t.numpy(), np.asarray(u0j), rtol=rtol, atol=rtol)
    u = np.random.default_rng(n_grid).uniform(-1.0, 1.5, n_grid - 2)
    fj = jcn.true_rhs(0.0, jnp.asarray(u, jdt), (D1j, D2j))
    ft = tcn.true_rhs(0.0, torch.as_tensor(u, dtype=tdt), (D1t, D2t))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(fj)).max()))
    np.testing.assert_allclose(float(tcn.eigen_est(D2t)), float(jcn.eigen_est(D2j)),
                               rtol=rtol)


def test_neural_rhs_with_jax_params_equals_jax():
    D1, D2, _ = jcn.getops(32, dtype=jnp.float64)
    rhs_j, p0, _ = jcn.make_neural_rhs(jax.random.PRNGKey(0), dtype=jnp.float64)
    rhs_t, p_t, net = tcn.make_neural_rhs(torch.Generator().manual_seed(0), dtype=F64)
    assert travel(p_t)[0].numel() == jravel(p0)[0].size == 518
    pt = params_from_jax(jax.tree.map(np.asarray, p0), dtype=F64)
    ops = [torch.as_tensor(np.array(a)) for a in (D1, D2)]
    u = np.random.default_rng(0).uniform(0.0, 1.0, 30)
    fj = rhs_j(0.0, jnp.asarray(u), (p0, D1, D2))
    ft = rhs_t(0.0, torch.as_tensor(u), (pt, *ops))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=1e-10)


@pytest.fixture(scope="module")
def column():
    """The script's column in float64: JAX's truth, JAX's ``params0`` and
    the JAX residual function, with the port's copies."""
    D1, D2, eig = jcn.getops(32, dtype=jnp.float64)
    u0 = jcn.get_u0(32, jnp.float64)
    ts = jnp.linspace(0.0, 1.5, 30)
    data = jude.solve(jude.ODEProblem(jcn.true_rhs, u0, (0.0, 1.5), (D1, D2)), jude.Tsit5(),
                      saveat=ts, rtol=1e-6, atol=1e-8, adjoint=jude.NoAdjoint(),
                      max_steps=4096).ys
    rhs, p0, _ = jcn.make_neural_rhs(jax.random.PRNGKey(0), dtype=jnp.float64)

    def residuals(p):
        sol = jude.solve(jude.ODEProblem(rhs, u0, (0.0, 1.5), (p, D1, D2)), jude.Tsit5(),
                         saveat=ts, rtol=1e-4, atol=1e-6, adjoint=jude.ForwardSensitivity(),
                         max_steps=1024)
        return (sol.ys - data).ravel()

    host = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return dict(j=dict(D1=D1, D2=D2, u0=u0, ts=ts, data=data, rhs=rhs, p0=p0,
                       residuals=residuals),
                t=dict(D1=host(D1), D2=host(D2), u0=host(u0), ts=host(ts), data=host(data),
                       p0=params_from_jax(jax.tree.map(np.asarray, p0), dtype=F64)))


def test_truth_equals_jax(column):
    t = column["t"]
    ys = tx.truth(t["D1"], t["D2"], t["u0"], t["ts"])
    np.testing.assert_allclose(ys.numpy(), t["data"].numpy(), rtol=0, atol=1e-10)


def test_residuals_and_one_lm_iteration_equal_jax(column):
    j, t = column["j"], column["t"]
    rhs_t, _, _ = tcn.make_neural_rhs(torch.Generator().manual_seed(0), dtype=F64)
    residuals = tx.make_residuals(rhs_t, t["u0"], t["ts"], t["data"], t["D1"], t["D2"])
    r_t = residuals(t["p0"])
    r_j = np.asarray(j["residuals"](j["p0"]))
    np.testing.assert_allclose(r_t.numpy(), r_j, rtol=0, atol=1e-10 * np.abs(r_j).max())
    res_j = jude.levenberg_marquardt(j["residuals"], j["p0"], maxiters=1, lam0=30.0)
    res_t = tude.levenberg_marquardt(residuals, t["p0"], maxiters=1, lam0=30.0)
    assert float(res_t.loss) < float(np.sum(r_j**2))
    np.testing.assert_allclose(float(res_t.loss), float(res_j.loss), rtol=1e-8)
    np.testing.assert_allclose(travel(res_t.params)[0].numpy(), np.asarray(jravel(res_j.params)[0]),
                               rtol=0, atol=1e-8)


class _TapT(torch.autograd.Function):
    """Identity whose backward counts one RHS vector-Jacobian product."""

    count = 0

    @staticmethod
    def forward(x):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        _TapT.count += 1
        return g


def _jax_tap(counter):
    """A ``custom_vjp`` identity whose backward counts one RHS
    vector-Jacobian product (a host callback per executed backward)."""

    @jax.custom_vjp
    def tap(x):
        return x

    def fwd(x):
        return x, None

    def bwd(_, g):
        jax.debug.callback(lambda: counter.__setitem__("vjp", counter["vjp"] + 1))
        return (g,)

    tap.defvjp(fwd, bwd)
    return tap


def _record_while(module, log, host):
    """Wrap ``module.integrate_while`` so every call records its accepted
    and rejected counts (the first call of a continuous adjoint is its
    forward solve, the others its backward segments)."""
    orig = module.integrate_while

    def wrapped(*a, **kw):
        res = orig(*a, **kw)
        host(lambda n_acc, n_rej: log.append((int(n_acc), int(n_rej))), res.n_acc, res.n_rej)
        return res

    return orig, wrapped


@pytest.mark.parametrize("adjoint", ["InterpolatingAdjoint", "DiscreteAdjoint"])
def test_adjoint_cost_counts_equal_jax(column, monkeypatch, adjoint):
    """Forward accepted steps, backward accepted steps and RHS VJPs per
    gradient of the case study's adjoint loss are the JAX package's."""
    j, t = column["j"], column["t"]
    counts = {}

    # JAX: a jitted value_and_grad, the RHS tapped, integrate_while recorded
    counter = {"vjp": 0}
    tap = _jax_tap(counter)
    log_j = []
    orig, wrapped = _record_while(jsens, log_j, jax.debug.callback)
    monkeypatch.setattr(jsens, "integrate_while", wrapped)
    rhs_j = j["rhs"]

    def loss_j(p):
        sol = jude.solve(jude.ODEProblem(lambda tt, u, a: tap(rhs_j(tt, u, a)), j["u0"],
                                         (0.0, 1.5), (p, j["D1"], j["D2"])), jude.Tsit5(),
                         saveat=j["ts"], rtol=1e-4, atol=1e-6,
                         adjoint=getattr(jude, adjoint)(), max_steps=1024)
        return jnp.sum((sol.ys - j["data"]) ** 2), (sol.num_accepted, sol.num_rejected)

    (l_j, (acc_j, rej_j)), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(j["p0"])
    jax.block_until_ready(g_j)
    jax.effects_barrier()
    # JAX's _setup evaluates the RHS once more per solve, a dtype probe whose
    # value is unused (XLA drops it unless, as here, a host callback in it
    # makes it an effect); the port reuses the probe as f0.  So the backward
    # segments' probes are taken out of JAX's count: one per segment solve.
    probes = len(log_j) - 1 if adjoint == "InterpolatingAdjoint" else 0
    counts["jax"] = dict(fwd=(int(acc_j), int(rej_j)), vjp=counter["vjp"] - probes,
                         bwd=sorted(log_j[1:]) if adjoint == "InterpolatingAdjoint" else None)
    monkeypatch.setattr(jsens, "integrate_while", orig)

    # the port: the RHS tapped, integrate_while recorded
    _TapT.count = 0
    log_t = []
    orig_t, wrapped_t = _record_while(tsens, log_t, lambda fn, *xs: fn(*xs))
    monkeypatch.setattr(tsens, "integrate_while", wrapped_t)
    rhs_t, _, _ = tcn.make_neural_rhs(torch.Generator().manual_seed(0), dtype=F64)
    leaves = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in t["p0"]]
    sol = tude.solve(tude.ODEProblem(lambda tt, u, a: _TapT.apply(rhs_t(tt, u, a)), t["u0"],
                                     (0.0, 1.5), (leaves, t["D1"], t["D2"])), tude.Tsit5(),
                     saveat=t["ts"], rtol=1e-4, atol=1e-6, adjoint=getattr(tude, adjoint)(),
                     max_steps=1024)
    l_t = torch.sum((sol.ys - t["data"]) ** 2)
    fwd_vjp = _TapT.count
    g_t = torch.autograd.grad(l_t, [x for layer in leaves for x in layer.values()])
    counts["port"] = dict(fwd=(int(sol.num_accepted), int(sol.num_rejected)),
                          vjp=_TapT.count - fwd_vjp,
                          bwd=sorted(log_t[1:]) if adjoint == "InterpolatingAdjoint" else None)
    print(adjoint, counts)
    assert counts["port"] == counts["jax"], counts
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-10)
    g_ref = np.asarray(jravel(g_j)[0])
    np.testing.assert_allclose(torch.cat([g.reshape(-1) for g in g_t]).numpy(), g_ref,
                               rtol=1e-6, atol=1e-6 * np.abs(g_ref).max())


def test_main_runs_end_to_end_at_a_tiny_budget(capsys, tmp_path):
    # two ADAM steps and one LM iteration cannot reach the loss gate: main
    # prints its result and raises, naming the failed gate
    with pytest.raises(RuntimeError, match="'loss': False"):
        tx.main(device="cpu", adam_steps=2, lm_iters=1, adjoint_calls=1)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("loss", "adjoint_ms", "rock4_evals", "rock2_evals"):
        assert np.isfinite(out[key])
    assert out["gates"]["rkc1"] and out["gates"]["rock2"] and out["lm_iterations"] == 1
    # the figures, which that gate keeps main from drawing: the flux curve
    # equals the JAX script's expression at the same parameters
    _, p_j, net_j = jcn.make_neural_rhs(jax.random.PRNGKey(0))
    _, _, net_t = tcn.make_neural_rhs(torch.Generator().manual_seed(0))
    data = np.random.default_rng(1).uniform(-1.0, 1.5, (30, 30)).astype(np.float32)
    curves = tx.flux_curves(net_t, params_from_jax(jax.tree.map(np.asarray, p_j)),
                            torch.as_tensor(data))
    uu = jnp.linspace(float(data.min()), float(data.max()), 200, dtype=jnp.float32)
    phi_true = np.asarray(jnp.cos(jnp.sin(uu**3) + jnp.sin(jnp.cos(uu**2))))
    phi_net = np.asarray(jax.vmap(
        lambda v: net_j.apply(p_j, jnp.full((30,), v, jnp.float32))[15])(uu))
    for got, ref in zip(curves, (np.asarray(uu), phi_net - phi_net.mean(),
                                 phi_true - phi_true.mean())):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    tx.write_plots(curves, torch.as_tensor(data), tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["npde_flux.pdf", "npde_rollout.pdf"]

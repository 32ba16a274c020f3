"""PyTorch port: ``torch.func.vmap`` over adaptive solves against ``jax.vmap`` (float64).

Three Lotka-Volterra lanes that differ in the initial state and the
parameters, built in numpy, go through ``jax.vmap`` of the JAX package's
``solve`` and ``torch.func.vmap`` of the port's, with every adjoint.  Each
lane takes exactly the steps of its solo solve (accepted, rejected, RHS
evaluations) and gives its values bit for bit; against JAX the saved states
agree to 1e-9 relative at rtol = atol = 1e-8 and the accepted and rejected
counts exactly.  Lanes may differ in span, direction, save grid and initial
step.  A functorch batching-rule fallback anywhere in the stepping loop
fails the test.  Gradients under ``vmap`` are in ``test_torch_lanes_grad.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.models import lotka_volterra as tlv
from universal_differential_equations_tpu.models import lotka_volterra as jlv

torch.set_num_threads(1)

# a batching-rule fallback (functorch's "performance drop" warning) is an error
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64
TOL = 1e-8
ADJOINTS = ["NoAdjoint", "DiscreteAdjoint", "ForwardSensitivity", "InterpolatingAdjoint",
            "BacksolveAdjoint", "QuadratureAdjoint"]
U0S = np.array([[0.44249296, 4.6280594], [1.0, 2.0], [2.5, 0.8]])
PS = np.array([[1.3, 0.9, 0.8, 1.8], [1.5, 1.0, 0.6, 1.2], [1.1, 0.7, 0.9, 2.0]])
TS = np.linspace(0.0, 3.0, 7)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _t_solve(u0, p, adjoint, t0=0.0, t1=3.0, ts=None, **kw):
    ts = torch.tensor(TS) if ts is None else ts
    return tude.solve(tude.ODEProblem(tlv.lotka_rhs, u0, (t0, t1), p), tude.Tsit5(),
                      saveat=ts, rtol=TOL, atol=TOL, adjoint=adjoint, **kw)


def _j_solve(u0, p, adjoint, t0=0.0, t1=3.0, ts=None):
    ts = jnp.asarray(TS) if ts is None else ts
    return jude.solve(jude.ODEProblem(jlv.lotka_rhs, u0, (t0, t1), p), jude.Tsit5(),
                      saveat=ts, rtol=TOL, atol=TOL, adjoint=adjoint)


def _counts(sol):
    return (np.asarray(sol.num_accepted), np.asarray(sol.num_rejected),
            np.asarray(sol.num_rhs_evals))


@pytest.mark.parametrize("name", ADJOINTS)
def test_vmapped_solve_matches_solo_and_jax_vmap(name):
    adj = getattr(tude, name)()

    def lane(u0, p):
        sol = _t_solve(u0, p, adj, dense=True)
        return (sol.ys, sol.y_final, sol.success, sol.num_accepted, sol.num_rejected,
                sol.num_rhs_evals, sol.dense.ts, sol.dense.num_points)

    ys, y_fin, ok, n_acc, n_rej, nfe, dts, npts = torch.func.vmap(lane)(
        torch.tensor(U0S), torch.tensor(PS))
    assert bool(ok.all())
    for i in range(3):
        solo = _t_solve(torch.tensor(U0S[i]), torch.tensor(PS[i]), adj, dense=True)
        assert (int(n_acc[i]), int(n_rej[i]), int(nfe[i])) == tuple(
            int(c) for c in _counts(solo))
        # lanes of different lengths: the finished ones took no extra step
        assert torch.equal(ys[i], solo.ys) and torch.equal(y_fin[i], solo.y_final)
        n = int(npts[i])
        assert n == int(solo.num_accepted) + 1
        assert torch.equal(dts[i, :n], solo.dense.ts[:n])
    assert len(set(n_acc.tolist())) == 3  # the lanes really differ in length

    jadj = getattr(jude, name)()
    jsol = jax.vmap(lambda u0, p: _j_solve(u0, p, jadj))(jnp.asarray(U0S), jnp.asarray(PS))
    assert _rel(ys.numpy(), jsol.ys) <= 1e-9
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jsol.num_accepted))
    np.testing.assert_array_equal(n_rej.numpy(), np.asarray(jsol.num_rejected))


SPANS = np.array([[0.0, 3.0], [2.0, 0.0], [0.5, 1.5]])  # forward, backward, short


@pytest.mark.parametrize("name", ["NoAdjoint", "DiscreteAdjoint", "InterpolatingAdjoint"])
def test_lanes_with_different_tspans_and_directions(name):
    # per-lane tspan, direction and save grid (7 points across each lane's span)
    frac = np.linspace(0.0, 1.0, 7)
    grids = SPANS[:, :1] + (SPANS[:, 1:] - SPANS[:, :1]) * frac
    adj = getattr(tude, name)()

    def lane(u0, span, ts):
        sol = _t_solve(u0, torch.tensor(PS[0]), adj, span[0], span[1], ts)
        return sol.ys, sol.num_accepted, sol.t_final

    ys, n_acc, t_fin = torch.func.vmap(lane)(torch.tensor(U0S), torch.tensor(SPANS),
                                             torch.tensor(grids))
    np.testing.assert_array_equal(t_fin.numpy(), SPANS[:, 1])
    for i in range(3):
        solo = _t_solve(torch.tensor(U0S[i]), torch.tensor(PS[0]), adj, SPANS[i, 0],
                        SPANS[i, 1], torch.tensor(grids[i]))
        assert int(n_acc[i]) == int(solo.num_accepted)
        assert torch.equal(ys[i], solo.ys)
    jadj = getattr(jude, name)()
    jsol = jax.vmap(lambda u0, span, ts: _j_solve(u0, jnp.asarray(PS[0]), jadj, span[0],
                                                  span[1], ts))(
        jnp.asarray(U0S), jnp.asarray(SPANS), jnp.asarray(grids))
    assert _rel(ys.numpy(), jsol.ys) <= 1e-9
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jsol.num_accepted))


def test_per_lane_initial_step_dense_output_and_zero_length_span():
    # a batched dt0, sol(t)/sol(t, nu=1) at per-lane times, and a lane whose
    # span has zero length (done before its first attempt)
    dt0s = torch.tensor([1e-3, 1e-2, 5e-2], dtype=F64)
    t1s = torch.tensor([3.0, 0.0, 2.0], dtype=F64)
    tq = torch.tensor([1.3, 0.0, 0.7], dtype=F64)

    def lane(u0, dt0, t1, t):
        ts = torch.stack([torch.zeros_like(t1), t1])
        sol = _t_solve(u0, torch.tensor(PS[0]), tude.NoAdjoint(), 0.0, t1, ts, dt0=dt0,
                       dense=True)
        return sol.ys, sol(t), sol(t, nu=1), sol.num_accepted, sol.num_rhs_evals

    out = torch.func.vmap(lane)(torch.tensor(U0S), dt0s, t1s, tq)
    assert int(out[3][1]) == 0
    for i in range(3):
        solo = lane(torch.tensor(U0S[i]), dt0s[i], t1s[i], tq[i])
        for a, b in zip(out, solo):
            assert torch.equal(a[i], b)

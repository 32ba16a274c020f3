"""PyTorch port: ``vmap`` of ``grad`` through adaptive solves against JAX (float64).

The Lotka-Volterra lanes of ``test_torch_lanes.py`` (initial states and
parameters built in numpy): ``torch.func.vmap(torch.func.grad(loss))`` for
every differentiable adjoint agrees with ``jax.vmap(jax.grad(loss))`` to
1e-7 relative and with the port's solo gradient to 1e-12.  Under the
continuous adjoints a lane whose forward solve fails gets a NaN gradient and
the others keep theirs.  A functorch batching-rule fallback fails the test.
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

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64
TOL = 1e-8
ADJOINTS = ["DiscreteAdjoint", "ForwardSensitivity", "InterpolatingAdjoint",
            "BacksolveAdjoint", "QuadratureAdjoint"]
U0S = np.array([[0.44249296, 4.6280594], [1.0, 2.0], [2.5, 0.8]])
PS = np.array([[1.3, 0.9, 0.8, 1.8], [1.5, 1.0, 0.6, 1.2], [1.1, 0.7, 0.9, 2.0]])
TS = np.linspace(0.0, 3.0, 7)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b))))


def _t_loss(adj):
    def loss(p, u0):
        sol = tude.solve(tude.ODEProblem(tlv.lotka_rhs, u0, (0.0, 3.0), p), tude.Tsit5(),
                         saveat=torch.tensor(TS), rtol=TOL, atol=TOL, adjoint=adj)
        return torch.sum(sol.ys**2) + torch.sum(sol.y_final)
    return loss


def _j_loss(adj):
    def loss(p, u0):
        sol = jude.solve(jude.ODEProblem(jlv.lotka_rhs, u0, (0.0, 3.0), p), jude.Tsit5(),
                         saveat=jnp.asarray(TS), rtol=TOL, atol=TOL, adjoint=adj)
        return jnp.sum(sol.ys**2) + jnp.sum(sol.y_final)
    return loss


@pytest.mark.parametrize("name", ADJOINTS)
def test_vmap_of_grad_matches_jax(name):
    # per-lane gradients with respect to the parameters and the initial state
    g_t = torch.func.vmap(torch.func.grad(_t_loss(getattr(tude, name)()), argnums=(0, 1)))(
        torch.tensor(PS), torch.tensor(U0S))
    g_j = jax.jit(jax.vmap(jax.grad(_j_loss(getattr(jude, name)()), argnums=(0, 1))))(
        jnp.asarray(PS), jnp.asarray(U0S))
    for a, b in zip(g_t, g_j):
        assert np.all(np.isfinite(a.numpy()))
        assert _rel(a.numpy(), b) <= 1e-7
    # and the longest lane against its solo gradient
    for i in (0,):
        solo = torch.func.grad(_t_loss(getattr(tude, name)()), argnums=(0, 1))(
            torch.tensor(PS[i]), torch.tensor(U0S[i]))
        for a, b in zip(g_t, solo):
            assert _rel(a[i].numpy(), b.numpy()) <= 1e-12



@pytest.mark.parametrize("name", ["InterpolatingAdjoint", "QuadratureAdjoint",
                                  "BacksolveAdjoint"])
def test_failed_lane_poisons_only_its_own_gradient(name):
    # du = p·u² blows up at t = 1/p: the lane with p = 2 fails before t1 = 1,
    # its gradient is NaN; the lane with p = 0.5 equals its solo gradient
    def loss(p):
        sol = tude.solve(tude.ODEProblem(lambda t, y, q: q * y * y, torch.ones(1, dtype=F64),
                                         (0.0, 1.0), p), tude.Tsit5(),
                         saveat=torch.linspace(0.0, 1.0, 5, dtype=F64), rtol=1e-6,
                         atol=1e-8, adjoint=getattr(tude, name)(), max_steps=256)
        return sol.ys[-1].sum()

    g = torch.func.vmap(torch.func.grad(loss))(torch.tensor([2.0, 0.5], dtype=F64))
    assert bool(torch.isnan(g[0])) and bool(torch.isfinite(g[1]))
    assert _rel(g[1].numpy(), torch.func.grad(loss)(torch.tensor(0.5, dtype=F64)).numpy()) \
        <= 1e-12

"""PyTorch port: the deep-BSDE trainer and the HJB Monte-Carlo value against the JAX package.

The port's ``solve_terminal_pde`` takes the JAX trainer's initial parameters
(``convert.params_from_jax`` of ``u0_net.init(k1)`` / ``grad_net.init(k2)``
with ``k1, k2 = split(split(key)[0])``) and its draws through ``normals``:
each iteration's ``normal(fold_in(fold_in(k_train, stage), it))`` and the
pilot's ``normal`` per ``split(fold_in(k_init, 99), pilot_paths)`` key, as
``deepbsde/solver.py:122-127``, ``:171-172``, ``:190`` and ``:277`` draw
them.  float64: losses and ``u0`` to 1e-9 relative, the adaptive grid
exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
from universal_differential_equations_torch import deepbsde as tb
from universal_differential_equations_tpu import deepbsde as jb
from universal_differential_equations_tpu.nn import MLP as JMLP

F64 = torch.float64
D = 3
S = np.random.default_rng(0).normal(size=(D, D)) * 0.3 + np.eye(D)


def _sigma(xp, kind):
    if kind == "scalar":
        return lambda t, x: math.sqrt(2.0)
    if kind == "vector":
        return lambda t, x: math.sqrt(2.0) * (1.0 + 0.1 * x * x)
    mat = jnp.asarray(S) if xp is jnp else torch.tensor(S, dtype=F64)
    return lambda t, x: mat


def _problem(xp, module, kind, x0):
    return module.TerminalPDEProblem(
        g=lambda x: xp.log(0.5 + 0.5 * xp.sum(x * x)),
        f=lambda t, x, u, z: -xp.sum(z * z) + 0.1 * u,
        mu=lambda t, x: 0.1 * xp.sin(x),
        sigma=_sigma(xp, kind), x0=x0, tspan=(0.0, 1.0))


def _nets(hls=8):
    return (jb.NNPDENS(JMLP([D, hls, 1], activation="relu"),
                       JMLP([D + 1, hls, D], activation="relu")),
            tb.NNPDENS(tude.MLP([D, hls, 1], activation="relu"),
                       tude.MLP([D + 1, hls, D], activation="relu")))


def _jax_seam(jalg, key):
    """The JAX trainer's initial parameters (as the port's tree) and its
    draws, as a ``normals`` callable."""
    k_init, k_train = jax.random.split(key)
    k1, k2 = jax.random.split(k_init)
    p0 = {"u0": jalg.u0_net.init(k1, jnp.float64), "grad": jalg.grad_net.init(k2, jnp.float64)}

    def normals(stage, it, shape):
        if stage == "pilot":
            keys = jax.random.split(jax.random.fold_in(k_init, 99), shape[0])
            return np.stack([np.array(jax.random.normal(k, shape[1:], jnp.float64))
                             for k in keys])
        k = jax.random.fold_in(jax.random.fold_in(k_train, stage), it)
        return np.array(jax.random.normal(k, shape, jnp.float64))

    return tude.params_from_jax(jax.tree.map(np.asarray, p0), dtype=F64), normals


def _compare(kind, **kw):
    jalg, talg = _nets()
    key = jax.random.PRNGKey(3)
    kw = {**dict(trajectories=16, n_steps=8, maxiters=5, learning_rate=0.03, pabstol=0.0), **kw}
    jres = jb.solve_terminal_pde(_problem(jnp, jb, kind, jnp.full(D, 0.2)), jalg, key,
                                 dtype=jnp.float64, **kw)
    params, normals = _jax_seam(jalg, key)
    tres = tb.solve_terminal_pde(_problem(torch, tb, kind, torch.full((D,), 0.2, dtype=F64)),
                                 talg, params=params, normals=normals, dtype=F64, **kw)
    np.testing.assert_allclose(tres.losses.numpy(), np.asarray(jres.losses), rtol=1e-9)
    assert abs(float(tres.u0) / float(jres.u0) - 1.0) <= 1e-9
    assert tres.n_steps == jres.n_steps
    return tres


@pytest.mark.parametrize("kind", ["scalar", "vector", "matrix"])
def test_solve_terminal_pde_matches_jax(kind):
    res = _compare(kind)
    assert len(res.losses) == 5 and not res.converged and res.s_per_iter > 0.0


def test_adaptive_pilot_and_refinement_match_jax():
    # the AdaptiveEM pilot over 2 coupled (X, u) lanes picks JAX's grid, and
    # one refinement doubles it with warm-started networks
    res = _compare("scalar", maxiters=3, adaptive=True, sde_abstol=5e-2, sde_reltol=5e-2,
                   pilot_paths=2, max_refinements=1)
    assert res.n_steps >= 16 and len(res.losses) == 6


def _hjb_g(xp):
    return lambda x: xp.log(0.5 + 0.5 * xp.sum(x * x))


def test_mc_analytical_hjb_matches_jax():
    d, n, batch = 4, 3000, 1000
    key = jax.random.PRNGKey(7)
    x0 = np.linspace(-0.3, 0.3, d)
    ref = float(jb.mc_analytical_hjb(_hjb_g(jnp), jnp.asarray(x0), 1.0, 1.0, key,
                                     n_samples=n, batch=batch))
    w = np.stack([np.array(jax.random.normal(k, (batch, d), jnp.float64))
                  for k in jax.random.split(key, n // batch)])
    same = tb.mc_analytical_hjb(_hjb_g(torch), torch.tensor(x0), 1.0, 1.0, n_samples=n,
                                batch=batch, normals=w)
    assert abs(same / ref - 1.0) <= 1e-12
    own = tb.mc_analytical_hjb(_hjb_g(torch), torch.tensor(x0), 1.0, 1.0,
                               torch.Generator().manual_seed(7), n_samples=10**5)
    big = float(jb.mc_analytical_hjb(_hjb_g(jnp), jnp.asarray(x0), 1.0, 1.0, key))
    assert abs(own - big) <= 1e-2


def test_deep_bsde_hjb_small_trains_with_the_port_generator():
    # test_sde_deepbsde.py::test_deep_bsde_hjb_small's problem on the port's
    # own draws, with 300 of its 800 iterations: u(0, 0) starts at 0 (zero
    # biases) and the analytic value is 1.10
    d, hls = 4, 16
    x0 = torch.zeros(d, dtype=torch.float32)
    prob = tb.TerminalPDEProblem(g=_hjb_g(torch), f=lambda t, x, u, z: -torch.sum(z * z),
                                 mu=lambda t, x: torch.zeros_like(x),
                                 sigma=lambda t, x: math.sqrt(2.0), x0=x0, tspan=(0.0, 1.0))
    alg = tb.NNPDENS(tude.MLP([d, hls, hls, 1], activation="relu"),
                     tude.MLP([d + 1, hls, hls, d], activation="relu"))
    res = tb.solve_terminal_pde(prob, alg, torch.Generator().manual_seed(0), trajectories=64,
                                n_steps=20, maxiters=300, learning_rate=0.03, pabstol=1e-3)
    analytical = tb.mc_analytical_hjb(_hjb_g(torch), x0, 1.0, 1.0,
                                      torch.Generator().manual_seed(7))
    rel = abs(float(res.u0) - analytical) / abs(float(res.u0))
    assert rel < 0.2, (float(res.u0), analytical)
    assert res.u0.dtype == torch.float32 and res.params["u0"][0]["w"].dtype == torch.float32


def test_mesh_raises_naming_slice_h():
    # the mesh is ported (several ranks: tests/test_torch_parallel.py): on a
    # one-rank gloo mesh the trainer equals the unsharded run
    from universal_differential_equations_torch.parallel import ensemble_mesh

    _, talg = _nets()
    prob = _problem(torch, tb, "scalar", torch.zeros(D, dtype=F64))
    kw = dict(trajectories=8, n_steps=4, maxiters=3, pabstol=0.0, dtype=F64)
    ref = tb.solve_terminal_pde(prob, talg, torch.Generator().manual_seed(1), **kw)
    mesh = ensemble_mesh(device="cpu")
    try:
        got = tb.solve_terminal_pde(prob, talg, torch.Generator().manual_seed(1), mesh=mesh,
                                    **kw)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(got.losses.numpy(), ref.losses.numpy(), rtol=1e-12)
    assert float(got.u0) == pytest.approx(float(ref.u0), rel=1e-12)

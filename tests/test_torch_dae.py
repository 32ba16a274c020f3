"""PyTorch port: the BDF DAE solver (``solvers/bdf.py``) and ``solve``'s DAE
dispatch against the JAX package.

The same float64 problems (those of ``tests/test_stiff_dae.py`` and
``tests/test_api_contracts.py``) go through both packages: the BDF and
Lagrange weights agree to 1e-13, consistent initialization to 1e-12, and
every ``daeint`` solve takes JAX's accepted and rejected counts (so its RHS
count, 8 per attempt) and its ``success`` flag, with ``ys`` to 1e-9
relative; dense output agrees to 1e-9.  A float32 problem under
``x64_host="auto"`` equals the float64 solve of the same inputs cast to
float32, on the input's device; ``"never"`` stays in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from universal_differential_equations_torch.solvers import bdf as tbdf
from universal_differential_equations_tpu.solvers import bdf as jbdf

torch.set_num_threads(1)
# a batching-rule fallback (functorch's "performance drop" warning) is an error
pytestmark = pytest.mark.filterwarnings("error:There is a performance drop:UserWarning")

F64 = torch.float64
ROBER_1E4 = np.array([1.07300429e-01, 4.80016698e-07, 8.92699091e-01])
POLY = [0.3, -0.2, 0.05, 0.01, -0.002, 0.0004]


def _rober_dae(pk):
    def F(t, u, du, a):
        y1, y2, y3 = u[0], u[1], u[2]
        return pk([
            du[0] + 0.04 * y1 - 1e4 * y2 * y3,
            du[1] - 0.04 * y1 + 1e4 * y2 * y3 + 3e7 * y2 ** 2,
            y1 + y2 + y3 - 1.0,
        ])
    return F


def _index1(pk):
    # u0' = -u0 with the algebraic constraint u0 + u1 = 1
    return lambda t, u, du, a: pk([du[0] + u[0], u[0] + u[1] - 1.0])


def _poly(t):
    return sum(c * t ** i for i, c in enumerate(POLY))


def _dpoly(t):
    return sum(i * c * t ** (i - 1) for i, c in enumerate(POLY) if i)


# name -> (residual factory, u0, du0, tspan, differential_vars, daeint kwargs, saveat)
CASES = {
    "decay": (lambda pk: (lambda t, u, du, a: du + u), [1.0], [-1.0], (0.0, 2.0), None,
              dict(rtol=1e-8, atol=1e-10), None),
    "robertson_constraint": (_rober_dae, [1.0, 0.0, 0.0], [-0.04, 0.04, 0.0], (0.0, 1e4),
                             [True, True, False], dict(rtol=1e-7, atol=1e-10, max_steps=8192),
                             np.linspace(0.0, 1e4, 9)),
    "consistent_init": (_rober_dae, [1.0, 0.0, 0.7], [0.0, 0.0, 0.0], (0.0, 1.0),
                        [True, True, False], dict(rtol=1e-7, atol=1e-10), np.linspace(0, 1, 6)),
    "variable_order_2": (_rober_dae, [1.0, 0.0, 0.0], [-0.04, 0.04, 0.0], (0.0, 1e4),
                         [True, True, False],
                         dict(rtol=1e-7, atol=1e-10, max_steps=16384, max_order=2), None),
    "polynomial": (lambda pk: (lambda t, u, du, a: du - pk([_dpoly(t)])), [_poly(0.0)],
                   [_dpoly(0.0)], (0.0, 10.0), None, dict(rtol=1e-9, atol=1e-12),
                   np.linspace(0.0, 10.0, 7)),
    # no mask: the consistent initialization is singular and every attempt
    # is NaN, so the solve fails at its budget (512 attempts here)
    "unmasked_index1": (_index1, [1.0, 0.0], [-1.0, 0.0], (0.0, 1.0), None,
                        dict(max_steps=512), np.linspace(0.0, 1.0, 5)),
    "masked_index1": (_index1, [1.0, 0.0], [-1.0, 0.0], (0.0, 1.0), [True, False],
                      dict(rtol=1e-6, atol=1e-8), np.linspace(0.0, 1.0, 5)),
}


def _problems(case):
    make, u0, du0, tspan, dv, kw, saveat = CASES[case]
    pj = jude.DAEProblem(make(jnp.stack), jnp.asarray(u0), jnp.asarray(du0), tspan,
                         differential_vars=None if dv is None else jnp.asarray(dv))
    pt = tude.DAEProblem(make(torch.stack), torch.tensor(u0, dtype=F64),
                         torch.tensor(du0, dtype=F64), tspan,
                         differential_vars=None if dv is None else torch.tensor(dv))
    return pj, pt, kw, saveat


@functools.lru_cache(maxsize=None)
def _port_solve(case):
    """The port's solve of ``case`` (shared by the tests that read it)."""
    _, pt, kw, saveat = _problems(case)
    return tude.daeint(pt, saveat=None if saveat is None else torch.tensor(saveat), **kw)


def _counts(sol):
    return (bool(sol.success), int(sol.num_accepted), int(sol.num_rejected),
            int(sol.num_rhs_evals))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-300))


def test_bdf_and_lagrange_weights_equal_jax():
    rng = np.random.default_rng(5)
    for n in range(2, 8):
        nodes = np.sort(rng.uniform(0.0, 3.0, n))[::-1].copy()
        x = nodes[0] + rng.uniform(0.01, 0.5)
        want = np.asarray(jbdf._bdf_weights(jnp.asarray(nodes)))
        got = tbdf._bdf_weights(torch.tensor(nodes)).numpy()
        assert _rel(got, want) < 1e-13
        want = np.asarray(jbdf._lagrange_eval_weights(jnp.asarray(nodes), jnp.asarray(x)))
        got = tbdf._lagrange_eval_weights(torch.tensor(nodes), torch.tensor(x, dtype=F64))
        assert _rel(got.numpy(), want) < 1e-13
    # the per-order rows the stepper reads: row q-1 is the weights over the
    # first q+1 nodes, zero past them
    nodes = np.sort(rng.uniform(0.0, 3.0, 6))[::-1].copy()
    q = torch.arange(1, 6)
    keep = torch.arange(6)[None, :] <= q[:, None]
    rows = tbdf._bdf_rows(torch.tensor(nodes), keep).numpy()
    preds = tbdf._lagrange_rows(torch.tensor(nodes), torch.tensor(3.5, dtype=F64), keep).numpy()
    for i in range(5):
        want = np.asarray(jbdf._bdf_weights(jnp.asarray(nodes[:i + 2])))
        assert _rel(rows[i, :i + 2], want) < 1e-13 and not rows[i, i + 2:].any()
        want = np.asarray(jbdf._lagrange_eval_weights(jnp.asarray(nodes[:i + 2]), 3.5))
        assert _rel(preds[i, :i + 2], want) < 1e-13 and not preds[i, i + 2:].any()


def test_initialize_dae_equals_jax():
    pj, pt, _, _ = _problems("consistent_init")
    uj, duj, rj = jude.initialize_dae(pj)
    ut, dut, rt = tude.initialize_dae(pt)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dut.numpy(), np.asarray(duj), rtol=0, atol=1e-12)
    assert float(rt) < 1e-10 and float(rj) < 1e-10
    np.testing.assert_allclose(ut.numpy(), [1.0, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(dut.numpy()[:2], [-0.04, 0.04], atol=1e-10)


@pytest.mark.parametrize("case", list(CASES))
def test_daeint_equals_jax(case):
    pj, _, kw, saveat = _problems(case)
    sj = jude.daeint(pj, saveat=None if saveat is None else jnp.asarray(saveat), **kw)
    st = _port_solve(case)
    assert _counts(st) == _counts(sj)
    if not bool(sj.success):  # the unmasked index-1 system fails cleanly in both
        assert case == "unmasked_index1"
        return
    assert _rel(st.ys.numpy(), sj.ys) < 1e-9
    assert _rel(st.y_final.numpy(), sj.y_final) < 1e-9
    if case in ("robertson_constraint", "variable_order_2"):
        np.testing.assert_allclose(st.y_final.numpy(), ROBER_1E4, rtol=1e-3)
    if case == "polynomial":  # the order ramp then near-free stepping
        assert int(st.num_accepted) < 120 and abs(float(st.y_final[0]) - _poly(10.0)) < 1e-7
    if case == "masked_index1":
        np.testing.assert_allclose(st.ys.numpy()[:, 0], np.exp(-saveat), atol=1e-4)


def test_variable_order_pays_off():
    # tests/test_stiff_dae.py::test_dae_variable_order_pays_off on the port:
    # BDF(1-5) against its order-2 subset, both cases above
    sol5, sol2 = _port_solve("robertson_constraint"), _port_solve("variable_order_2")
    assert bool(sol5.success) and bool(sol2.success)
    assert int(sol5.num_accepted) < 0.5 * int(sol2.num_accepted)
    np.testing.assert_allclose(sol5.y_final.numpy(), ROBER_1E4, rtol=1e-4)


def test_dense_output_equals_jax():
    pj, pt, _, _ = _problems("robertson_constraint")
    kw = dict(rtol=1e-7, atol=1e-10, max_steps=8192, dense=True)
    sj, st = jude.daeint(pj, **kw), tude.daeint(pt, **kw)
    ts = np.array([0.003, 0.4, 7.7, 123.0, 2500.0, 9999.0])
    for nu in (0, 1):
        want = np.stack([np.asarray(sj(jnp.asarray(t), nu)) for t in ts])
        assert _rel(st(torch.tensor(ts), nu).numpy(), want) < 1e-9


def test_solve_dispatches_dae_to_daeint_with_solves_defaults():
    _, pt, _, saveat = _problems("masked_index1")
    ts = torch.tensor(saveat)
    via_solve = tude.solve(pt, saveat=ts, dense=True)
    direct = tude.daeint(pt, saveat=ts, rtol=1e-3, atol=1e-6, max_steps=4096, dense=True)
    assert _counts(via_solve) == _counts(direct)
    assert torch.equal(via_solve.ys, direct.ys)
    assert torch.equal(via_solve(torch.tensor(0.37, dtype=F64)), direct(torch.tensor(0.37, dtype=F64)))


def test_x64_host_auto_solves_float32_in_float64_on_the_inputs_device():
    _, pt, kw, saveat = _problems("robertson_constraint")
    p32 = tude.remake(pt, u0=pt.u0.float(), du0=pt.du0.float())
    ts32 = torch.tensor(saveat, dtype=torch.float32)
    s32 = tude.daeint(p32, saveat=ts32, dense=True, **kw)
    s64 = tude.daeint(tude.remake(pt, u0=p32.u0.double(), du0=p32.du0.double()),
                      saveat=ts32.double(), dense=True, **kw)
    assert s32.ys.dtype == torch.float32 and s32.ys.device == p32.u0.device
    assert s32.dense.ts.dtype == torch.float32 and s32.dense.ts.device == p32.u0.device
    assert _counts(s32) == _counts(s64)
    assert torch.equal(s32.ys, s64.ys.float())
    assert torch.equal(s32.y_final, s64.y_final.float())
    never = tude.daeint(p32, saveat=ts32, x64_host="never", rtol=1e-4, atol=1e-6)
    assert never.ys.dtype == torch.float32 and never.dense is None
    auto = tude.daeint(p32, saveat=ts32, rtol=1e-4, atol=1e-6)
    assert not torch.equal(never.ys, auto.ys)  # float32 Newton rounds differently


def test_daeint_vmaps_over_lanes_like_solo_solves():
    # jax.vmap of daeint runs each lane to its own end; the port's lanes
    # share the host loop and a finished lane passes through
    def run(k, pk_tensor):
        pt = tude.DAEProblem(lambda t, u, du, a: torch.stack([du[0] + a * u[0],
                                                               u[0] + u[1] - 1.0]),
                             torch.tensor([1.0, 0.0], dtype=F64),
                             torch.stack([-k, k]), (0.0, 1.0),
                             differential_vars=torch.tensor([True, False]), args=k)
        sol = tude.daeint(pt, saveat=torch.linspace(0.0, 1.0, 5, dtype=F64), rtol=1e-6,
                          atol=1e-8)
        return sol.ys, sol.num_accepted, sol.num_rejected
    ks = torch.tensor([0.5, 2.0, 8.0], dtype=F64)
    ys, na, nr = torch.func.vmap(lambda k: run(k, None))(ks)
    for i, k in enumerate(ks):
        y1, a1, r1 = run(k, None)
        assert (int(na[i]), int(nr[i])) == (int(a1), int(r1))
        assert _rel(ys[i].numpy(), y1.numpy()) < 1e-12
    assert len(set(na.tolist())) > 1  # the lanes finish at different attempts


def test_singular_newton_matrix_rejects_the_attempt_like_jax():
    # u' = 2u with dt0 = 0.5: the first BDF-1 iteration matrix is
    # ∂F/∂u + ∂F/∂u'/dt = -2 + 2 = 0 exactly.  JAX's LU solves to inf/NaN,
    # newton_ok rejects the attempt and the step shrinks; a raising
    # factorization would throw
    kw = dict(rtol=1e-8, atol=1e-10, dt0=0.5)
    sj = jude.daeint(jude.DAEProblem(lambda t, u, du, a: du - 2.0 * u, jnp.ones(1),
                                     2.0 * jnp.ones(1), (0.0, 1.0)), **kw)
    st = tude.daeint(tude.DAEProblem(lambda t, u, du, a: du - 2.0 * u, torch.ones(1, dtype=F64),
                                     2.0 * torch.ones(1, dtype=F64), (0.0, 1.0)), **kw)
    assert _counts(st) == _counts(sj) and bool(st.success)
    assert int(st.num_rejected) >= 1
    assert _rel(st.y_final.numpy(), sj.y_final) < 1e-9
    assert abs(float(st.y_final[0]) - np.exp(2.0)) < 1e-5

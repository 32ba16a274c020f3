"""PyTorch port: the fused reaction+stencil RHS against the JAX package.

The same numpy inputs go through ``updet_rhs_xla`` / the Pallas kernels (in
interpret mode) and through the port's ``updet_rhs_torch``, the wrapper
``fused_updet_rhs`` (which takes the plain version for CPU tensors) and the
``FusedUpdetRHS`` autograd function.  Tolerances: 2e-5 in float32, the
bound of ``tests/test_ops_misc.py``.  The CUDA kernel's own tests are in
``tests/test_torch_cuda.py``, which imports no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_differential_equations_torch.ops import stencil as tst
from universal_differential_equations_tpu.ops import (
    fused_updet_rhs as jax_fused,
    fused_updet_rhs_gridded as jax_gridded,
    updet_rhs_xla,
)

torch.set_num_threads(1)

PAPER = (1, 10, 20, 10, 1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, n, sizes=PAPER, rows=None, dtype=np.float32):
    """u, taps, d0 and [(w (h_in, h_out), b)] from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    shape = (n,) if rows is None else (rows, n)
    u = rng.uniform(size=shape).astype(dtype)
    taps = np.array([6.25, -12.5, 6.25], dtype)
    d0 = np.asarray(0.7, dtype)
    mlp = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        lim = np.sqrt(6.0 / (n_in + n_out))
        mlp.append((rng.uniform(-lim, lim, (n_in, n_out)).astype(dtype),
                    (0.1 * rng.standard_normal(n_out)).astype(dtype)))
    return u, taps, d0, mlp


def _to_jax(u, taps, d0, mlp):
    return (jnp.asarray(u), jnp.asarray(taps), jnp.asarray(d0),
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in mlp])


def _to_torch(u, taps, d0, mlp, device="cpu"):
    t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
    return t(u), t(taps), t(d0), [(t(w), t(b)) for w, b in mlp]


def _flat(mlp):
    return [x for wb in mlp for x in wb]


@pytest.mark.parametrize("n", [26, 1024])
def test_updet_rhs_torch_matches_xla(n):
    args = _inputs(0, n)
    ref = np.asarray(updet_rhs_xla(*_to_jax(*args)))
    out = tst.updet_rhs_torch(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_updet_rhs_torch_matches_pallas_kernel_interpret():
    # K1: the single-block Pallas kernel (N % 1024 == 0), interpret mode
    args = _inputs(1, 2048)
    ref = np.asarray(jax_fused(*_to_jax(*args), interpret=True))
    out = tst.fused_updet_rhs(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_updet_rhs_torch_matches_pallas_gridded_interpret():
    # K2: the blocked Pallas kernel with its halo table, 4 blocks of 1024
    args = _inputs(2, 4096)
    ref = np.asarray(jax_gridded(*_to_jax(*args), block_size=1024, interpret=True))
    out = tst.fused_updet_rhs(*_to_torch(*args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def _wrap_case(n, pick, device="cpu"):
    """One-hot entries at 0 and N-1, a zero MLP and a pure neighbour pick."""
    u = np.zeros(n, np.float32)
    u[0], u[-1] = 1.0, 2.0
    taps = np.array([1.0, 0.0, 0.0] if pick == "left" else [0.0, 0.0, 1.0], np.float32)
    mlp = [(np.zeros((1, 1), np.float32), np.zeros(1, np.float32))]
    expect = np.roll(u, 1 if pick == "left" else -1)
    return _to_torch(u, taps, np.float32(1.0), mlp, device), expect


@pytest.mark.parametrize("n", [26, 2048])
@pytest.mark.parametrize("pick", ["left", "right"])
def test_periodic_wrap(n, pick):
    args, expect = _wrap_case(n, pick)
    np.testing.assert_array_equal(tst.fused_updet_rhs(*args).numpy(), expect)


def test_wrapper_rows_are_independent_periodic_lines():
    u, taps, d0, mlp = _to_torch(*_inputs(3, 1024, rows=8))
    out = tst.fused_updet_rhs(u, taps, d0, mlp)
    for r in range(8):
        np.testing.assert_array_equal(out[r].numpy(),
                                      tst.updet_rhs_torch(u[r], taps, d0, mlp).numpy())


@pytest.mark.parametrize("case", ["taps", "d0", "chain", "last", "dtype", "ndim"])
def test_wrapper_rejects_bad_inputs(case):
    u, taps, d0, mlp = _to_torch(*_inputs(4, 64, sizes=(1, 3, 1)))
    if case == "taps":
        taps = taps[:2]
    elif case == "d0":
        d0 = torch.ones(2)
    elif case == "chain":
        mlp = [mlp[0], (torch.zeros(4, 1), torch.zeros(1))]
    elif case == "last":
        mlp = [mlp[0], (torch.zeros(3, 2), torch.zeros(2))]
    elif case == "dtype":
        taps = taps.double()
    elif case == "ndim":
        u = u.reshape(4, 4, 4)
    with pytest.raises((ValueError, TypeError)):
        tst.fused_updet_rhs(u, taps, d0, mlp)


def test_fused_jvp_and_grad_match_jax_fused_model():
    # mirrors test_model_rhs_fused_dispatch_is_differentiable: the JAX model
    # routed through its Pallas custom_jvp (interpret mode) against the port's
    # FusedUpdetRHS, both AD modes, same numpy inputs and weights
    from universal_differential_equations_tpu.models import fisher_kpp as jfk
    from universal_differential_equations_torch.convert import params_from_jax
    from universal_differential_equations_torch.models import fisher_kpp as tfk

    rhs_j, params_j = jfk.make_model(jax.random.PRNGKey(7), "small", dtype=jnp.float32)
    rng = np.random.default_rng(7)
    u_np = rng.uniform(size=1024).astype(np.float32)
    tan_np = rng.standard_normal(1024).astype(np.float32)
    u_j = jnp.asarray(u_np)

    def loss_j(p):
        return jnp.sum(rhs_j(0.0, u_j, p) ** 2)

    jfk._FUSED_INTERPRET = True
    try:
        g_j = jax.grad(loss_j)(params_j)
        _, jvp_j = jax.jvp(lambda uu: rhs_j(0.0, uu, params_j), (u_j,), (jnp.asarray(tan_np),))
    finally:
        jfk._FUSED_INTERPRET = False

    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rx = tfk.MLP([1, 3, 1], activation="tanh")

    def rhs_t(u, p):
        return tst.FusedUpdetRHS.apply(u, p["w"], p["D0"], *_flat(rx.as_matmul_params(p["rx"])))

    leaves = [params_t["D0"], params_t["rx"][0]["b"], params_t["rx"][0]["w"],
              params_t["rx"][1]["b"], params_t["rx"][1]["w"], params_t["w"]]
    for leaf in leaves:
        leaf.requires_grad_(True)
    u_t = torch.tensor(u_np)
    grads = torch.autograd.grad(torch.sum(rhs_t(u_t, params_t) ** 2), leaves)
    ref = jax.tree.leaves(g_j)  # sorted-key order: D0, rx[0].b, rx[0].w, ...
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    p_plain = params_from_jax(jax.tree.map(np.asarray, params_j))
    _, jvp_t = torch.func.jvp(lambda uu: rhs_t(uu, p_plain), (u_t,), (torch.tensor(tan_np),))
    np.testing.assert_allclose(jvp_t.numpy(), np.asarray(jvp_j), rtol=1e-5, atol=1e-5)


def test_fused_autograd_function_gradcheck_f64():
    u, taps, d0, mlp = _to_torch(*_inputs(5, 32, sizes=(1, 4, 3, 1), dtype=np.float64))
    inputs = [t.requires_grad_(True) for t in (u, taps, d0, *_flat(mlp))]
    assert torch.autograd.gradcheck(tst.FusedUpdetRHS.apply, inputs,
                                    check_forward_ad=True)


def test_fused_forward_ad_matches_plain_jvp_f64():
    import torch.autograd.forward_ad as fwAD

    u, taps, d0, mlp = _to_torch(*_inputs(6, 40, sizes=(1, 5, 1), dtype=np.float64))
    rng = np.random.default_rng(60)
    tangents = [torch.tensor(rng.standard_normal(t.shape)) for t in (u, taps, d0, *_flat(mlp))]
    primals = (u, taps, d0, *_flat(mlp))
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(primals, tangents)]
        out = fwAD.unpack_dual(tst.FusedUpdetRHS.apply(*duals)).tangent
    plain = lambda u_, t_, d_, *f: tst.updet_rhs_torch(u_, t_, d_, tst._pairs(f))  # noqa: E731
    _, ref = torch.func.jvp(plain, primals, tuple(tangents))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def test_fused_vmap_rule_sends_a_batch_of_states_as_rows():
    u, taps, d0, mlp = _to_torch(*_inputs(8, 128, rows=5))
    out = torch.func.vmap(lambda uu: tst.FusedUpdetRHS.apply(uu, taps, d0, *_flat(mlp)))(u)
    np.testing.assert_array_equal(out.numpy(), tst.updet_rhs_torch(u, taps, d0, mlp).numpy())
    # per-row weights have no kernel: the rule refuses them
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda tt: tst.FusedUpdetRHS.apply(u[0], tt, d0, *_flat(mlp)))(
            taps.expand(2, 3))


# ---------------------------------------------------------------------------
# the tangent path: updet_rhs_jvp over a block of directions, updet_tangent
# ---------------------------------------------------------------------------
def _tangent_block(seed, T, u, mlp, dtype=np.float64):
    """du (T, *u.shape), dtaps (T, 3), dd0 (T,), [(dw (T, h_in, h_out), db (T, h_out))]."""
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.standard_normal(shape).astype(dtype)  # noqa: E731
    return (draw(T, *np.shape(u)), draw(T, 3), draw(T),
            [(draw(T, *w.shape), draw(T, *b.shape)) for w, b in mlp])


@pytest.mark.parametrize("sizes", [(1, 3, 1), PAPER])
@pytest.mark.parametrize("n", [26, 1024])
@pytest.mark.parametrize("T", [1, 7])
def test_updet_rhs_jvp_block_matches_jax_vmap_jvp(sizes, n, T):
    # the plain tangent over an explicit (T, N) block against jax.vmap of
    # jax.jvp(updet_rhs_xla) (the JAX tangent rule _fused_rhs_jvp), float64
    u, taps, d0, mlp = _inputs(30 + T, n, sizes, dtype=np.float64)
    du, dtaps, dd0, dmlp = _tangent_block(31 + n, T, u, mlp)
    primals = _to_jax(u, taps, d0, mlp)

    def jvp_one(du_, dt_, dd_, dm_):
        return jax.jvp(updet_rhs_xla, primals, (du_, dt_, dd_, dm_))[1]

    ref = jax.vmap(jvp_one)(*_to_jax(du, dtaps, dd0, dmlp))
    out = tst.updet_rhs_jvp(*_to_torch(u, taps, d0, mlp), *_to_torch(du, dtaps, dd0, dmlp))
    assert out.shape == (T, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)


def test_tangent_wrapper_one_direction_block_and_rows():
    # the wrapper on CPU tensors is the plain tangent: one direction, a block
    # of directions, and a block over (rows, N) states; bad shapes raise
    u, taps, d0, mlp = _to_torch(*_inputs(40, 48, sizes=(1, 4, 1), rows=3, dtype=np.float64))
    du, dtaps, dd0, dmlp = _to_torch(*_tangent_block(41, 5, u, mlp))
    block = tst.fused_updet_rhs_tangent(u, taps, d0, mlp, du, dtaps, dd0, dmlp)
    assert block.shape == (5, 3, 48)
    for t in range(5):
        one = tst.fused_updet_rhs_tangent(u, taps, d0, mlp, du[t], dtaps[t], dd0[t],
                                          [(a[t], b[t]) for a, b in dmlp])
        np.testing.assert_allclose(block[t].numpy(), one.numpy(), rtol=1e-12, atol=1e-12)
        for r in range(3):
            row = tst.updet_rhs_jvp(u[r], taps, d0, mlp, du[t, r], dtaps[t], dd0[t],
                                    [(a[t], b[t]) for a, b in dmlp])
            np.testing.assert_allclose(one[r].numpy(), row.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tst.fused_updet_rhs_tangent(u, taps, d0, mlp, du, dtaps[:, :2], dd0, dmlp)
    with pytest.raises(ValueError):
        tst.fused_updet_rhs_tangent(u, taps, d0, mlp, du[:, 0], dtaps, dd0, dmlp)


@pytest.mark.parametrize("variant", ["small", "mlp"])
def test_jacfwd_through_fused_rhs_matches_jax_fused_model(variant):
    # torch.func.jacfwd through FusedUpdetRHS (plain inside on the CPU: the
    # primal and updet_tangent's vmap rule) against jax.jacfwd of the JAX model
    # routed through its Pallas custom_jvp (interpret mode), N = 1024, float32
    from universal_differential_equations_tpu.models import fisher_kpp as jfk
    from universal_differential_equations_torch.convert import params_from_jax
    from universal_differential_equations_torch.models import fisher_kpp as tfk

    rhs_j, params_j = jfk.make_model(jax.random.PRNGKey(3), variant, dtype=jnp.float32)
    u_np = np.random.default_rng(3).uniform(size=1024).astype(np.float32)
    jfk._FUSED_INTERPRET = True
    try:
        J_j = jax.jacfwd(lambda p: rhs_j(0.0, jnp.asarray(u_np), p))(params_j)
    finally:
        jfk._FUSED_INTERPRET = False

    params_t = params_from_jax(jax.tree.map(np.asarray, params_j))
    rx = tfk.MLP(list(tfk._MLP_VARIANTS[variant]), activation="tanh")
    u_t = torch.tensor(u_np)

    def rhs_t(p):
        return tst.FusedUpdetRHS.apply(u_t, p["w"], p["D0"],
                                       *_flat(rx.as_matmul_params(p["rx"])))

    J_t = torch.func.jacfwd(rhs_t)(params_t)
    pairs = [(J_t["D0"], J_j["D0"]), (J_t["w"], J_j["w"])]
    for lt, lj in zip(J_t["rx"], J_j["rx"]):
        pairs += [(lt["w"], lj["w"]), (lt["b"], lj["b"])]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_updet_tangent_vmap_rule_equals_single_directions():
    # updet_tangent's vmap rule (one call over T directions, absent batch dims
    # expanded, dims moved to the front) gives what T single-direction calls give
    u, taps, d0, mlp = _to_torch(*_inputs(50, 64, sizes=(1, 4, 3, 1), dtype=np.float64))
    flat = _flat(mlp)
    rng = np.random.default_rng(51)
    fixed = [torch.tensor(rng.standard_normal(p.shape)) for p in (u, taps, d0, *flat)]
    T = 5
    du = torch.tensor(rng.standard_normal((T, 64)))
    dtaps = torch.tensor(rng.standard_normal((3, T)))  # batched along dim 1
    dw0 = torch.tensor(rng.standard_normal((T, 1, 4)))

    def one(du_, dtaps_, dw0_):
        dflat = list(fixed[3:])
        dflat[0] = dw0_
        return tst.updet_tangent(u, taps, d0, flat, du_, dtaps_, fixed[2], dflat)

    out = torch.func.vmap(one, in_dims=(0, 1, 0))(du, dtaps, dw0)
    expect = torch.stack([one(du[i], dtaps[:, i], dw0[i]) for i in range(T)])
    np.testing.assert_allclose(out.numpy(), expect.numpy(), rtol=1e-12, atol=1e-12)
    # batched primals have no kernel: the rule refuses them
    with pytest.raises(NotImplementedError):
        torch.func.vmap(lambda uu: tst.updet_tangent(uu, taps, d0, flat, *fixed[:3],
                                                     fixed[3:]))(u.expand(2, 64))


@pytest.mark.parametrize("outer", ["jacrev", "jacfwd"])
def test_second_derivatives_through_fused_rhs_match_jax(outer):
    # FusedUpdetRHS's JVP is itself differentiable, as the JAX custom_jvp's
    # tangent rule is: jacrev or jacfwd over jacfwd, with respect to the
    # weights and to a scale of the state, against the same through
    # fused_updet_rhs_diff (Pallas in interpret mode), float64
    from universal_differential_equations_tpu.ops import fused_updet_rhs_diff

    sizes = (1, 3, 1)
    u, taps, d0, mlp = _inputs(70, 1024, sizes, dtype=np.float64)
    v = np.random.default_rng(71).standard_normal(1024)
    shapes = [(3,), ()] + [s for wb in mlp for s in (np.shape(wb[0]), np.shape(wb[1]))]
    x = np.concatenate([np.ravel(a) for a in (taps, d0, *_flat(mlp))] + [[0.3]])

    def split(xs, reshape):
        parts, k = [], 0
        for shape in shapes:
            size = int(np.prod(shape))
            parts.append(reshape(xs[k:k + size], shape))
            k += size
        return parts, xs[k]

    def f_jax(xs):
        (t, d, *fl), s = split(xs, jnp.reshape)
        return fused_updet_rhs_diff(jnp.asarray(u) + s * jnp.asarray(v), t, d,
                                    list(zip(fl[0::2], fl[1::2])), True)

    def f_torch(xs):
        (t, d, *fl), s = split(xs, torch.reshape)
        return tst.FusedUpdetRHS.apply(torch.tensor(u) + s * torch.tensor(v), t, d, *fl)

    want = getattr(jax, outer)(jax.jacfwd(f_jax))(jnp.asarray(x))
    got = getattr(torch.func, outer)(torch.func.jacfwd(f_torch))(torch.tensor(x))
    assert got.shape == (1024, x.size, x.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)


def test_jvp_calls_the_tangent_operator_only_where_it_is_not_differentiated(monkeypatch):
    # kernel B's operator serves each JVP that nothing differentiates; a JVP
    # that is itself differentiated (a transform over jacfwd, autograd
    # through it) is updet_rhs_jvp's PyTorch math.  Under jacfwd over jacfwd
    # the outer level's JVP of the primal is not differentiated: one of each.
    # The results agree with the same transforms of the plain RHS
    u, taps, d0, mlp = _to_torch(*_inputs(80, 32, sizes=(1, 3, 1), dtype=np.float64))
    flat = _flat(mlp)
    calls = {"op": 0, "math": 0}
    op, math = tst.updet_tangent, tst._TangentMath.apply

    def counted(key, fn):
        def call(*args):
            calls[key] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(tst, "updet_tangent", counted("op", op))
    monkeypatch.setattr(tst._TangentMath, "apply", staticmethod(counted("math", math)))

    def f(w0):
        return tst.FusedUpdetRHS.apply(u, taps, d0, w0, *flat[1:])

    def f_plain(w0):
        return tst.updet_rhs_torch(u, taps, d0, tst._pairs([w0, *flat[1:]]))

    w0 = flat[0]
    jac = torch.func.jacfwd
    cases = [
        ("jvp", lambda g: torch.func.jvp(g, (w0,), (torch.ones_like(w0),))[1], (1, 0)),
        ("jacfwd", lambda g: jac(g)(w0), (1, 0)),
        ("jacrev(jacfwd)", lambda g: torch.func.jacrev(jac(g))(w0), (0, 1)),
        ("jacfwd(jacfwd)", lambda g: jac(jac(g))(w0), (1, 1)),
        ("autograd over jacfwd", lambda g: torch.autograd.grad(
            (jac(g)(x := w0.clone().requires_grad_(True)) ** 2).sum(), x)[0], (0, 1)),
    ]
    for name, run, expect in cases:
        calls.update(op=0, math=0)
        got = run(f)
        assert (calls["op"], calls["math"]) == expect, name
        np.testing.assert_allclose(got.detach().numpy(), run(f_plain).detach().numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_specialized_widths_are_the_models_mlp_nets():
    # the width tuples the kernel source compiles (UDE_NETS) are the four
    # reaction nets of models/fisher_kpp.py
    import re
    from pathlib import Path

    from universal_differential_equations_torch.models import fisher_kpp as tfk

    src = (Path(tst.__file__).parents[1] / "csrc" / "updet_rhs.cu").read_text()
    block = src[src.index("#define UDE_NETS(X)"):]
    block = block[:block.index("\n\n")]
    nets = [tuple(int(x) for x in m.split(",")[1:])
            for m in re.findall(r"X\(([\d,\s]+)\)", block)]
    assert sorted(nets) == sorted(tuple(v) for v in tfk._MLP_VARIANTS.values())

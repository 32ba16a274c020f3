"""PyTorch port: the 3-D climate data generators (``models/climate_datagen.py``)
against the JAX package.

The Leray projections (``_project``, and ``_project_rigid`` on the
mirror-doubled grid) equal JAX's to 1e-12 on the same random fields
(float64) and leave the spectral divergence at rounding; one RT chunk (10
Heun/Leray steps) at 16×2×16 from the same noise-free state with random
velocities equals JAX's for both vertical boundary treatments, to 1e-10 in
float64 and 1e-4 relative in float32; the whole RT generator and the forced
tracer (``advection_diffusion_3d``, N = 16) give JAX's save times and
profiles; ``coarse_grain``, the step timers, the JLD2 reader (on a tiny
HDF5 file in the Oceananigans layout); and the ``mesh=`` generators on 2
and 4 gloo ranks against the single-rank runs, to the JAX tests' bounds
(``tests/test_climate_datagen.py:150``, ``:164``, ``:181``), with one case of
a single x-plane per rank (the ranks run ``torch_rank_cases``, a module
without JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_rank_cases import RT, TRACER, climate_generators

from universal_differential_equations_torch.models import climate_datagen as td
from universal_differential_equations_torch.parallel import launch
from universal_differential_equations_tpu.models import climate_datagen as jd

torch.set_num_threads(1)

F64 = torch.float64
SHAPE = (16, 2, 16)
L = (1.0, 2 / 16, 1.0)


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(3)]


def _wavenumbers(nz, lz):
    kx = td._wavenumbers(SHAPE[0], L[0])[:, None, None] * torch.ones((1, SHAPE[1], nz), dtype=F64)
    ky = td._wavenumbers(SHAPE[1], L[1])[None, :, None] * torch.ones((SHAPE[0], 1, nz), dtype=F64)
    kz = td._wavenumbers(nz, lz)[None, None, :] * torch.ones(SHAPE[:2] + (1,), dtype=F64)
    return kx, ky, kz


def test_wavenumbers_equal_jax():
    for n, l in ((16, 1.0), (2, 0.125), (32, 2.0), (7, 1.0)):
        np.testing.assert_array_equal(td._wavenumbers(n, l).numpy(),
                                      np.asarray(jd._wavenumbers(n, l)))


@pytest.mark.parametrize("rigid", [False, True])
def test_projection_equals_jax_and_is_divergence_free(rigid):
    nz, lz = (2 * SHAPE[2], 2 * L[2]) if rigid else (SHAPE[2], L[2])
    kx, ky, kz = _wavenumbers(nz, lz)
    u, v, w = _fields(SHAPE, 1)
    proj_t = td._project_rigid if rigid else td._project
    proj_j = jd._project_rigid if rigid else jd._project
    out_t = proj_t(*(torch.as_tensor(a) for a in (u, v, w)), kx, ky, kz)
    out_j = proj_j(*(jnp.asarray(a) for a in (u, v, w)),
                   *(jnp.asarray(k.numpy()) for k in (kx, ky, kz)))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    ext = (td._ext_even, td._ext_even, td._ext_odd) if rigid else (lambda f: f,) * 3
    uh, vh, wh = (torch.fft.fftn(e(f)) for e, f in zip(ext, out_t))
    div = kx * uh + ky * vh + kz * wh
    assert float(div.abs().max()) < 1e-10 * float(kx.abs().max()) * float(uh.abs().max())


@pytest.mark.parametrize("bc", ["periodic", "rigid_lid"])
@pytest.mark.parametrize("dtypes", [(jnp.float64, F64), (jnp.float32, torch.float32)])
def test_rt_chunk_equals_jax(bc, dtypes):
    jdt, tdt = dtypes
    sj, zj, chunk_j, dx_j = jd._rt_stepper(SHAPE, L, 1e-4, 1e-4, 1.0, 10, None, jdt, bc=bc)
    st, zt, chunk_t, dx_t = td._rt_stepper(SHAPE, L, 1e-4, 1e-4, 1.0, 10, None, tdt, bc=bc,
                                           device="cpu")
    assert dx_t == dx_j
    tol = 1e-10 if tdt == F64 else 1e-4
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=tol)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    vel = [0.1 * a for a in _fields(SHAPE, 2)]
    sj = tuple(jnp.asarray(a, jdt) for a in vel) + (sj[3],)
    st = tuple(torch.as_tensor(a, dtype=tdt) for a in vel) + (st[3],)
    for _ in range(2):
        sj, umax_j = chunk_j(sj, jnp.asarray(2e-3, jdt))
        st, umax_t = chunk_t(st, torch.tensor(2e-3, dtype=tdt))
    for a, b in zip(st, sj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol * np.abs(b).max())
    np.testing.assert_allclose(float(umax_t), float(umax_j), rtol=tol)


@pytest.mark.parametrize("bc", ["periodic", "rigid_lid"])
def test_rayleigh_taylor_generator_equals_jax(bc):
    kw = dict(N=SHAPE, end_time=0.3, save_every=0.1, bc=bc)
    tj, zj, bj = jd.rayleigh_taylor_3d(dtype=jnp.float64, **kw)
    tt, zt, bt = td.rayleigh_taylor_3d(dtype=F64, device="cpu", **kw)
    np.testing.assert_allclose(tt, tj, rtol=1e-12)
    np.testing.assert_allclose(zt, np.asarray(zj), rtol=1e-12)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-10)
    assert bt.shape == (len(tt), SHAPE[2])


def test_tracer_generator_equals_jax():
    tj, pj = jd.advection_diffusion_3d(N=16, end_time=0.02)
    tt, pt = td.advection_diffusion_3d(N=16, end_time=0.02, device="cpu")
    np.testing.assert_allclose(tt, tj, rtol=1e-12)
    assert pt.dtype == np.float32 and pt.shape == pj.shape
    # atol: XLA flushes float32 denormals (the ~1e-45 tail of the sheet) to zero
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-7)
    assert pt[-1].mean() > pt[0].mean()  # the forcing grows the tracer


def test_noise_is_drawn_from_the_torch_generator():
    a = td.rayleigh_taylor_3d(N=(8, 2, 8), end_time=0.05, key=torch.Generator().manual_seed(1),
                              device="cpu")[2]
    b = td.rayleigh_taylor_3d(N=(8, 2, 8), end_time=0.05, key=torch.Generator().manual_seed(1),
                              device="cpu")[2]
    c = td.rayleigh_taylor_3d(N=(8, 2, 8), end_time=0.05, device="cpu")[2]
    np.testing.assert_array_equal(a, b)
    assert 0 < np.abs(a - c).max() < 1e-3


def test_coarse_grain_equals_jax():
    x = np.arange(32.0).reshape(2, 16)
    np.testing.assert_array_equal(td.coarse_grain(x, 4), np.asarray(jd.coarse_grain(x, 4)))
    np.testing.assert_array_equal(td.coarse_grain(torch.as_tensor(x), 4).numpy(),
                                  np.asarray(jd.coarse_grain(x, 4)))


def test_step_timers_return_positive_seconds_on_the_cpu():
    per = td.rt_step_seconds(N=(8, 2, 8), ni=4, repeats=2, device="cpu")
    assert 0.0 < per < 1.0
    per = td.rt_step_seconds(N=(8, 2, 8), ni=2, repeats=1, bc="rigid_lid", device="cpu")
    assert 0.0 < per < 1.0
    per = td.tracer_step_seconds(N=8, ni=3, repeats=1, device="cpu")
    assert 0.0 < per < 1.0


def test_mesh_waits_for_the_parallel_slice():
    # the mesh is ported (several ranks: the sharded tests below): on a
    # one-rank gloo mesh the generators equal the unsharded runs, a grid the
    # mesh does not divide and a mesh axis it lacks raise
    from universal_differential_equations_torch.parallel import ensemble_mesh

    kw = dict(N=(8, 2, 8), end_time=0.05, key=torch.Generator().manual_seed(1), device="cpu")
    ref = td.rayleigh_taylor_3d(**kw)[2]
    ref_c = td.advection_diffusion_3d(N=8, end_time=0.01, device="cpu")[1]
    mesh = ensemble_mesh(axis="x", device="cpu")
    try:
        got = td.rayleigh_taylor_3d(mesh=mesh, **{**kw, "key": torch.Generator().manual_seed(1)})[2]
        got_c = td.advection_diffusion_3d(N=8, end_time=0.01, mesh=mesh, device="cpu")[1]
        assert 0.0 < td.tracer_step_seconds(N=8, ni=2, repeats=1, mesh=mesh, device="cpu") < 1.0
        with pytest.raises(ValueError, match="mesh axis 'y'"):
            td.advection_diffusion_3d(N=8, mesh=mesh, mesh_axis="y", device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got_c, ref_c, rtol=0, atol=5e-6)


def test_load_oceananigans_averages_equals_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    path = tmp_path / "averages.jld2"
    iters = [0, 120, 45, 7]  # written out of order: the reader sorts by iteration
    with h5py.File(path, "w") as f:
        for i in iters:
            f[f"timeseries/t/{i}"] = 0.01 * i
            f[f"timeseries/b/{i}"] = rng.standard_normal(12)
        f["grid/Nz"] = 12
        f["grid/Lz"] = 2.0
    out_t = td.load_oceananigans_averages(path)
    out_j = jd.load_oceananigans_averages(path)
    for a, b in zip(out_t, out_j):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert (np.diff(out_t[0]) > 0).all() and out_t[2].shape == (4, 12)


@pytest.fixture(scope="module")
def sharded():
    """``{ws: [rank 0's results, ...]}`` for 2 and 4 ranks, and the
    single-rank references."""
    runs = {ws: launch.spawn(climate_generators, ws, ws, True, timeout=600) for ws in (2, 4)}
    seed = lambda k: torch.Generator().manual_seed(k)  # noqa: E731
    refs = dict(
        tracer=td.advection_diffusion_3d(key=seed(0), device="cpu", **TRACER),
        rt=td.rayleigh_taylor_3d(key=seed(1), device="cpu", **RT),
        rigid=td.rayleigh_taylor_3d(key=seed(1), bc="rigid_lid", device="cpu", **RT))
    for ws in (2, 4):
        refs[("plane", ws)] = td.rayleigh_taylor_3d(key=seed(1), device="cpu",
                                                    **{**RT, "N": (ws, 2, 16)})
    return runs, refs


@pytest.mark.parametrize("ws", [2, 4])
def test_advection_diffusion_sharded_matches_single_rank(sharded, ws):
    ts0, p0 = sharded[1]["tracer"]
    for rank_out in sharded[0][ws]:  # every rank returns the profiles
        ts1, p1 = rank_out["tracer"]
        np.testing.assert_allclose(ts1, ts0, rtol=1e-6)
        np.testing.assert_allclose(p1, p0, atol=5e-6)


@pytest.mark.parametrize("bc", ["rt", "rigid"])
@pytest.mark.parametrize("ws", [2, 4])
def test_rayleigh_taylor_sharded_matches_single_rank(sharded, ws, bc):
    ts0, z0, b0 = sharded[1][bc]
    for rank_out in sharded[0][ws]:
        ts1, z1, b1 = rank_out[bc]
        np.testing.assert_allclose(ts1, ts0, rtol=1e-6)
        np.testing.assert_array_equal(z1, z0)
        np.testing.assert_allclose(b1, b0, atol=5e-5)


@pytest.mark.parametrize("ws", [2, 4])
def test_rayleigh_taylor_one_x_plane_per_rank(sharded, ws):
    ts0, _, b0 = sharded[1][("plane", ws)]
    for rank_out in sharded[0][ws]:
        ts1, _, b1 = rank_out["plane"]
        np.testing.assert_allclose(ts1, ts0, rtol=1e-6)
        np.testing.assert_allclose(b1, b0, atol=5e-5)
        assert np.isfinite(b1).all()

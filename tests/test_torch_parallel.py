"""PyTorch port: ``parallel/`` on ``torch.distributed`` and every ``mesh=`` path,
on gloo ranks of the CPU.

One spawn per world size (2 and 4 ranks, ``parallel.launch.spawn``: a
``FileStore`` in a temporary directory) runs every multi-rank case of this
file (``torch_rank_cases.parallel_cases``, a module without JAX) while this process computes the unsharded runs of the
port and the JAX package's on the same inputs; each test then reads its
case.  The ranks import no JAX.  Tolerances: the JAX tests' own where they
state one (deep-BSDE: ``tests/test_sde_deepbsde.py:167``), else rel 1e-12
in float64 and 1e-6 in float32 (the cross-rank sums reassociate).
"""
import threading
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import universal_differential_equations_torch as tude
import universal_differential_equations_tpu as jude
from torch_rank_cases import (
    BSDE_KW,
    MAIN_CHUNK,
    N_SHOOT,
    RECOVER_LANES,
    bsde_port,
    bsde_problem,
    hjb_tiny,
    lv_run,
    parallel_cases,
    rel as _rel,
    shoot_kw,
    shrunk_study,
    study_main,
)
from universal_differential_equations_torch.examples import hjb_100d
from universal_differential_equations_torch.examples import run_loops as rl
from universal_differential_equations_torch.models import lotka_volterra as lv
from universal_differential_equations_torch.parallel import launch
from universal_differential_equations_tpu import deepbsde as jdb
from universal_differential_equations_tpu.ensemble import ensemble_run as jrun
from universal_differential_equations_tpu.models import lotka_volterra as jlv
from universal_differential_equations_tpu.nn import MLP as JMLP
from universal_differential_equations_tpu.parallel import ensemble_mesh as jmesh

F64 = torch.float64


def _inputs():
    """The cases' inputs, from numpy seeds and the JAX package (its
    deep-BSDE initial weights and draws)."""
    # tests/test_shooting_ensemble_io.py:103's 16 initial states
    u0s = lv.U0.numpy() * (1.0 + 0.05 * np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (16, 2), jnp.float64)))
    ts = np.linspace(0.0, 0.1 * (N_SHOOT - 1), N_SHOOT)
    sol = tude.solve(tude.ODEProblem(lv.lotka_rhs, lv.U0, (0.0, float(ts[-1])), lv.P_TRUE),
                     tude.Tsit5(), saveat=torch.as_tensor(ts), rtol=1e-10, atol=1e-12)
    # the JAX trainer's initial weights and draws (deepbsde/solver.py:122-127, :190)
    key = jax.random.PRNGKey(3)
    k_init, k_train = jax.random.split(key)
    k1, k2 = jax.random.split(k_init)
    p0 = {"u0": JMLP([3, 8, 1], activation="relu").init(k1, jnp.float64),
          "grad": JMLP([4, 8, 3], activation="relu").init(k2, jnp.float64)}
    shape = (BSDE_KW["trajectories"], BSDE_KW["n_steps"], 3)
    normals = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(k_train, 0), it), shape, jnp.float64))
        for it in range(BSDE_KW["maxiters"])])
    with shrunk_study():
        st = rl.build_stages(device="cpu")
        data, theta0, mags = st.lane_inputs(np.arange(RECOVER_LANES) * 62, 100)
        theta, _ = st.adam_stage(theta0, data, steps=5)
    recover_in = dict(theta=theta.numpy(), data=data.numpy(), mags=mags.numpy(),
                      loss=np.full(RECOVER_LANES, 1e-4, np.float32))
    return dict(u0s=u0s, shoot_data=sol.ys.numpy(), shoot_ts=ts, p0=lv.P_TRUE.numpy() * 1.1,
                bsde_normals=normals, bsde_params=jax.tree.map(np.asarray, p0),
                recover=recover_in)


def _references(inputs, tmp):
    """The unsharded runs: the port's, and the JAX package's where it has
    the surface."""
    refs = {}

    # read outside the trace: the JAX module creates its constants at first
    # read and caches them, so a first read under jit would cache a tracer
    p_true = jlv.P_TRUE

    def j_run(u0):
        sol = jude.solve(jude.ODEProblem(jlv.lotka_rhs, u0, (0.0, 1.0), p_true),
                         jude.Tsit5(), rtol=1e-6, atol=1e-8, adjoint=jude.NoAdjoint(),
                         max_steps=256)
        return sol.y_final, sol.success

    res = jrun(j_run, jnp.asarray(inputs["u0s"]), mesh=jmesh(8), sharded=True)
    refs["ensemble_jax"] = np.asarray(res.outputs), np.asarray(res.success)
    out, ok = torch.func.vmap(lv_run)(torch.as_tensor(inputs["u0s"]))
    refs["ensemble"] = out.numpy(), ok.numpy()

    data, ts = torch.as_tensor(inputs["shoot_data"]), torch.as_tensor(inputs["shoot_ts"])
    loss = lambda p: tude.multiple_shoot(p, data, ts, lv.lotka_rhs, **shoot_kw())  # noqa: E731
    g, v = torch.func.grad_and_value(loss)(torch.as_tensor(inputs["p0"]))
    refs["shooting"] = float(v), g.numpy()
    jloss = lambda p: jude.multiple_shoot(p, jnp.asarray(inputs["shoot_data"]),  # noqa: E731
                                          jnp.asarray(ts.numpy()), jlv.lotka_rhs, mesh=None,
                                          **shoot_kw())
    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(inputs["p0"]))
    refs["shooting_jax"] = float(jv), np.asarray(jg)

    refs["bsde"] = bsde_port(inputs["bsde_normals"], inputs["bsde_params"], None)
    jalg = jdb.NNPDENS(JMLP([3, 8, 1], activation="relu"), JMLP([4, 8, 3], activation="relu"))
    jres = jdb.solve_terminal_pde(bsde_problem(jdb, jnp, jnp.float64), jalg,
                                  jax.random.PRNGKey(3), dtype=jnp.float64, **BSDE_KW)
    refs["bsde_jax"] = np.asarray(jres.losses), float(jres.u0)

    with shrunk_study():
        st = rl.build_stages(device="cpu")
        args = [torch.as_tensor(inputs["recover"][k]) for k in ("theta", "data", "loss", "mags")]
        refs["recover"] = [o.numpy() for o in st.recover_stage(*args)]
    refs["hjb"] = hjb_tiny(hjb_100d, None)
    refs["main"] = study_main(None, MAIN_CHUNK, str(tmp))
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks, refs, dirs)``: ``ranks[ws]`` the ``ws`` ranks' case results,
    for ws in (2, 4), spawned side by side; ``refs`` the unsharded runs, computed here meanwhile;
    ``dirs`` the study archives (``None`` the unsharded run's)."""
    torch.set_num_threads(2)
    inputs = _inputs()
    ranks, failure = {}, []
    dirs = {ws: tmp_path_factory.mktemp(f"study{ws}") for ws in (None, 2, 4)}

    def spawn(ws):
        try:
            ranks[ws] = launch.spawn(parallel_cases, ws, ws, inputs, str(dirs[ws]), timeout=900)
        except Exception:
            failure.append(traceback.format_exc())

    threads = [threading.Thread(target=spawn, args=(ws,)) for ws in (2, 4)]
    for t in threads:
        t.start()
    try:
        refs = _references(inputs, dirs[None])
    finally:
        for t in threads:
            t.join(timeout=1200)
    assert not any(t.is_alive() for t in threads) and not failure, failure
    return ranks, refs, dirs


def _case(runs, ws, name):
    out = [r[name] for r in runs[0][ws]]
    for o in out:
        if isinstance(o, str) and o.startswith("error: "):
            pytest.fail(o)
    return out


@pytest.mark.parametrize("ws", [2, 4])
def test_mesh_and_collective_helpers(runs, ws):
    out = _case(runs, ws, "helpers")
    rows = np.arange(30.0).reshape(10, 3)
    sizes = [10 // ws + (1 if j < 10 % ws else 0) for j in range(ws)]
    lo = 0
    for rank, o in enumerate(out):
        assert o["axis"] == ("ensemble",) and o["size"] == ws and o["shape"] == {"ensemble": ws}
        assert o["index"] == rank and o["sub_index"] == (0 if rank == 0 else None)
        np.testing.assert_array_equal(o["rows"], rows[lo:lo + sizes[rank]])
        lo += sizes[rank]
        np.testing.assert_array_equal(o["gathered"], rows)
        np.testing.assert_array_equal(o["rep"], [0.0, 0.0])  # rank 0's values everywhere
        assert o["total"] == 2.0 * rows.sum() and o["grad"] == rows.sum()
        np.testing.assert_array_equal(o["halo"][0], [[(rank - 1) % ws] * 2])
        np.testing.assert_array_equal(o["halo"][1], [[(rank + 1) % ws] * 2])
        assert "meta" in o["wrong"] and "cpu mesh" in o["wrong"]
        # no opt-in: a no-op; with it, the existing group is taken, twice
        assert o["opted"] is False and o["joined"] == (True, True, True)
        assert o["count"] == ws and o["rank"] == rank and o["global_size"] == ws


def test_distributed_helpers_without_a_group():
    from universal_differential_equations_torch import parallel as par

    assert not torch.distributed.is_initialized()
    assert par.initialize_distributed() is False and not par.is_distributed()
    assert par.process_count() == 1 and par.process_rank() == 0
    assert par.local_device_count() == (torch.cuda.device_count()
                                        if torch.cuda.is_available() else 1)


@pytest.mark.parametrize("ws", [2, 4])
def test_ensemble_run_sharded_equals_unsharded_and_jax(runs, ws):
    out = _case(runs, ws, "ensemble")
    ref, ref_ok = runs[1]["ensemble"]
    jax_out, jax_ok = runs[1]["ensemble_jax"]
    for y, ok in out:  # every rank holds the whole batch
        assert y.shape == (16, 2) and ok.all()
        np.testing.assert_array_equal(ok, ref_ok)
        assert _rel(y, ref) <= 1e-12
        assert _rel(y, jax_out) <= 1e-9 and np.array_equal(ok, jax_ok)


@pytest.mark.parametrize("ws", [2, 4])
def test_multiple_shoot_sharded_equals_unsharded_and_jax(runs, ws):
    out = _case(runs, ws, "shooting")
    v0, g0 = runs[1]["shooting"]
    vj, gj = runs[1]["shooting_jax"]
    for v, g, g_ag, jf in out:
        assert abs(v / v0 - 1.0) <= 1e-12 and _rel(g, g0) <= 1e-12
        assert _rel(g_ag, g0) <= 1e-12 and _rel(jf, g0) <= 1e-9
        # JAX with mesh=None, the keyword the port now accepts
        assert abs(v / vj - 1.0) <= 1e-9 and _rel(g, gj) <= 1e-8


def test_multiple_shoot_accepts_mesh_none_like_jax():
    from universal_differential_equations_torch.models import lotka_volterra as lv

    ts = torch.linspace(0.0, 0.5, 6, dtype=F64)
    data = lv.U0[None].expand(6, 2)
    kw = shoot_kw()
    a = tude.multiple_shoot(lv.P_TRUE, data, ts, lv.lotka_rhs, **kw)
    b = tude.multiple_shoot(lv.P_TRUE, data, ts, lv.lotka_rhs, mesh=None, mesh_axis=None, **kw)
    assert float(a) == float(b)


@pytest.mark.parametrize("ws", [2, 4])
def test_deep_bsde_sharded_equals_unsharded_and_jax(runs, ws):
    out = _case(runs, ws, "bsde")
    losses0, u00 = runs[1]["bsde"]
    losses_j, u0_j = runs[1]["bsde_jax"]
    for losses, u0, ragged in out:
        assert "multiple of the mesh size" in ragged
        # tests/test_sde_deepbsde.py:167's bound, sharded against unsharded
        np.testing.assert_allclose(losses, losses0, rtol=1e-5)
        np.testing.assert_allclose(u0, u00, rtol=1e-5)
        np.testing.assert_allclose(losses, losses_j, rtol=1e-5)
        np.testing.assert_allclose(u0, u0_j, rtol=1e-5)


@pytest.mark.parametrize("ws", [2, 4])
def test_run_loops_recover_stage_sharded_equals_unsharded(runs, ws):
    out = _case(runs, ws, "recover")
    ref = runs[1]["recover"]
    for rank_out in out:
        for i, (o, r) in enumerate(zip(rank_out, ref)):
            assert o.shape == r.shape, i
            if r.dtype == bool:  # selections exactly
                np.testing.assert_array_equal(o, r, err_msg=f"recover output {i}")
            else:
                np.testing.assert_allclose(o, r, rtol=1e-6, atol=1e-7,
                                           err_msg=f"recover output {i}")


@pytest.mark.parametrize("ws", [2, 4])
def test_hjb_auto_mesh_equals_no_mesh(runs, ws):
    out = _case(runs, ws, "hjb")
    u0_ref, losses_ref = runs[1]["hjb"]
    for size, (u0, losses) in out:
        assert size == ws  # the largest divisor of 100 not above the rank count
        np.testing.assert_allclose(losses, losses_ref, rtol=1e-5)
        np.testing.assert_allclose(u0, u0_ref, rtol=1e-5)


@pytest.mark.parametrize("ws", [2, 4])
def test_run_loops_main_on_a_mesh_end_to_end(runs, ws):
    out = _case(runs, ws, "main")
    ref = runs[1]["main"]
    for res in out:  # every rank returns the gathered summary
        assert res.keys() == ref.keys()
        for k, v in ref.items():
            if k in ("err", "aicc"):
                assert _rel(res[k], v) <= 1e-6, k
            else:
                assert res[k] == v, k
    # rank 0 wrote the archive the unsharded run writes: the chunk of 5 lanes
    # (padded over the mesh), the restart pass, the oracle, weak and combo
    # passes and the study
    mine = {p.name: p for p in runs[2][ws].glob("*.npz")}
    theirs = {p.name: p for p in runs[2][None].glob("*.npz")}
    assert sorted(mine) == sorted(theirs) and "loop_study.npz" in mine
    for name, path in theirs.items():
        with np.load(path) as a, np.load(mine[name]) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                x, y = a[k], b[k]
                assert x.shape == y.shape and x.dtype == y.dtype, (name, k)
                if x.dtype.kind in "biu":
                    np.testing.assert_array_equal(y, x, err_msg=f"{name}:{k}")
                else:  # float16 loss history at its own resolution
                    rtol = 1e-3 if x.dtype == np.float16 else 1e-6
                    np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-7,
                                               err_msg=f"{name}:{k}")


@pytest.mark.parametrize("ws", [2, 4])
def test_run_loops_mesh_flag_rounds_the_chunk_as_jax(runs, ws):
    # examples/lotka_volterra/run_loops.py:1374-1378: the largest multiple of
    # the device count not above CHUNK, at least the count; --chunk as given
    jax_chunk = lambda chunk, size: max(chunk // size, 1) * size  # noqa: E731
    for got in _case(runs, ws, "cli_mesh"):
        assert got == [(ws, jax_chunk(rl.CHUNK, ws)), (ws, jax_chunk(7, ws)), (ws, 5)]


def test_dryrun_multichip_two_ranks(runs):
    lines = _case(runs, 2, "dryrun")[0]
    assert len(lines) == 6 and all(line.startswith("dryrun_multichip(2): ") for line in lines)
    assert all(" OK" in line for line in lines)

"""The rank bodies of the multi-rank tests (``test_torch_parallel.py``,
``test_torch_climate_datagen.py``) and the port-side helpers they share
with those tests' unsharded references.

``parallel.launch.spawn`` pickles a rank body by its import path, so every
rank imports this module: it imports no JAX, and the ranks start fast.
"""
import contextlib
import math
import traceback

import numpy as np
import torch

import universal_differential_equations_torch as tude

F64 = torch.float64
RECOVER_LANES = 8  # tests/test_distributed.py:138's lanes
N_SHOOT = 18  # 9 segments of group 3: ragged over 2 and 4 ranks
# the study at a small budget, as tests/test_torch_lv_study.py shrinks it
SHRINK = (("ADAM_STEPS", 2), ("BFGS_ROUNDS", 1), ("BFGS_ITERS_PER_ROUND", 2),
          ("LM_ROUNDS", 1), ("LM_ITERS", 1), ("K_SEL", 2), ("MAX_TOTAL_SUPPORT", 3),
          ("REFIT_ITERS", 2), ("REFIT_TOP", (2, 2)))
# main end to end with one LM round after ADAM and the judge at its smallest
# budget, one rung (the recover case keeps K_SEL 2): its subject is the
# chunking, padding, gathering and archive, on the 5 lanes of one chunk
MAIN_BUDGET = (("BFGS_ROUNDS", 0), ("K_SEL", 1), ("MAX_TOTAL_SUPPORT", 2), ("REFIT_ITERS", 1),
               ("REFIT_TOP", (1,)))
MAIN_CHUNK = 6
BSDE_KW = dict(trajectories=32, n_steps=8, maxiters=25, learning_rate=0.03, pabstol=0.0)
# the JAX tests' generator configurations (tests/test_climate_datagen.py:140-181)
TRACER = dict(N=16, end_time=0.05, save_every=0.01, ni=5)
RT = dict(N=(16, 2, 16), end_time=0.4, save_every=0.1, ni=5)


@contextlib.contextmanager
def shrunk_study(extra=()):
    """``examples.run_loops`` with the ``SHRINK`` constants, then ``extra``'s,
    restored on exit."""
    from universal_differential_equations_torch.examples import run_loops as rl

    values = dict(SHRINK + tuple(extra))
    saved = {name: getattr(rl, name) for name in values}
    try:
        for name, value in values.items():
            setattr(rl, name, value)
        yield rl
    finally:
        for name, value in saved.items():
            setattr(rl, name, value)


def lv_run(u0):
    from universal_differential_equations_torch.models import lotka_volterra as lv

    sol = tude.solve(tude.ODEProblem(lv.lotka_rhs, u0, (0.0, 1.0), lv.P_TRUE), tude.Tsit5(),
                     rtol=1e-6, atol=1e-8, adjoint=tude.NoAdjoint(), max_steps=256)
    return sol.y_final, sol.success


def shoot_kw():
    return dict(group_size=3, continuity_term=10.0, rtol=1e-6, atol=1e-8, max_steps=64)


def bsde_problem(mod, xp, dtype):
    x0 = xp.zeros(3, dtype=dtype)
    return mod.TerminalPDEProblem(
        g=lambda x: xp.log(0.5 + 0.5 * xp.sum(x * x)), f=lambda t, x, u, z: -xp.sum(z * z),
        mu=lambda t, x: xp.zeros_like(x), sigma=lambda t, x: math.sqrt(2.0), x0=x0,
        tspan=(0.0, 1.0))


def bsde_port(normals, params, mesh):
    from universal_differential_equations_torch import deepbsde as tb

    alg = tb.NNPDENS(tude.MLP([3, 8, 1], activation="relu"),
                     tude.MLP([4, 8, 3], activation="relu"))
    res = tb.solve_terminal_pde(bsde_problem(tb, torch, F64), alg, mesh=mesh, dtype=F64,
                                params=tude.params_from_jax(params, dtype=F64),
                                normals=lambda stage, it, shape: normals[it], **BSDE_KW)
    return res.losses.numpy(), float(res.u0)


def hjb_tiny(hjb, mesh):
    """``hjb_100d.main(quick=True)`` at 3 iterations and 10^3 Monte-Carlo
    samples: ``(u0, losses)`` of its trainer."""
    real_solve, real_mc = hjb.solve_terminal_pde, hjb.mc_analytical_hjb
    seen = {}

    def solve(*a, **k):
        seen["res"] = real_solve(*a, **{**k, "maxiters": 3})
        return seen["res"]

    hjb.solve_terminal_pde = solve
    hjb.mc_analytical_hjb = lambda *a, **k: real_mc(*a, **{**k, "n_samples": 1000})
    try:
        hjb.main(quick=True, mesh=mesh, device="cpu")
    except AssertionError:  # 3 iterations miss the rel-L2 gate; the run is what is compared
        pass
    finally:
        hjb.solve_terminal_pde, hjb.mc_analytical_hjb = real_solve, real_mc
    return float(seen["res"].u0), seen["res"].losses.numpy()


def study_main(mesh, chunk, results):
    """``run_loops.main`` end to end on the study's first run of each noise
    level (5 lanes), at the ``SHRINK`` and ``MAIN_BUDGET`` budgets, with
    every arm: its summary."""
    with shrunk_study(MAIN_BUDGET) as rl:
        res = rl.main(runs_per_level=1, archive=True, resume=False, chunk=chunk, mesh=mesh,
                      assert_gates=False, device="cpu", results=results)
    return {k: res[k] for k in ("exact", "contains", "exact_sr3", "contains_sr3", "exact_sr3d",
                                "err", "aicc", "restart_lanes", "exact_oracle", "exact_weak",
                                "exact_combo")}


def parallel_cases(ws, inputs, tmp):
    """Every multi-rank case of ``test_torch_parallel.py`` on one rank of a
    ``ws``-rank gloo group: ``{name: result}``, or ``{name: "error:
    <traceback>"}``."""
    import os

    import torch.distributed as dist

    from universal_differential_equations_torch import parallel as par
    from universal_differential_equations_torch.ensemble import ensemble_run
    from universal_differential_equations_torch.examples import hjb_100d
    from universal_differential_equations_torch.examples import run_loops as rl
    from universal_differential_equations_torch.models import lotka_volterra as lv
    from universal_differential_equations_torch.parallel import collectives as C
    from universal_differential_equations_torch.parallel.dryrun import dryrun_multichip

    rank = dist.get_rank()
    mesh = par.ensemble_mesh(device="cpu")
    out = {}

    def case(name, fn):
        try:
            out[name] = fn()
        except Exception:  # the test of this case reports it
            out[name] = "error: " + traceback.format_exc()

    def helpers():
        sub = par.ensemble_mesh(1, device="cpu")
        x = torch.arange(30.0).reshape(10, 3)
        local = par.shard_ensemble(x, mesh)
        mine = torch.full((2,), float(rank))
        rep = par.replicate({"a": mine}, mesh)["a"]
        p = torch.tensor([2.0], requires_grad=True)
        total = C.psum((C.grad_psum(p, mesh) * local.sum()).sum(), mesh)
        (grad,) = torch.autograd.grad(total, p)
        halo = C.halo_x([torch.full((1, 2), float(rank))], mesh)[0]
        try:
            mesh.check(torch.empty(1, device="meta"))
            wrong = "accepted"
        except ValueError as e:
            wrong = str(e)
        opted = par.initialize_distributed()
        os.environ["UDE_DISTRIBUTED"] = "1"
        try:
            joined = (par.initialize_distributed(device="cpu"), par.initialize_distributed(),
                      par.is_distributed())
        finally:
            del os.environ["UDE_DISTRIBUTED"]
        return dict(axis=mesh.axis_names, size=mesh.size, shape=mesh.shape, index=mesh.index,
                    sub_index=sub.index, rows=local.numpy(),
                    gathered=C.all_gather(local, mesh, 10).numpy(), rep=rep.numpy(),
                    total=float(total), grad=float(grad), halo=[h.numpy() for h in halo],
                    wrong=wrong, opted=opted, joined=joined, count=par.process_count(),
                    rank=par.process_rank(),
                    global_size=par.global_ensemble_mesh().size)

    def ensemble():
        res = ensemble_run(lv_run, torch.as_tensor(inputs["u0s"]), sharded=True)
        return res.outputs.numpy(), res.success.numpy()

    def shooting():
        data, ts = torch.as_tensor(inputs["shoot_data"]), torch.as_tensor(inputs["shoot_ts"])
        p0 = torch.as_tensor(inputs["p0"])
        seg = par.ensemble_mesh(axis="segments", device="cpu")
        loss = lambda p: tude.multiple_shoot(p, data, ts, lv.lotka_rhs, mesh=seg,  # noqa: E731
                                             mesh_axis="segments", **shoot_kw())
        g, v = torch.func.grad_and_value(loss)(p0)
        q = p0.clone().requires_grad_(True)
        (g_ag,) = torch.autograd.grad(loss(q), q)
        jf = torch.func.jacfwd(lambda p: tude.multiple_shoot(
            p, data, ts, lv.lotka_rhs, mesh=seg, adjoint=tude.ForwardSensitivity(),
            **shoot_kw()))(p0)
        return float(v), g.numpy(), g_ag.numpy(), jf.numpy()

    def bsde():
        from universal_differential_equations_torch import deepbsde as tb

        try:  # a batch the mesh does not divide
            tb.solve_terminal_pde(bsde_problem(tb, torch, F64), tb.NNPDENS(
                tude.MLP([3, 2, 1]), tude.MLP([4, 2, 3])), mesh=mesh, trajectories=2 * ws + 1)
            ragged = "accepted"
        except ValueError as e:
            ragged = str(e)
        return bsde_port(inputs["bsde_normals"], inputs["bsde_params"], mesh) + (ragged,)

    def recover():
        with shrunk_study():
            st = rl.build_stages(device="cpu", mesh=mesh)
            args = [torch.as_tensor(inputs["recover"][k]) for k in ("theta", "data", "loss",
                                                                     "mags")]
            return [o.numpy() for o in st.recover_stage(*args)]

    def cli_mesh():
        # the --mesh flag's mesh and chunk, at the study's chunk and at a
        # chunk the rank count does not divide
        saved = rl.CHUNK
        try:
            got = [rl.cli_mesh(None, "cpu")]
            rl.CHUNK = 7
            got.append(rl.cli_mesh(None, "cpu"))
            got.append(rl.cli_mesh(5, "cpu"))
        finally:
            rl.CHUNK = saved
        return [(m.size, c) for m, c in got]

    def hjb():
        return hjb_100d.auto_mesh(torch.device("cpu")).size, hjb_tiny(hjb_100d, "auto")

    case("helpers", helpers)
    case("ensemble", ensemble)
    case("shooting", shooting)
    case("bsde", bsde)
    case("recover", recover)
    case("cli_mesh", cli_mesh)
    case("hjb", hjb)
    # the smallest multiple of the mesh size holding the chunk
    case("main", lambda: study_main(mesh, -(-MAIN_CHUNK // ws) * ws, tmp))
    if ws == 2:
        case("dryrun", lambda: dryrun_multichip(ws))
    return out


def climate_generators(ws, single_plane):
    """On one rank of a ``ws``-rank gloo group: the three climate generators
    on an x-mesh (noise from seeds 0 and 1), and the RT slab of ``ws``
    planes."""
    from universal_differential_equations_torch.models import climate_datagen as td
    from universal_differential_equations_torch.parallel import ensemble_mesh

    mesh = ensemble_mesh(axis="x", device="cpu")
    seed = lambda k: torch.Generator().manual_seed(k)  # noqa: E731
    out = dict(
        tracer=td.advection_diffusion_3d(mesh=mesh, key=seed(0), device="cpu", **TRACER),
        rt=td.rayleigh_taylor_3d(mesh=mesh, key=seed(1), device="cpu", **RT),
        rigid=td.rayleigh_taylor_3d(mesh=mesh, key=seed(1), bc="rigid_lid", device="cpu", **RT))
    if single_plane:
        out["plane"] = td.rayleigh_taylor_3d(mesh=mesh, key=seed(1), device="cpu",
                                             **{**RT, "N": (ws, 2, 16)})
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

"""A run with the timed path broken underneath reads ``correct`` false.

The harness runs as the driver runs it, past its look for a card, on the
CPU at a tiny size; each fault is planted in the program for the run:

* ``unchanged``: a step that returns its state unchanged;
* ``half_batch``: half of the batch left out, the mean taken over the rest
  (half of each lane's samples; half of the paths);
* ``altered``: the answer altered where it is produced (one leaf's change
  doubled);
* ``b2_wrong`` (ADAM): β2 given β1's value, 0.9;
* ``h_skipped`` (BFGS): the inverse Hessian not carried from one iteration
  to the next (one iteration per call).

A one-chip cell has no exchange between chips to leave out.
"""
import functools
import inspect

import pytest
import torch

from perfbench import run

CPU = torch.device("cpu")
LV_TINY = {"cfg": {"runs_per_level": 1},
           "traffic": {"iters_per_request": 1, "trace_iters": 1, "warm_adam_steps": 3}}
HJB_TINY = {"traffic": {"trajectories": 8, "iters_per_request": 1, "trace_iters": 1}}


def double_last_leaf(new, old, n=10):
    """``new`` with the change of its last ``n`` columns doubled (the last
    layer's weight, in a lane's flat vector)."""
    out = new.clone()
    out[..., -n:] = new[..., -n:] + (new[..., -n:] - old[..., -n:])
    return out


def plant_lv(monkeypatch, fault):
    from universal_differential_equations_torch.examples import run_loops

    real_build = run_loops.build_stages

    def build(*a, **k):
        ns = real_build(*a, **k)
        real = ns.adam_stage
        compiled = inspect.getclosurevars(real).nonlocals["compiled"]
        if fault == "half_batch":
            cells = dict(zip(ns.loss_and_grad.__code__.co_freevars, ns.loss_and_grad.__closure__))
            resid = inspect.getclosurevars(ns.mean_loss).nonlocals["resid_lanes"]

            def half_loss(theta, data):
                r = resid(theta, data)
                keep = 2 * ((data.shape[1] + 1) // 2)
                return (r[:, :keep] ** 2).mean(-1)

            cells["mean_loss"].cell_contents = half_loss
            return ns

        def adam_stage(theta0, data, **kw):
            assert compiled  # the stage's graph cache stays reachable
            if fault == "b2_wrong":
                return real(theta0, data, b2=0.9, **kw)
            theta, hist = real(theta0, data, **kw)
            if fault == "unchanged":
                return theta0, hist
            return double_last_leaf(theta, theta0), hist

        real_bfgs = ns.bfgs_round

        def bfgs_round(theta0, data, maxiters):
            if fault == "h_skipped":
                theta, hists = theta0, []
                for _ in range(maxiters):
                    theta, value, hist = real_bfgs(theta, data, maxiters=1)
                    hists.append(hist)
                return theta, value, torch.cat(hists, dim=1)
            if fault == "b2_wrong":
                return real_bfgs(theta0, data, maxiters=maxiters)
            theta, value, hist = real_bfgs(theta0, data, maxiters=maxiters)
            if fault == "unchanged":
                return theta0, value, hist
            return double_last_leaf(theta, theta0), value, hist

        ns.adam_stage, ns.bfgs_round = adam_stage, bfgs_round
        return ns

    monkeypatch.setattr(run_loops, "build_stages", build)


def plant_hjb(monkeypatch, fault):
    from universal_differential_equations_torch.deepbsde import solver

    if fault == "b2_wrong":
        monkeypatch.setattr(torch.optim, "Adam",
                            functools.partial(torch.optim.Adam, betas=(0.9, 0.9)))
        return

    real_make = solver.make_train_step

    def make_train_step(problem, alg, x0, params, *a, **k):
        step, current = real_make(problem, alg, x0, params, *a, **k)
        start = {key: [dict(layer) for layer in layers] for key, layers in params.items()}

        def faulty_step(normals):
            if fault == "half_batch":
                return step(normals[: normals.shape[0] // 2])
            return step(normals)

        def faulty_current():
            now = current()
            if fault == "unchanged":
                return start
            if fault == "altered":
                last = now["grad"][-1]
                last["b"] = last["b"] + (last["b"] - start["grad"][-1]["b"])
            return now

        return faulty_step, faulty_current

    monkeypatch.setattr(solver, "make_train_step", make_train_step)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["lv_study.adam", "lv_study.bfgs", "hjb100d.m131072"])
def test_a_planted_fault_reads_not_correct(monkeypatch, cell, fault):
    if cell.startswith("lv_study"):
        plant_lv(monkeypatch, fault)
        tiny = LV_TINY
    else:
        plant_hjb(monkeypatch, fault)
        tiny = HJB_TINY
    res, checks = run.run_cell(cell, 2**32 + 17, 0.01, 0, CPU, overrides=tiny)
    assert res["correct"] is False
    assert any(not isinstance(c["value"], float) or c["value"] > c["limit"]
               for c in checks.values())


@pytest.mark.parametrize("cell, fault", [("lv_study.adam", "b2_wrong"),
                                         ("hjb100d.m131072", "b2_wrong"),
                                         ("lv_study.bfgs", "h_skipped")])
def test_a_fault_of_the_stages_arithmetic_reads_not_correct(monkeypatch, cell, fault):
    test_a_planted_fault_reads_not_correct(monkeypatch, cell, fault)


@pytest.mark.parametrize("cell", ["lv_study.adam", "lv_study.bfgs", "hjb100d.m131072"])
def test_the_same_run_unbroken_reads_correct(cell):
    tiny = LV_TINY if cell.startswith("lv_study") else HJB_TINY
    res, _ = run.run_cell(cell, 2**32 + 17, 0.01, 0, CPU, overrides=tiny)
    assert res["correct"] is True

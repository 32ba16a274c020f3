"""Requests of the deep-BSDE trainer on the 100-D HJB.

The program's entry is ``deepbsde.solve_terminal_pde`` on the problem and
nets of ``examples.hjb_100d.hjb_problem``.  A request is one call of
``iters_per_request`` ADAM iterations over ``trajectories`` paths, from the
last call's parameters (a fresh optimizer per call, as the trainer makes
one per call), with no early stop.  Closed loop, one client.  The
benchmark draws every standard normal itself, on the card from the seed,
through the trainer's ``normals=`` seam: request ``r``'s iteration ``i``
draws from its own generator, so the reference draws the same.

Set-up drives the same call through its first ``STEPS`` iterations from
the initial weights; the reference follows them step by step from the
program's own points, building its own moments.  The trainer hands out no
gradient, so its steps' losses and changes are what is compared.
"""
from __future__ import annotations

import itertools
import math
import time

import torch

from perfbench import compare, roofline, seeds
from perfbench.reference import adam as ref_adam
from perfbench.reference import bsde as ref_bsde

STEPS = 3


def initial_params(cfg, seed, device):
    """``{"u0": [...], "grad": [...]}`` Glorot-uniform weights (out, in) and
    zero biases, float32 on ``device``, one draw per layer."""
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))
    params = {}
    for net in ("u0", "grad"):
        widths = cfg[f"{net}_net_widths"]
        layers = []
        for i, o in zip(widths[:-1], widths[1:]):
            lim = math.sqrt(6.0 / (i + o))
            w = (2.0 * torch.rand((o, i), generator=gen, device=device) - 1.0) * lim
            layers.append({"w": w, "b": torch.zeros(o, device=device)})
        params[net] = layers
    return params


class Driver:
    def __init__(self, cfg, traffic, seed, device, tracer):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = device, tracer
        self.m = traffic["trajectories"]
        self.request_no = 0
        self.marks = None  # iteration start times, kept in the window

    def normals(self, request, it):
        shape = (self.m, self.cfg["n_steps"], self.cfg["d"])
        gen = torch.Generator(device=self.device).manual_seed(
            seeds.derive(self.seed, "normals", request, it))
        return torch.randn(shape, generator=gen, device=self.device)

    def _feed(self, stage, it, shape):
        if self.marks is not None:
            self.marks.append(time.perf_counter())
        with self.tracer.span("draw_normals"):
            return self.normals(self.request_no, it)

    def _call(self, params, iters):
        from universal_differential_equations_torch import deepbsde

        with self.tracer.span("solve_terminal_pde"):
            res = deepbsde.solve_terminal_pde(
                self.prob, self.alg, trajectories=self.m, n_steps=self.cfg["n_steps"],
                maxiters=iters, learning_rate=self.cfg["learning_rate"], pabstol=0.0,
                params=params, normals=self._feed)
        self.request_no += 1
        return res, bool(torch.isfinite(res.losses).all()) and len(res.losses) == iters

    def setup(self):
        from universal_differential_equations_torch.examples.hjb_100d import hjb_problem

        self.prob, self.alg = hjb_problem(self.device)
        self.params0 = initial_params(self.cfg, self.seed, self.device)
        self.first_steps()

    def reseed(self):
        """New initial weights and draws from ``self.seed``, the program kept."""
        self.params0 = initial_params(self.cfg, self.seed, self.device)
        self.request_no = 0

    def first_steps(self):
        """Drive the trainer's own call through its first ``STEPS``
        iterations from ``params0``: the calls of 1, …, ``STEPS`` iterations,
        each a fresh trainer on request 0's draws, hand out the points
        ``θ1, …``; record each iteration's loss and change."""
        points = [ref_bsde.leaves(self.params0)]
        for k in range(1, STEPS + 1):
            self.request_no = 0
            res, _ = self._call(self.params0, k)
            points.append(ref_bsde.leaves(res.params))
        self.first = {"loss": res.losses.tolist(), "points": points,
                      "change": _changes(points)}
        self.params = res.params

    def collect(self):
        """The trainer hands out no gradient: nothing to read."""

    def request(self):
        iters = self.traffic["iters_per_request"]
        res, ok = self._call(self.params, iters)
        self.params = res.params
        return len(res.losses), ok

    def traced(self, trace):
        iters = self.traffic["trace_iters"]
        res, ok = self._call(self.params, iters)
        self.params = res.params
        trace.iterations = len(res.losses)
        return ok

    def start_window(self):
        self.marks = []

    def iter_times(self, t_start, t_end):
        """Seconds of each iteration in the window: from one draw to the next,
        the last to the window's end."""
        if not self.marks:
            return None
        edges = self.marks + [t_end]
        return [b - a for a, b in zip(edges[:-1], edges[1:])]

    def work(self):
        flop, byts = roofline.bsde_gemm_per_iter(self.cfg, self.m)
        return {"flop_per_iter": roofline.bsde_flop_per_iter(self.cfg, self.m),
                "gemm_flop_per_iter": flop, "gemm_bytes_per_iter": byts}

    def release(self):
        del self.params, self.prob, self.alg

    # -- the reference ------------------------------------------------------
    def _fg(self, tf32=False, paths=None):
        """The reference's loss and gradient of iteration ``it`` of request 0
        (its draws; their first ``paths`` alone where given)."""
        def fg(theta, it):
            z = self.normals(0, it)
            loss, g = ref_bsde.loss_and_grad(theta, z if paths is None else z[:paths],
                                             self.cfg, tf32=tf32)
            del z
            return float(loss), g
        return _in_turn(fg)

    def reference(self, prog=None):
        """The reference's record of the program's record ``prog`` (by
        default the program's own): ADAM followed step by step along its
        points, on the same draws."""
        prog = self.first if prog is None else prog
        losses, grads, changes = ref_adam.follow(self._fg(), prog["points"],
                                                 self.cfg["learning_rate"])
        return {"loss": losses, "grad": grads[0], "change": changes}

    def stand_in(self, tf32=False, half=False, b2=0.999):
        """A program record made by the reference in the program's place:
        in TF32 (``tf32``), on half of the paths (``half``), or with ADAM's
        ``b2``."""
        fg = self._fg(tf32, self.m // 2 if half else None)
        losses, first, points = ref_adam.run(fg, ref_bsde.leaves(self.params0), STEPS,
                                             self.cfg["learning_rate"], b2=b2)
        return {"loss": losses, "grad": first, "points": points, "change": _changes(points)}

    def fault_kinds(self):
        """The faults of the trainer's own arithmetic, as ``stand_in``'s arguments."""
        return {"b2_wrong": {"b2": 0.9}}

    def readings(self, prog=None, ref=None):
        prog = self.first if prog is None else prog
        return readings(prog, self.reference(prog) if ref is None else ref)


readings = compare.training_readings


def _changes(points):
    return [{k: b[k] - a[k] for k in a} for a, b in zip(points[:-1], points[1:])]


def _in_turn(fg):
    """``fg(theta, it)`` as ``fg(theta)``, ``it`` counting the calls: the
    draws of the iterations in turn."""
    calls = itertools.count()
    return lambda theta: fg(theta, next(calls))

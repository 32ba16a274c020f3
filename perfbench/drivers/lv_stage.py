"""Requests of the Lotka-Volterra noise study's training stages.

The program's entry is ``examples.run_loops.build_stages(lanes="torch")``:
its ``adam_stage`` trains every lane of the study at once, each loss and
gradient evaluation a replay of one CUDA graph that is captured on the
first call for the identity of the ``data`` tensor.  The benchmark makes the
lanes itself from the seed (each lane's noisy series and initial weights)
and keeps one ``data`` tensor for the whole run, so the graph is captured in
set-up and the window only replays it.

A request is one call of the stage on every lane: ``iters_per_request``
ADAM steps or BFGS iterations, from the initial weights where the mix says
``from_initial`` (the study's ADAM stage), else from the last call's
parameters.  Closed loop, one client.

Set-up drives the same call through its first ``STEPS`` steps.  ADAM's are
followed by the reference step by step from the program's own points (the
call with ``k`` steps hands out the ``k``-th); the stage keeps its moments to
itself, so the reference builds its own from the gradients at those points.
BFGS's ``STEPS`` iterations are run by the reference from the program's
start.  The first gradient is read after the window through the program's
``loss_and_grad``, the function whose graph both stages replay.
"""
from __future__ import annotations

import math

import torch

from perfbench import compare, roofline, seeds
from perfbench.reference import adam as ref_adam
from perfbench.reference import bfgs as ref_bfgs
from perfbench.reference import lv as ref_lv

STEPS = 3


def lane_inputs(cfg, traffic, seed, device):
    """``(data (L, S, 2), theta0 (L, P))`` float32 on ``device``: the truth
    noised per lane at the lane's noise level (levels in blocks of
    ``runs_per_level`` lanes), and Glorot-uniform initial weights with zero
    biases in the flat layout of :func:`perfbench.reference.lv.layout`.

    Drawn from ``seed``; where the mix fixes a ``lane_set_seed``, drawn from
    that and put in an order drawn from ``seed``: a mix whose work depends on
    the lanes (BFGS's line searches) then does the same work for every seed."""
    levels = cfg["noise_levels"]
    per = cfg["runs_per_level"]
    lanes = per * len(levels)
    X = torch.as_tensor(ref_lv.truth(cfg), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(
        seeds.derive(traffic.get("lane_set_seed", seed), "lanes"))
    mag = torch.tensor(levels, dtype=torch.float32, device=device).repeat_interleave(per)
    noise = torch.randn((lanes,) + tuple(X.shape), generator=gen, device=device)
    data = X + mag[:, None, None] * X.mean(dim=0) * noise
    parts = []
    for _, name, shape in ref_lv.layout(cfg["nn_widths"]):
        if name == "b":
            parts.append(torch.zeros((lanes, shape[0]), device=device))
        else:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            u = torch.rand((lanes,) + shape, generator=gen, device=device)
            parts.append(((2.0 * u - 1.0) * lim).reshape(lanes, -1))
    theta0 = torch.cat(parts, dim=1)
    if "lane_set_seed" in traffic:
        order = torch.randperm(lanes, generator=torch.Generator().manual_seed(
            seeds.derive(seed, "order"))).to(device)
        data, theta0 = data[order], theta0[order]
    return data, theta0


class Driver:
    def __init__(self, cfg, traffic, seed, device, tracer):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = device, tracer
        self.stage = traffic["stage"]

    # -- the program --------------------------------------------------------
    def _call(self, theta, n, stage=None):
        """One call of the stage (or of ``stage``) from ``theta``: ``n`` ADAM
        steps or ``n`` BFGS iterations; returns the parameters, the losses
        per lane and iteration, and whether the reply is sound."""
        stage = self.stage if stage is None else stage
        with self.tracer.span(stage):
            if stage == "adam_stage":
                theta, hist = self.ns.adam_stage(theta, self.data, steps=n,
                                                 lr=self.traffic["lr"])
            elif stage == "bfgs_round":
                theta, _, hist = self.ns.bfgs_round(theta, self.data, maxiters=n)
            else:
                raise ValueError(f"no stage {stage!r}")
            # the reply: waits for the call; a lane that stopped reads +inf
            ok = bool(torch.isfinite(theta).all()) and not bool(torch.isnan(hist).any())
        return theta, hist, ok

    def setup(self):
        from universal_differential_equations_torch.examples import run_loops

        self.ns = run_loops.build_stages(device=self.device, lanes="torch")
        self.data, self.theta0 = lane_inputs(self.cfg, self.traffic, self.seed, self.device)
        self.first_steps()

    def reseed(self):
        """New lanes from ``self.seed`` in the same ``data`` tensor, so the
        captured graph stays the stage's."""
        data, self.theta0 = lane_inputs(self.cfg, self.traffic, self.seed, self.device)
        self.data.copy_(data)

    def first_steps(self):
        """Drive the stage's own call through its first ``STEPS`` steps and
        record them (losses summed over lanes).  ADAM: the calls of 1, …,
        ``STEPS`` steps from ``theta0``, each a fresh stage as every request
        is, hand out the points ``θ1, …``.  BFGS: from ``warm_adam_steps``
        ADAM steps, as in the study, one call of ``STEPS`` iterations."""
        if self.stage == "adam_stage":
            points = [self.theta0]
            for k in range(1, STEPS + 1):
                theta, hist, _ = self._call(self.theta0, k)
                points.append(theta)
            self.first = {"loss": _lane_sums(hist), "points": points}
        else:
            start, _, _ = self._call(self.theta0, self.traffic["warm_adam_steps"],
                                     "adam_stage")
            theta, hist, _ = self._call(start, STEPS)
            self.first = {"loss": _lane_sums(hist), "points": [start, theta],
                          "adam_points": [self.theta0]}
        self.first["change"] = self._changes(self.first["points"])
        self.theta = theta

    def _changes(self, points):
        return [ref_lv.leaves(b - a, self.cfg["nn_widths"])
                for a, b in zip(points[:-1], points[1:])]

    def collect(self):
        """The first gradient, through the program's ``loss_and_grad`` (the
        function that both stages replay as their graph): at the first
        step's point, and for BFGS also at the ADAM warm start's."""
        widths = self.cfg["nn_widths"]
        self.first["grad"] = ref_lv.leaves(
            self.ns.loss_and_grad(self.first["points"][0], self.data)[1], widths)
        if "adam_points" in self.first:
            self.first["adam_grad"] = ref_lv.leaves(
                self.ns.loss_and_grad(self.first["adam_points"][0], self.data)[1], widths)

    def request(self):
        """One request; returns ``(iterations, ok)``: a BFGS request's
        iterations are those of every lane (each lane runs ``n``, or stops)."""
        n = self.traffic["iters_per_request"]
        self.theta, _, ok = self._call(self._request_start(), n)
        return n, ok

    def traced(self, trace):
        n = self.traffic["trace_iters"]
        self.theta, _, ok = self._call(self._request_start(), n)
        trace.iterations = n
        return ok

    def _request_start(self):
        return self.theta0 if self.traffic.get("from_initial") else self.theta

    def work(self):
        return {"flop_per_iter": roofline.lv_flop_per_iter(self.cfg, self.data.shape[0])}

    def release(self):
        del self.ns, self.theta

    # -- the reference ------------------------------------------------------
    def _fg(self, tf32=False, data=None):
        data = self.data if data is None else data
        return lambda theta: ref_lv.loss_and_grad(theta, data, self.cfg, tf32)

    def reference(self, prog=None):
        """The reference's record of the program's record ``prog`` (by
        default the program's own): ADAM followed step by step along its
        points; BFGS run from its start; the warm start's first gradient at
        its point."""
        prog = self.first if prog is None else prog
        lanes_fg, widths = self._fg(), self.cfg["nn_widths"]
        if self.stage == "adam_stage":
            losses, grads, changes = ref_adam.follow(
                _summed(lanes_fg), [{"theta": p} for p in prog["points"]], self.traffic["lr"])
            return {"loss": losses, "grad": ref_lv.leaves(grads[0]["theta"], widths),
                    "change": [ref_lv.leaves(c["theta"], widths) for c in changes]}
        start = prog["points"][0]
        final, records = ref_bfgs.minimize_lanes(lanes_fg, start, STEPS)
        return {"loss": _records_sums(records), "grad": ref_lv.leaves(lanes_fg(start)[1], widths),
                "change": self._changes([start, final]),
                "adam_grad": ref_lv.leaves(lanes_fg(prog["adam_points"][0])[1], widths)}

    def stand_in(self, tf32=False, half=False, b2=0.999, h_skipped=False):
        """A program record made by the reference in the program's place:
        in TF32 (``tf32``), on half of each lane's samples (``half``), with
        ADAM's ``b2``, or with BFGS's inverse Hessian not carried from one
        iteration to the next (``h_skipped``: one iteration per call).  The
        BFGS stand-in starts from the program's warm start."""
        n = self.data.shape[1]
        lanes_fg = self._fg(tf32, self.data[:, : (n + 1) // 2] if half else None)
        widths = self.cfg["nn_widths"]
        if self.stage == "adam_stage":
            losses, first, points = ref_adam.run(_summed(lanes_fg), {"theta": self.theta0},
                                                 STEPS, self.traffic["lr"], b2=b2)
            points = [p["theta"] for p in points]
            return {"loss": losses, "grad": ref_lv.leaves(first["theta"], widths),
                    "points": points, "change": self._changes(points)}
        start = self.first["points"][0]
        if h_skipped:
            final, records = start, [[] for _ in range(start.shape[0])]
            for _ in range(STEPS):
                final, recs = ref_bfgs.minimize_lanes(lanes_fg, final, 1)
                records = [r + s for r, s in zip(records, recs)]
        else:
            final, records = ref_bfgs.minimize_lanes(lanes_fg, start, STEPS)
        return {"loss": _records_sums(records), "grad": ref_lv.leaves(lanes_fg(start)[1], widths),
                "points": [start, final], "change": self._changes([start, final]),
                "adam_grad": ref_lv.leaves(lanes_fg(self.theta0)[1], widths),
                "adam_points": [self.theta0]}

    def fault_kinds(self):
        """The faults of this stage's own arithmetic, as ``stand_in``'s arguments."""
        if self.stage == "adam_stage":
            return {"b2_wrong": {"b2": 0.9}}
        return {"h_skipped": {"h_skipped": True}}

    def readings(self, prog=None, ref=None):
        prog = self.first if prog is None else prog
        return readings(prog, self.reference(prog) if ref is None else ref)


def readings(prog, ref):
    """The training numbers, and for a warm-started stage its start's
    gradient."""
    out = compare.training_readings(prog, ref)
    if "adam_grad" in ref:
        out["adam_grad_gap"] = (compare.worst_leaf_gap(prog["adam_grad"], ref["adam_grad"])
                                if "adam_grad" in prog else math.inf)
    return out


def _summed(lanes_fg):
    """``fg`` over a ``{"theta": …}`` dict, the loss summed over the lanes."""
    def fg(theta):
        loss, g = lanes_fg(theta["theta"])
        return float(loss.double().sum()), {"theta": g}
    return fg


def _lane_sums(hist):
    """Each iteration's loss summed over the lanes; a lane that has stopped
    (+inf) adds nothing."""
    h = hist.detach().double()
    return torch.where(torch.isinf(h), torch.zeros_like(h), h).sum(dim=0).tolist()


def _records_sums(records):
    """:func:`_lane_sums` of the reference's per-lane loss records."""
    hist = torch.tensor([r + [math.inf] * (STEPS - len(r)) for r in records],
                        dtype=torch.float64)
    return _lane_sums(hist)

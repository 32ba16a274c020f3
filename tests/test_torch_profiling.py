"""PyTorch port: the training loops' spans and counters (``utils.profiling``).

With no profiler they record nothing and cost one flag test; under
``torch.profiler`` every span is a ``record_function`` whose record agrees
with the profiler's own event, and the BFGS and deep-BSDE loops record what
their counters say they do.  CPU only, small sizes.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from universal_differential_equations_torch import deepbsde
from universal_differential_equations_torch.examples import hjb_100d
from universal_differential_equations_torch.train import bfgs_minimize_lanes
from universal_differential_equations_torch.utils import profiling

AGREE_NS = 100_000  # a span's record against the profiler's event, at both ends


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof, names):
    """The profiler's host-side events named in ``names``: name -> [(start, end)]."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    def no_read():
        raise AssertionError("the count was computed with no profiler")

    assert profiling.span("a") is profiling.span("b", waits=True)
    with profiling.span("a"):
        with profiling.span("b", waits=True):
            profiling.count("c", torch.tensor(3))
            profiling.count("d", no_read)
    assert profiling.recorded() == {"spans": [], "counts": []}


def test_spans_nest_keep_waits_resolve_counts_and_match_the_profiler():
    with _profiled() as prof:
        # a session's first event on a thread pays ~0.1 ms of the profiler's
        # own set-up inside it; a caller's trace opens with its own events
        with torch.profiler.record_function("session"):
            pass
        for _ in range(3):
            with profiling.span("outer"):
                with profiling.span("inner", waits=True):
                    torch.ones(64).sum()
                    profiling.count("n", torch.tensor(4) + 1)
                with profiling.span("inner"):
                    profiling.count("n", lambda: torch.tensor(2.5))
                profiling.count("k")
    rec = profiling.recorded()
    spans = rec["spans"]
    assert [s[0] for s in spans] == ["outer", "inner", "inner"] * 3
    for i, (name, start, end, parent, waits) in enumerate(spans):
        assert start < end
        if name == "outer":
            assert parent is None and not waits
        else:
            outer = spans[parent]
            assert outer[0] == "outer" and parent == i - 1 - (i % 3 == 2)
            assert outer[1] <= start and end <= outer[2]
            assert waits == (i % 3 == 1)
    assert [(c[0], c[2]) for c in rec["counts"]] == [("n", 5), ("n", 2.5), ("k", 1)] * 3
    assert all(not isinstance(c[2], torch.Tensor) for c in rec["counts"])
    events = _events(prof, {"outer", "inner"})
    for name in ("outer", "inner"):
        mine = sorted((s, e) for n, s, e, _, _ in spans if n == name)
        assert len(mine) == len(events[name])
        for (s, e), (ps, pe) in zip(mine, events[name]):
            assert abs(s - ps) <= AGREE_NS and abs(e - pe) <= AGREE_NS, (name, s - ps, e - pe)


def test_record_is_bounded_and_clear_forgets(monkeypatch):
    monkeypatch.setattr(profiling, "_LIMIT", 8)
    with _profiled():
        with profiling.span("root"):
            for i in range(9):
                with profiling.span(f"leaf{i}"):
                    profiling.count("c", i)
    rec = profiling.recorded()
    # the ninth span found the record full and dropped its older half: the
    # root went, so its children have no parent left to point at
    assert [s[0] for s in rec["spans"]] == [f"leaf{i}" for i in range(3, 9)]
    assert all(s[3] is None for s in rec["spans"])
    assert [c[2] for c in rec["counts"]] == [4, 5, 6, 7, 8]
    profiling.clear()
    assert profiling.recorded() == {"spans": [], "counts": []}
    with _profiled():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
    assert [s[3] for s in profiling.recorded()["spans"]] == [None, 0]


def test_lane_bfgs_counts_its_trials_and_passes():
    """Three lanes of a quadratic whose line searches take different trials:
    ``bfgs.lane_trials`` is every evaluation a lane asked for after its
    first, ``bfgs.evaluations`` the loop's passes (every call of the loss but
    the first, made before the loop)."""
    scale = torch.tensor([[1.0, 10.0], [1.0, 100.0], [0.5, 3.0]], dtype=torch.float64)
    calls = []

    def fun(x):
        calls.append(1)
        return 0.5 * (scale * (x - 1.0) ** 2).sum(-1) + 0.1 * (x**4).sum(-1)

    x0 = torch.tensor([[3.0, -2.0], [0.0, 4.0], [-1.0, 1.0]], dtype=torch.float64)
    with _profiled():
        res = bfgs_minimize_lanes(fun, x0, maxiters=6, initial_stepnorm=0.01)
    counts = profiling.recorded()["counts"]
    total = {}
    for name, _, n in counts:
        total[name] = total.get(name, 0) + n
    assert total["bfgs.lanes"] == 3
    assert total["bfgs.lane_trials"] == int((res.num_evals - 1).sum())
    assert total["bfgs.evaluations"] == len(calls) - 1
    assert len(set(res.num_evals.tolist())) > 1  # lanes that differ, so occupancy < 1
    spans = profiling.recorded()["spans"]
    reads = [s for s in spans if s[0] == "bfgs.read"]
    assert len(reads) == len(calls) and all(s[4] for s in reads)
    for name in ("bfgs.evaluate", "bfgs.search", "bfgs.update"):
        assert sum(s[0] == name for s in spans) == len(calls) - 1
        assert not any(s[4] for s in spans if s[0] == name)


def test_deep_bsde_marks_each_iteration():
    prob, alg = hjb_100d.hjb_problem(torch.device("cpu"))
    with _profiled():
        res = deepbsde.solve_terminal_pde(prob, alg, trajectories=16, n_steps=5, maxiters=3,
                                          pabstol=0.0)
    assert len(res.losses) == 3
    spans = profiling.recorded()["spans"]
    its = [i for i, s in enumerate(spans) if s[0] == "bsde.iteration"]
    assert len(its) == 3
    for name in ("bsde.draw", "bsde.forward", "bsde.backward", "bsde.optimizer", "bsde.read"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == 3, name
        assert all(s[4] == (name == "bsde.read") for s in inner)
    # each sits directly inside its iteration, the step's own spans too
    for s in spans:
        if s[0] != "bsde.iteration":
            assert spans[s[3]][0] == "bsde.iteration"

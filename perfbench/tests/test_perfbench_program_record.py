"""The readers of the program's own spans and counters
(``host_bound_idle_pct.train``, ``lane_occupancy.bfgs``) on a hand-made trace
and record: exact overlap; ``waits`` spans, CUDA graph launches and time
outside every span left out; the record clipped to the window; nothing read
where there is nothing to read.

    python -m pytest perfbench/tests -q -p no:cacheprovider
"""
from types import SimpleNamespace

import pytest

from perfbench import run
from perfbench.trace import Trace
from universal_differential_equations_torch.utils import profiling


def reader(name):
    return run.Cell("lv_study.bfgs").reader(name)


def with_record(monkeypatch, spans=(), counts=()):
    monkeypatch.setattr(profiling, "recorded",
                        lambda: {"spans": list(spans), "counts": list(counts)})


def busy(*iv):
    """A trace over the window (0, 1000) whose device ran in ``iv``."""
    return Trace(device_ops=[("k", s, e) for s, e in iv], window=(0, 1000))


# idle gaps (0, 100), (300, 500), (900, 1000)
TRACE = busy((100, 300), (500, 700), (650, 900))
SPANS = [("a", 50, 950, None, False),
         ("read", 250, 450, 0, True),  # the host waits: idle there is not the host's
         ("c", 460, 480, 0, False)]


def test_host_bound_idle_is_the_exact_overlap_outside_waits(monkeypatch):
    with_record(monkeypatch, SPANS)
    # (50, 100) + (450, 500) + (900, 950): 150 ns of 1000
    assert reader("host_bound_idle_pct.train")(SimpleNamespace(trace=TRACE)) == pytest.approx(15.0)


def test_host_bound_idle_leaves_out_graph_launches(monkeypatch):
    with_record(monkeypatch, SPANS)
    tr = busy((100, 300), (500, 700), (650, 900))
    tr.runtime = [("cudaGraphLaunch", 40, 80, 7), ("cudaLaunchKernel", 80, 95, 8),
                  ("cudaGraphLaunch", 420, 470, 9), ("cudaGraphLaunch", 460, 490, 10)]
    # (80, 100) + (490, 500) + (900, 950)
    assert reader("host_bound_idle_pct.train")(SimpleNamespace(trace=tr)) == pytest.approx(8.0)


def test_host_bound_idle_clips_the_record_to_the_window(monkeypatch):
    with_record(monkeypatch, SPANS + [("before", -500, 20, None, False),
                                      ("after", 2000, 3000, None, False),
                                      ("open", 300, None, None, False),
                                      ("waits_over_the_end", 920, 1500, 0, True)])
    # + (0, 20) from the span that began before the window; (920, 950) now waits
    assert reader("host_bound_idle_pct.train")(SimpleNamespace(trace=TRACE)) == pytest.approx(14.0)


def test_host_bound_idle_reads_nothing_without_device_activity_or_spans(monkeypatch):
    read = reader("host_bound_idle_pct.train")
    with_record(monkeypatch, SPANS)
    assert read(SimpleNamespace(trace=busy())) is None
    assert read(SimpleNamespace(trace=None)) is None
    with_record(monkeypatch, [("after", 2000, 3000, None, False)])
    assert read(SimpleNamespace(trace=TRACE)) is None
    monkeypatch.delattr(profiling, "recorded")  # a program that records nothing
    assert read(SimpleNamespace(trace=TRACE)) is None


def test_lane_occupancy_counts_the_calls_inside_the_window(monkeypatch):
    read = reader("lane_occupancy.bfgs")
    with_record(monkeypatch, counts=[
        ("bfgs.lanes", -5, 4), ("bfgs.evaluations", 2, 1), ("bfgs.lane_trials", 8, 1),
        ("bfgs.lanes", 10, 4), ("bfgs.evaluations", 20, 1), ("bfgs.evaluations", 30, 1),
        ("bfgs.evaluations", 40, 1), ("bfgs.lane_trials", 50, 9),
        ("bfgs.lanes", 60, 2), ("bfgs.evaluations", 70, 1), ("bfgs.lane_trials", 80, 2),
        ("bfgs.lanes", 900, 4), ("bfgs.evaluations", 950, 1), ("bfgs.lane_trials", 1100, 4)])
    # (9 + 2) trials of (3 × 4 + 1 × 2) lane evaluations; the calls cut by the
    # window's edges are left out
    assert read(SimpleNamespace(trace=TRACE)) == pytest.approx(100.0 * 11 / 14)
    with_record(monkeypatch, counts=[("bfgs.lanes", 900, 4)])
    assert read(SimpleNamespace(trace=TRACE)) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(SimpleNamespace(trace=TRACE)) is None

"""The traced slice: spans of the benchmark's own calls and the device trace.

``Tracer.span(name)`` marks a call into one of the program's layers, from the
benchmark's side (``adam_stage``, ``solve_terminal_pde``, ``draw_normals``).
Off, it costs nothing; on, it is a ``torch.profiler.record_function``, so
the span lands in the same trace as the device's work.  ``Tracer.slice``
profiles one bounded piece of steady work and reduces the trace in memory:
no trace file is written.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

WINDOW = "traced_window"


@dataclass
class Trace:
    """What one traced slice holds, in nanoseconds on the profiler's clock.

    ``kernels``: (name, start, end, correlation) of each CUDA kernel;
    ``device_ops``: (name, start, end) of every device activity (kernels,
    copies, sets); ``runtime``: (name, start, end, correlation) of the CUDA
    runtime calls; ``spans``: (name, start, end) of the benchmark's spans;
    ``window``: (start, end) of the slice, synchronised at both ends;
    ``iterations``: optimizer iterations the slice ran.
    """

    kernels: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    window: tuple = (0, 0)
    iterations: int = 0

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self):
        """The union of the device activities' intervals, clipped to the window."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops if e > lo and s < hi)
        out = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self):
        """(start, end) of each stretch of the window in which no device
        activity ran."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def graph_launches(self):
        """Correlation ids of the CUDA graph replays in the slice."""
        return {c for n, _, _, c in self.runtime if n.startswith("cudaGraphLaunch")}

    def host_span_at(self, t):
        """The innermost benchmark span open on the host at time ``t``."""
        best = None
        for name, s, e in self.spans:
            if s <= t < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "between_spans"

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time by
        the span the host was in, each summed by name, in seconds."""
        ops = {}
        for name, s, e in self.device_ops:
            ops[name] = ops.get(name, 0) + (e - s)
        gaps = {}
        for s, e in self.idle_gaps():
            name = self.host_span_at((s + e) // 2)
            gaps[name] = gaps.get(name, 0) + (e - s)
        rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


class Tracer:
    """Spans around the benchmark's calls into the program, and the
    profiler around a slice, when ``on``."""

    def __init__(self, on):
        self.on = on
        self.names = set()

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        self.names.add(name)
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def slice(self, device):
        """Profile the body; yields the ``Trace``, filled when the body ends
        (the body sets ``iterations``).  The window is a span of its own,
        synchronised with the device at both ends."""
        from torch.profiler import ProfilerActivity, profile

        trace = Trace()
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                _sync(device)
                yield trace
                _sync(device)
        _fill(trace, prof, self.names)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def _fill(trace, prof, names):
    """Move the profiler's events into ``trace``, all on the profiler's
    clock.  A kernel replayed from a CUDA graph carries the correlation id
    of its ``cudaGraphLaunch``; one launched alone, that of its launch.
    Spans other than the benchmark's own (``names``) are left out, and so
    are the device-side copies of every span."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.is_user_annotation():
            if e.device_type() == cuda:
                continue
            if name == WINDOW:
                trace.window = (s, end)
            elif name in names:
                trace.spans.append((name, s, end))
        elif e.device_type() == cuda:
            trace.device_ops.append((name, s, end))
            if _is_kernel(name):
                trace.kernels.append((name, s, end, e.correlation_id()))
        elif name.startswith("cuda"):
            trace.runtime.append((name, s, end, e.correlation_id()))

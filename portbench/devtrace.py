"""The device trace of a traced run: one ``torch.profiler`` slice of the
window, reduced to device intervals, the batch each kernel served, the
device's busy time, and the breakdown of device time and idle gaps.

The slice is bounded (``profile_s`` of the workload file) so that the
trace stays small.  A ``portbench.slice`` range, opened on the thread
that runs the profiler, marks its bounds on the profiler's clock and
ties that clock to ``time.perf_counter``: the profiler records ranges of
its own thread only, so the batches' host times
(``port.RecordingBackend``) are mapped onto the trace by that offset.
A kernel that starts inside batch i's execute interval served batch i.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time

import torch


def warm(device) -> None:
    """Start and stop the profiler once, so that the slice inside the
    window does not pay its first initialization."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        (torch.ones(8, device=device) + 1).sum().item()


class SliceThread(threading.Thread):
    """Profiles ``[t_a, t_a + length)`` (perf_counter seconds) from a
    thread of its own, so that the request loop is not held up.  The
    profiler is stopped only once ``release`` is set: its stop collects
    the trace while holding the interpreter, and is left until no other
    thread issues device work."""

    def __init__(self, device, t_a: float, length: float):
        super().__init__(name="portbench-profile", daemon=True)
        self.device, self.t_a, self.length = device, t_a, length
        self.prof = None
        self.mark = 0.0             # perf_counter as the slice range opened
        self.error = None
        self.release = threading.Event()

    def run(self):
        try:
            time.sleep(max(0.0, self.t_a - time.perf_counter()))
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            with torch.profiler.record_function("portbench.slice"):
                self.mark = time.perf_counter()
                time.sleep(self.length)
            self.release.wait(timeout=600.0)
            prof.stop()
            self.prof = prof
        except Exception as e:      # noqa: BLE001 -- reported by the run
            self.error = e


def _short(name: str) -> str:
    """A device op's name without its argument list ("void" and an
    anonymous namespace dropped)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()


@dataclasses.dataclass
class Trace:
    a_ns: int
    b_ns: int
    device: list      # (name, start_ns, end_ns), in the slice, by start
    predicts: list    # (start_ns, end_ns, batch)
    executes: list    # (start_ns, end_ns, batch), by start
    busy_ns: int

    @property
    def window_s(self) -> float:
        return (self.b_ns - self.a_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def batch_at(self, t_ns: int) -> int:
        """The batch whose execute range holds ``t_ns``, else -1."""
        starts = [e[0] for e in self.executes]
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and self.executes[i][0] <= t_ns <= self.executes[i][1]:
            return self.executes[i][2]
        return -1

    def kernels(self, part: str) -> list:
        """(duration ns, batch) of each device op whose name holds
        ``part``."""
        return [(e - s, self.batch_at(s)) for n, s, e in self.device
                if part in n]

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def _host_at(self, t_ns: int) -> str:
        open_ = [kind for kind, ranges in (("predict", self.predicts),
                                           ("execute", self.executes))
                 if any(s <= t_ns <= e for s, e, _ in ranges)]
        return "+".join(open_) if open_ else "no batch on host"

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps with no device op, named by the host ranges
        open at their middle."""
        gaps, t = [], self.a_ns
        for _, s, e in self.device:
            if s > t:
                gaps.append((s - t, t))
            t = max(t, e)
        if self.b_ns > t:
            gaps.append((self.b_ns - t, t))
        gaps.sort(reverse=True)
        return [[f"idle: {self._host_at(t0 + g // 2)}", g / 1e9]
                for g, t0 in gaps[:n]]


def reduce(slicer: SliceThread, predicts: list,
           executes: list) -> Trace | None:
    """The slice's device intervals and the batches' host intervals on
    the profiler's clock (``predicts`` / ``executes``: per batch its
    perf_counter (t0, t1, ...)), or None without a slice marker."""
    events = slicer.prof.profiler.kineto_results.events()
    marks = [e for e in events if e.name() == "portbench.slice"]
    if not marks:
        return None
    a = marks[0].start_ns()
    b = a + marks[0].duration_ns()
    offset = a - int(slicer.mark * 1e9)

    def on_trace(rows):
        return [(int(r[0] * 1e9) + offset, int(r[1] * 1e9) + offset, i)
                for i, r in enumerate(rows)]

    pre, exe = on_trace(predicts), on_trace(executes)
    dev = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s, d = e.start_ns(), e.duration_ns()
            lo, hi = max(s, a), min(s + d, b)
            if hi > lo:
                dev.append((_short(e.name()), lo, hi))
    dev.sort(key=lambda x: x[1])
    busy, t = 0, a
    for _, s, e in dev:
        if e > t:
            busy += e - max(s, t)
            t = e
    return Trace(a, b, dev, pre, exe, busy)

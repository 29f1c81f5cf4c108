"""What a traced run keeps of ``torch.profiler``: the device's operations
with their times, the host's kernel launches, and the benchmark's spans
placed on the profiler's clock. Nothing is written to disk.

The profiler records the host's CUDA calls from every thread and the
device's operations, on one clock (microseconds). It does not record
PyTorch operators on threads it was not started on, and the port runs its
work on worker threads. Recording every thread's operators crashed a traced
chat run, and so did a profiler stopped on the event loop's thread while
the decode worker launched (two of eight). So in the chat cells the worker
starts and stops the profiler between its chunks (:class:`Tracer`).

The two clocks are tied by one anchor: right after the profiler starts, the
thread that started it makes one call whose host time it notes (:func:`anchor`:
an event synchronisation on the card, a labelled range on the CPU). Each
span of the benchmark (``stack.py``) is then placed on the profiler's clock
by its own start and end, and the kernels launched inside it are counted on
the anchor's thread. A record without its anchor raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time

ANCHOR = ("cudaEventSynchronize", "portbench.anchor")
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def anchor(device) -> float:
    """Make the anchor call on this thread; returns its host time. On the
    card the event is recorded on a stream of its own, so that waiting for
    it waits for no queued work."""
    import torch

    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.Stream(device))
        t = time.perf_counter()
        ev.synchronize()
        return t
    t = time.perf_counter()
    with torch.profiler.record_function(ANCHOR[1]):
        pass
    return t


@dataclasses.dataclass
class Op:
    name: str
    start: float
    end: float
    launches: int = 0  # kernels the range's thread launched inside it


@dataclasses.dataclass
class Profile:
    window_us: float  # the traced window's length
    start_us: float  # its start on the profiler's clock
    device: list[Op]  # kernels, copies and sets on the device, by start
    ranges: list[Op]  # the benchmark's spans, placed on this clock (:meth:`place`)
    anchor_us: float = 0.0  # the anchor call, on this clock
    anchor_host: float = 0.0  # and on the host's (``time.perf_counter`` seconds)
    anchor_thread: int | None = None
    launch_calls: list = dataclasses.field(default_factory=list)  # (start, thread)

    def place(self, name: str, t0: float, t1: float) -> Op:
        """The host span ``[t0, t1]`` on this clock, with the kernels the
        anchor's thread launched inside it."""
        s = self.anchor_us + (t0 - self.anchor_host) * 1e6
        e = self.anchor_us + (t1 - self.anchor_host) * 1e6
        n = sum(1 for at, th in self.launch_calls if th == self.anchor_thread and s <= at <= e)
        return Op(name, s, e, n)

    @property
    def busy_us(self) -> float:
        """Time in which some operation ran on the device (their union)."""
        busy, end = 0.0, None
        for op in self.device:
            s, e = max(op.start, self.start_us), min(op.end, self.start_us + self.window_us)
            if e <= s:
                continue
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def kernels_in(self, rng: Op, match) -> list[Op]:
        """Device operations that start inside ``rng`` and whose name
        ``match`` accepts."""
        return [op for op in self.device if rng.start <= op.start <= rng.end and match(op.name)]

    def device_ops(self, top: int = 10) -> list[list]:
        """The ``top`` device operations by total seconds."""
        total: dict[str, float] = {}
        for op in self.device:
            total[op.name] = total.get(op.name, 0.0) + (op.end - op.start)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], us / 1e6] for name, us in ranked]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The ``top`` longest stretches with nothing on the device, each
        named by the innermost range the host was in at its middle, else
        ``host outside the benchmark's ranges``."""
        gaps, end = [], self.start_us
        for op in self.device:
            if op.start > end:
                gaps.append((end, op.start))
            end = max(end, op.end)
        stop = self.start_us + self.window_us
        if stop > end:
            gaps.append((end, stop))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:top]:
            mid = (s + e) / 2
            inside = [r for r in self.ranges if r.start <= mid <= r.end]
            name = (min(inside, key=lambda r: r.end - r.start).name if inside
                    else "host outside the benchmark's ranges")
            out.append([name, (e - s) / 1e6])
        return out


class Tracer:
    """Starts the profiler at ``start_at`` and stops it at ``stop_at`` (host
    clock) from whichever thread calls :meth:`poll` past those times, and
    makes the anchor call (``mark``) right after starting it. Where one
    worker thread launches nearly all the work, it polls between its chunks,
    so the profiler never starts or stops under its CUDA calls: stopping it
    from another thread crashed two traced chat runs in eight."""

    def __init__(self, make, start_at: float, stop_at: float, sync, mark):
        self.make, self.start_at, self.stop_at = make, start_at, stop_at
        self.sync, self.mark = sync, mark
        self.prof = self.t0 = self.span = self.anchor = None
        self.done = threading.Event()

    def poll(self) -> None:
        if self.done.is_set():
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.start_at:
            self.prof = self.make()
            self.t0 = time.perf_counter()
            self.prof.start()
            self.anchor = self.mark()
        elif self.prof is not None and now >= self.stop_at:
            self.sync()
            t1 = time.perf_counter()
            self.prof.stop()  # collecting the events takes a while: not part of the window
            self.span = (self.t0, t1)
            self.done.set()


def from_profiler(prof, span: tuple[float, float], anchor_host: float) -> Profile:
    """A :class:`Profile` of a stopped ``torch.profiler.profile`` that ran
    over ``span`` by the host's clock, its anchor call made at
    ``anchor_host``."""
    import torch

    device, launches, anchors = [], [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(Op(e.name, s, t))
        elif e.name in LAUNCH:
            launches.append((s, e.thread))
        elif e.name in ANCHOR:
            anchors.append((s, e.thread))
    if not anchors:
        raise RuntimeError("the profiler recorded no anchor call: its clock cannot be placed")
    anchor_us, thread = min(anchors)
    device.sort(key=lambda op: op.start)
    p = Profile(window_us=1e6 * (span[1] - span[0]), start_us=0.0, device=device, ranges=[],
                anchor_us=anchor_us, anchor_host=anchor_host, anchor_thread=thread,
                launch_calls=launches)
    p.start_us = p.place("", span[0], span[0]).start
    return p

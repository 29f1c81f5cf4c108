"""The profiler's record read back: the benchmark's spans placed on the
profiler's clock by the anchor call, and the kernels launched inside them."""

import types

import pytest
import torch

from portbench.devtrace import Op, Profile, from_profiler
from portbench.window import chunks


def _event(name, start, end, thread=7, cuda=False):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 thread=thread, device_type=kind)


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


def test_spans_are_placed_by_the_anchor_and_count_the_anchor_threads_launches():
    w, other = 7, 9
    prof = _prof([
        _event("cudaLaunchKernel", 100, 101, w),  # before the span
        _event("cudaEventSynchronize", 1000, 1002, w),  # the anchor, at host time 10.0
        _event("cudaLaunchKernel", 1500, 1501, w), _event("cuLaunchKernelEx", 2500, 2501, w),
        _event("cudaLaunchKernel", 1600, 1601, other),  # another thread's launch
        _event("cudaEventSynchronize", 3000, 3001, other),  # a later one is no anchor
        _event("cudaLaunchKernel", 9000, 9001, w),  # after the span
        _event("paged_kernel", 1700, 1800, cuda=True),
    ])
    p = from_profiler(prof, (9.9995, 10.0045), 10.0)
    assert (p.anchor_us, p.anchor_thread) == (1000, w)
    assert p.start_us == pytest.approx(500) and p.window_us == pytest.approx(5000)
    got = p.place("decode_chunk", 10.0004, 10.0016)
    assert (got.start, got.end, got.launches) == (pytest.approx(1400), pytest.approx(2600), 2)
    assert [op.name for op in p.kernels_in(got, lambda n: True)] == ["paged_kernel"]


def test_a_record_without_its_anchor_raises():
    with pytest.raises(RuntimeError, match="anchor"):
        from_profiler(_prof([_event("cudaLaunchKernel", 1, 2)]), (0.0, 1.0), 0.0)


def test_busy_time_is_the_union_of_device_operations_in_the_window():
    p = Profile(window_us=100.0, start_us=0.0, ranges=[Op("decode_chunk", 0, 50)],
                device=[Op("a", 0, 10), Op("b", 5, 20), Op("c", 30, 40), Op("d", 95, 130)])
    assert p.busy_us == 20 + 10 + 5
    gaps = p.idle_gaps(2)
    assert gaps[0] == ["host outside the benchmark's ranges", 55e-6]
    assert gaps[1] == ["decode_chunk", 10e-6]
    assert p.device_ops(1) == [["d", 35e-6]]


def test_chunks_are_the_spans_wholly_inside_the_sub_window():
    spans = [(10.0 + i, 10.0 + i + 0.3, {"i": i}) for i in range(5)]
    rec = types.SimpleNamespace(spans={"decode_chunk": spans})
    profile = Profile(4e6, 0.0, [], [], anchor_us=50.0, anchor_host=10.9)
    run = types.SimpleNamespace(profile=profile, rec=rec, traced=(10.9, 13.2))
    got = chunks(run, "decode_chunk")
    assert [f["i"] for _, f in got] == [1, 2]  # the 4th ends past the sub-window
    assert got[0][0].start == pytest.approx(50.0 + 0.1e6)
    assert got[0][0].end == pytest.approx(50.0 + 0.4e6)

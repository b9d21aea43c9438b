"""The harness and the program's own tracing: the program's ranges
(``tpu3d:``) change neither the device rows' busy time nor the launches,
name the idle they hold when the idle is split by range, and attribute
device time to the stage that launched it; the ``program_counter``
readers read the program's counters per request."""

import types

import pytest
import torch

from portbench.harness import layers, profile, program_counters, spec
from portbench.harness.profile import Slice, _idle_by_host

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def test_idle_is_named_by_the_innermost_range_on_either_thread():
    """A ``pb:`` label holding nested program spans on two threads: each
    idle piece goes to the innermost range open over it, and the totals
    are those of the label alone."""
    busy = [[10.0, 20.0], [60.0, 70.0]]
    label = [(0.0, 100.0, "prepare.features")]
    program = [
        (5.0, 95.0, "prepare.features"),  # main thread, inside the label
        (25.0, 45.0, "prepare.neighbors"),
        (30.0, 35.0, "prepare.read.count"),
        (40.0, 80.0, "pipeline.prepare_instance"),  # a pool thread
    ]
    without = _idle_by_host(busy, 0.0, 100.0, label)
    with_ = _idle_by_host(busy, 0.0, 100.0, label + program)
    assert without == {"prepare.features": pytest.approx(80e-6)}
    assert sum(with_.values()) == pytest.approx(sum(without.values()))
    assert with_ == {
        "prepare.features": pytest.approx((5 + 5 + 5 + 15 + 5) * 1e-6),
        "prepare.neighbors": pytest.approx((5 + 5 + 5) * 1e-6),
        "prepare.read.count": pytest.approx(5e-6),
        "pipeline.prepare_instance": pytest.approx((15 + 10) * 1e-6),
    }
    staged = layers.idle_by_stage(
        busy, 0.0, 100.0, [(s, e, n, 1) for s, e, n in label + program])
    assert staged == with_
    assert layers.by_layer(staged) == {
        "prepare": pytest.approx(55e-6), "pipeline": pytest.approx(25e-6)}


def _event(name, device, start, end, user=False, ident=0, thread=1):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=user, id=ident,
        thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end))


def _events(program: bool):
    """A slice of two kernels, a copy and their launches; with
    ``program``, the program's ranges on the host and the device's user
    annotation rows that mirror them."""
    ev = [
        _event("pb:slice", CPU, 0.0, 100.0),
        _event("cudaLaunchKernel", CPU, 2.0, 3.0, ident=7),
        _event("nn_desc_kernel", CUDA, 10.0, 20.0, ident=7),
        _event("cudaLaunchKernel", CPU, 31.0, 32.0, ident=9),
        _event("score_tc_kernel", CUDA, 40.0, 55.0, ident=9),
        _event("cudaMemcpyAsync", CPU, 60.0, 61.0, ident=11),
        _event("Memcpy DtoH (Device -> Pinned)", CUDA, 62.0, 63.0,
               ident=11),
    ]
    if program:
        ev += [
            _event("tpu3d:ransac", CPU, 1.0, 90.0, user=True),
            _event("tpu3d:ransac.correspondences", CPU, 1.5, 30.0,
                   user=True),
            _event("tpu3d:ransac.chunk", CPU, 30.5, 70.0, user=True),
            _event("tpu3d:ransac.read.exit_flag", CPU, 59.0, 64.0,
                   user=True),
            _event("tpu3d:ransac", CUDA, 10.0, 63.0, user=True),
            _event("tpu3d:ransac.chunk", CUDA, 40.0, 63.0, user=True),
        ]
    return ev


class _FakeProfile:
    def __init__(self, events):
        self._events = events

    def __call__(self, *a, **k):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events


def _slice(monkeypatch, events):
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile(events))
    return profile.profiled_slice(lambda k: None, 2, [],
                                  types.SimpleNamespace(), lambda: None)


def test_program_ranges_change_no_device_reading(monkeypatch):
    """User annotations (the program's ranges, on the host and mirrored on
    the device's rows) leave busy time, launches, kernel time and the
    idle by label as the device rows alone give them."""
    plain = _slice(monkeypatch, _events(False))
    traced = _slice(monkeypatch, _events(True))
    assert plain.busy_s == pytest.approx(26e-6)
    assert plain.launches == 2
    for field in ("window_s", "busy_s", "launches", "kernel_s",
                  "device_ops", "idle_gaps"):
        assert getattr(traced, field) == getattr(plain, field), field


def test_device_time_goes_to_the_launching_stage():
    ev = layers.read_events(_events(True), 0.0, 100.0)
    assert [o[0] for o in ev["device_ops"]] == [7, 9, 11]
    device = layers.device_by_stage(ev["device_ops"], ev["launches"],
                                    ev["program"])
    assert device == {
        "ransac.correspondences": pytest.approx(10e-6),
        "ransac.chunk": pytest.approx(15e-6),
        "ransac.read.exit_flag": pytest.approx(1e-6),
    }
    assert layers.by_layer(device) == {"ransac": pytest.approx(26e-6)}
    # A launch on a thread with no open span, or none found: 'outside'.
    assert layers.device_by_stage([(5, 0.0, 2.0), (7, 10.0, 20.0)],
                                  {7: (2, 2.5)}, ev["program"]) == {
        "outside": pytest.approx(12e-6)}


def _data(requests=4):
    sl = Slice(requests=requests, window_s=1.0, busy_s=0.1, launches=10,
               kernel_s={}, least_s={}, device_ops=[], idle_gaps=[])
    return {"spans": [], "requests": 100, "slice": sl}


COUNTS = {
    "ransac.hypotheses": 400000, "ransac.runs.chunked.rotation": 3,
    "ransac.runs.chunked.gather": 1, "ransac.early_exits": 1,
    "ransac.graph_captures": 0, "icp.iterations": 28,
    "registration.escalations": 2, "host.reads": 150,
    "launches.score_hypotheses": 99,
}
READINGS = {
    "ransac.hypotheses_per_request": 100000.0,
    "ransac.early_exit_share": 25.0,
    "ransac.graph_captures_per_request": 0.0,
    "icp.iterations_per_request": 7.0,
    "registration.escalations_per_request": 0.5,
    "host.reads_per_request": 37.5,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_counter_readers(monkeypatch, name):
    read = spec.reader(name)
    monkeypatch.setattr(program_counters, "program_counters",
                        lambda: dict(COUNTS))
    assert read(_data()) == pytest.approx(READINGS[name])
    # A program without the tracer: nothing to read.
    monkeypatch.setattr(program_counters, "program_counters", lambda: None)
    assert read(_data()) is None
    # Nothing counted: a count reads 0; a share has no base (no chunked
    # run) and reads None, as does a count over no request.
    monkeypatch.setattr(program_counters, "program_counters", lambda: {})
    if name == "ransac.early_exit_share":
        assert read(_data()) is None
    else:
        assert read(_data()) == 0.0
        assert read(_data(requests=0)) is None


def test_program_counters_are_the_programs():
    from tpu3d_torch.utils import profiling

    assert program_counters.program_counters() == profiling.counters()

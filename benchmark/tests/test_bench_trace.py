"""The trace readers on a made-up profile and made-up requests: the
profiler's marks are not device operations, idle gaps are split by the
sections open over them, and each per-layer reader returns nothing where
it has nothing to read."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.core import roofline, spec
from benchmark.core.runner import Done, RunData
from benchmark.core.trace import REQUEST, SECTION, read_profile

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, dev):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


class FakeProf:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


EVENTS = [
    _ev(REQUEST, 0, 100, CPU), _ev(SECTION + "decode", 10, 40, CPU),
    _ev(SECTION + "msm", 50, 90, CPU),
    _ev(SECTION + "decode", 10, 40, CUDA),      # the mark on the device row
    _ev("void (anonymous namespace)::pow_fixed_kernel(Fp const*)", 12, 20,
        CUDA),
    _ev("void at::native::elementwise_kernel<4>(int)", 30, 35, CUDA),
    _ev("Memcpy DtoH (Device -> Pinned)", 60, 62, CUDA),
    _ev("windowed_combine_kernel(Fp const*)", 85, 88, CUDA),
]


def test_read_profile_splits_gaps_by_section():
    p = read_profile(FakeProf(EVENTS), 1)
    assert p["launches"] == 3
    assert p["busy_s"] == pytest.approx(18e-6)
    assert p["window_s"] == pytest.approx(100e-6)
    gaps = dict(p["breakdown"]["idle_gaps"])
    assert gaps["host_rest"] == pytest.approx(10e-6)
    assert gaps["decode"] == pytest.approx(2e-6)
    assert gaps["decode after pow_fixed_kernel"] == pytest.approx(10e-6)
    assert gaps["decode after at::native::elementwise_kernel"] == \
        pytest.approx(5e-6)
    assert gaps["host_rest after at::native::elementwise_kernel"] == \
        pytest.approx(10e-6)
    assert gaps["msm after Memcpy DtoH"] == pytest.approx(23e-6)
    assert sum(gaps.values()) == pytest.approx(82e-6)
    ops = dict(p["breakdown"]["device_ops"])
    assert SECTION + "decode" not in ops and "pow_fixed_kernel" in ops


def test_read_profile_without_device_activity_is_nothing():
    assert read_profile(FakeProf(EVENTS[:3]), 1) is None


def _data(traced, profile=None):
    work = roofline.prove_work(4)
    done = [Done(0, 0.0, 0.05, True, None, 1, work, {},
                 {"decode": 10.0, "msm": 20.0}),
            Done(1, 0.05, 0.09, True, None, 1, work, {},
                 {"decode": 8.0, "msm": 22.0}, profiled=True)]
    return RunData(done, 0.09, 3.0, traced, profile)


@pytest.mark.parametrize("name,want", [
    ("host_rest_ms", 20.0), ("decode_ms", 10.0), ("msm_ms", 20.0)])
def test_section_readers(name, want):
    reader = spec.metric_reader(spec.BENCH_DIR, name + ".prove")
    assert reader.read(_data(True)) == pytest.approx(want)
    assert reader.read(_data(False)) is None


def test_device_readers_need_a_profile():
    profile = {"requests": 1, "launches": 900, "device_s": 0.01,
               "busy_s": 0.01, "window_s": 0.04}
    read = lambda n, d: spec.metric_reader(spec.BENCH_DIR, n).read(d)
    for name in ("launches_per_request", "kernel_roofline_share",
                 "device_idle_share"):
        assert read(name, _data(True)) is None
    d = _data(True, profile)
    assert read("launches_per_request", d) == 900
    assert read("device_idle_share", d) == pytest.approx(80.0)
    share = read("kernel_roofline_share", d)
    assert 0 < share == pytest.approx(
        100 * roofline.bound_seconds(roofline.prove_work(4)) / 0.01)

"""Rates over the whole window, the tail over every frame, the idle share
and the roofline shares on a recorded trace."""

import pytest

from splatbench import readings, roofline, trace
from splatbench.generators.view import p95
from splatbench.run import layer_reader


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# a traced window of 1000 us: kernels busy over [100, 300] and [250, 400]
# (overlapping streams) and [700, 900]; host spans name the gaps
EVENTS = [
    _ev(trace.WINDOW, "user_annotation", 0, 1000),
    _ev("splatbench.frame", "user_annotation", 0, 500),
    _ev("splatbench.frame", "user_annotation", 500, 500),
    _ev("cudaGraphLaunch", "cuda_runtime", 450, 200),
    _ev("tile_fwd_kernel(float const*)", "kernel", 100, 200),
    _ev("other_kernel", "kernel", 250, 150),
    _ev("tile_fwd_kernel(float const*)", "kernel", 700, 200),
    _ev("outside_kernel", "kernel", 1200, 100),
]


def test_trace_union_gaps_and_names():
    s = trace.summarise(EVENTS)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(500e-6)  # [100,400] and [700,900]
    assert trace.device_seconds(s, "tile_fwd_kernel") == pytest.approx(4e-4)
    assert "outside_kernel" not in s.by_name
    assert s.top_ops[0][0].startswith("tile_fwd_kernel")
    # gaps: [400,700] 300 us (mid 550: cudaGraphLaunch, the innermost),
    # [0,100] and [900,1000]
    assert s.idle_gaps[0] == ["cudaGraphLaunch", pytest.approx(300e-6)]
    assert {g[0] for g in s.idle_gaps[1:]} == {"splatbench.frame"}
    assert trace.summarise(EVENTS[1:]) is None  # no window span


def test_idle_share_reader():
    s = trace.summarise(EVENTS)
    rec = {"kind": "view"}
    assert layer_reader("device_idle.view")(rec, s) == pytest.approx(50.0)
    assert layer_reader("device_idle.train")(rec, s) is None
    assert layer_reader("device_idle.view")(rec, None) is None


def test_kernel_roofline_share():
    counts = {"instances": 1000, "binned": 100, "blended": 5000,
              "stopped": 64, "walked": 9000}
    rec = {"kind": "view", "width": 16, "height": 16, "traced_frames": 2,
           "counts": [counts, dict(counts, instances=3000)]}
    s = trace.summarise(EVENTS)
    mean = dict(counts, instances=2000)
    nbytes = 4 * 2000 + 36 * 100 + 12 * 256
    ops = 24 * 5000 + 17 * 64
    assert roofline.k2_work(mean, 256) == (nbytes, ops)
    least = max(nbytes / 3.35e12, ops / 67e12)
    share = layer_reader("k2_roofline.view")(rec, s)
    assert share == pytest.approx(100 * least / (4e-4 / 2))
    assert layer_reader("k2_roofline.view")(dict(rec, counts=[]), s) is None


def test_whole_work_shares_count_every_part():
    c = {"instances": 10, "binned": 4, "blended": 100, "stopped": 8}
    b2, o2 = roofline.k2_work(c, 64)
    bf, of = roofline.frame_work(c, 64, [1, 0, 0, 3])
    assert of == o2 and bf == b2 + 4 * (11 * 4 + 3 * 1 + 48 * 3)
    bs, os_ = roofline.step_work(c, 64, [1, 0, 0, 3])
    b3, o3 = roofline.k3_work(c, 64)
    assert bs == bf + b3 + 12 * 64 + 4 * 59 * 4 * 8
    assert os_ == of + o3 + 3 * roofline.SSIM_OPS_PER_PIXEL * 64 + 12 * 59 * 4
    rec = {"kind": "train", "width": 8, "height": 8, "window_s": 2.0,
           "iterations": 4, "degree_counts": [1, 0, 0, 3], "counts": [c]}
    share = layer_reader("step_mfu.train")(rec, None)
    assert share == pytest.approx(
        100 * roofline.least_seconds(bs, os_) / 0.5)


def test_train_spans_add_up_to_the_window():
    spans = [("group", 0.0, 9.9, 99), ("step", 9.9, 10.2, 1),
             ("group", 10.2, 20.1, 99)]
    rec = {"kind": "train", "spans": spans, "iterations": 199}
    group = layer_reader("group_ms_per_iter.train")(rec, None)
    surgery = layer_reader("surgery_ms_per_iter.train")(rec, None)
    assert group == pytest.approx(1e3 * 19.8 / 199)
    assert surgery == pytest.approx(1e3 * 0.3 / 199)
    assert group + surgery == pytest.approx(1e3 * 20.1 / 199)


def test_p95_is_of_every_frame():
    lat = [1.0] * 95 + [9.0] * 5
    assert p95(lat) == 1.0
    assert p95(lat + [9.0]) == 9.0
    assert p95(list(range(1, 21))) == 19
    assert p95([4.0]) == 4.0


def test_readings_mean_counts():
    rec = {"counts": [{"a": 1, "b": 4}, {"a": 3, "b": 8}]}
    assert readings.mean_counts(rec) == {"a": 2, "b": 6}
    assert readings.mean_counts({}) is None

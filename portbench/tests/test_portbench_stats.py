"""The metric arithmetic on made-up numbers."""
from __future__ import annotations

import dataclasses

import pytest

from portbench import spec, stats
from portbench.drivers import Window
from portbench.trace import Event, Trace, idle_gaps, kernel_time_us


def test_rate_is_the_items_over_the_whole_window():
    assert stats.rate(50, 2.0, 4.5) == pytest.approx(20.0)
    with pytest.raises(ValueError):
        stats.rate(3, 4.0, 4.0)


def test_p95_is_over_all_frames():
    lat = list(range(1, 101))            # 1..100
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    # not a median of chunks: one slow frame in a hundred moves p95 little,
    # five move it to their level
    assert stats.percentile([10.0] * 95 + [100.0] * 5, 95) == \
        pytest.approx(14.5)


def test_per_item_ms_is_the_window_over_its_items():
    assert stats.per_item_ms(2.0, 4.5, 50) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        stats.per_item_ms(0.0, 1.0, 0)


def test_union_with_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 12)]
    assert stats.union_length(iv, 0, 10) == pytest.approx(3 + 1 + 2)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.union_length([], 0, 10) == 0.0


def test_idle_share_from_a_made_up_trace():
    dev = [Event("kernel", "k", 10.0, 20.0, ()),
           Event("kernel", "k", 20.0, 20.0, ()),          # overlaps
           Event("gpu_memcpy", "Memcpy DtoH", 60.0, 10.0, ())]
    host = [Event("user_annotation", "portbench.window", 0.0, 100.0, ()),
            Event("cpu_op", "aten::item", 40.0, 15.0, ())]
    tr = Trace(dev, host)
    assert tr.window("portbench.window") == (0.0, 100.0)
    assert tr.busy_us(0.0, 100.0) == pytest.approx(40.0)
    gaps = idle_gaps(tr, 0.0, 100.0)
    assert gaps[0][1] == pytest.approx(30e-6)      # 70-100
    assert [g[0] for g in gaps][1] == "portbench.window/aten::item"

    @dataclasses.dataclass
    class R:
        trace: object
        trace_window: tuple
        traced: list

    run = R(tr, (0.0, 100.0), [1, 2])
    assert spec.load_reader("device_idle.online")(run) == pytest.approx(60.0)
    assert spec.load_reader("host_reads.online")(run) == pytest.approx(0.5)


def test_kernel_time_takes_a_merge_only_after_its_scan():
    ev = [Event("kernel", "void aicp::(anonymous namespace)::nn_scan_kernel"
                "<4>(float const*)", 0, 5.0, (2, 64)),
          Event("kernel", "void aicp::(anonymous namespace)::merge_kernel()",
                6, 1.0, ()),
          Event("kernel", "void aicp::(anonymous namespace)::merge_kernel()",
                9, 7.0, ()),                 # not after a 1-NN scan
          Event("kernel", "at::native::elementwise", 20, 3.0, ())]
    assert kernel_time_us(ev, ("nn_scan_kernel",), ("merge_kernel",)) == 6.0


def test_end_to_end_readers_on_a_made_up_window():
    w = Window(start=10.0, end=12.0, latencies=[0.05] * 38 + [0.1] * 2,
               frames=list(range(40)), completed=40)

    @dataclasses.dataclass
    class R:
        window: object
        setup_s: float = 17.5

    run = R(w)
    assert spec.load_reader("frame_ms")(run) == pytest.approx(50.0)
    assert spec.load_reader("setup_s")(run) == 17.5
    assert spec.load_reader("scans_per_s")(run) == pytest.approx(20.0)
    # a replay: the results recorded between the window's edges, over the
    # window, however they bunch (a pipelined App finalizes in bursts)
    w2 = Window(start=3.0, end=48.0, frames=list(range(1000)), completed=900)
    assert spec.load_reader("scans_per_s")(R(w2)) == pytest.approx(20.0)
    assert spec.load_reader("scans_per_s")(R(Window())) is None

"""The K1 and K2 work counts: chip_smoke.py:bound's rule at the shapes of
PERF.md's kernel table, and a count that does not depend on which kernel
did the work."""
from __future__ import annotations

import dataclasses
import importlib
import math

import pytest

from portbench import roofline, spec
from portbench.trace import Event, Trace

chip_smoke = importlib.import_module("chip_smoke")


@pytest.mark.parametrize("M,N", [(8192, 8192), (1024, 8192), (4096, 4096),
                                 (16384, 16384), (2048, 16384)])
def test_k1_bound_is_chip_smokes_at_perf_shapes(M, N):
    # chip_smoke's valid counts: M - M // 32 queries, N - 3N // 128 refs
    mv, nv = M - M // 32, N - 3 * N // 128
    ops, nbytes = roofline.nn_work(M, mv, N, nv, 1)
    P = 8
    ref = chip_smoke.bound(chip_smoke.OPS_PER_PAIR * mv * nv,
                           13 * (M + N) + 4 * P * N + 4 * M * (1 + P))
    assert ops == chip_smoke.OPS_PER_PAIR * mv * nv
    # both bounded by operations, so the same least time
    assert ref["bound_by"] == "operations"
    assert roofline.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        ref["bound_ms"], rel=1e-12)


def test_k1_bound_at_8192_is_perfs_7_6_us():
    mv, nv = 8192 - 256, 8192 - 192
    assert roofline.bound_s(*roofline.nn_work(8192, mv, 8192, nv, 1)) \
        * 1e6 == pytest.approx(7.6, abs=0.05)


@pytest.mark.parametrize("N,nbrs", [(16384, 16384 * 6),
                                    (32768, 32768 * 40)])
def test_k2_counts_neighbours_and_bytes(N, nbrs):
    ops, nbytes = roofline.moments_work(N, nbrs)
    assert ops == (chip_smoke.OPS_PER_PAIR
                   + chip_smoke.OPS_PER_NEIGHBOUR) * nbrs
    # chip_smoke reads points, mask and codes (21 B) and writes 40 B a row;
    # the problem reads points and mask only
    assert nbytes == 53 * N
    assert roofline.PEAK_FP32 == chip_smoke.PEAK_FP32
    assert roofline.PEAK_BYTES == chip_smoke.PEAK_BYTES


@dataclasses.dataclass
class _Res:
    filtered_size: int
    n_iterations: int
    registered: bool = True


@dataclasses.dataclass
class _Run:
    trace: object
    trace_window: tuple
    traced: list
    results: list
    schedule: list
    icp_calls: dict
    neighbours: dict
    pipeline: dict


def _run(kernels, icp_calls):
    host = [Event("user_annotation", "portbench.window", 0.0, 1e6, ())]
    results = [_Res(8000, 0), _Res(7900, 8), _Res(8100, 7)]
    return _Run(Trace(kernels, host), (0.0, 1e6), [1, 2], results,
                [None, 0, 0], icp_calls, {1: 90000, 2: 95000},
                {"filtered_capacity": 8192, "downsample_capacity": 16384})


def _k(name, ts, dur):
    return Event("kernel", f"void aicp::(anonymous namespace)::{name}<4>()",
                 ts, dur, ())


def test_the_count_does_not_depend_on_the_implementation():
    calls = {1: [(1024, 6), (8192, 2)], 2: [(1024, 5), (8192, 2)]}
    # one implementation: one scan + merge a call ...
    a = [_k("nn_scan_kernel", 10.0 * i, 4.0) for i in range(15)]
    # ... another: three scans a call, the same total device time
    b = [_k("nn_scan_kernel", 10.0 * i, 4.0 / 3) for i in range(45)]
    ra, rb = _run(a, calls), _run(b, calls)
    read = spec.load_reader("k1_roofline")
    assert read(ra) == pytest.approx(read(rb))
    # and the work is the problem's: phases x valid queries x valid refs
    want = 0.0
    for k, phases in calls.items():
        f = ra.results[k].filtered_size
        for rows, its in phases:
            want += roofline.bound_s(*roofline.nn_work(
                rows, math.ceil(f / (8192 // rows)), 8192, 8000, its))
    assert read(ra) == pytest.approx(want / 60e-6 * 100)
    # a kernel taken off the path leaves the metric silent, not 0
    assert read(_run([_k("other_kernel", 0, 5.0)], calls)) is None


def test_k2_count_reads_neighbours_not_launches():
    one = [_k("moments_scan_kernel", 0, 80.0), _k("moments_merge_kernel",
                                                  90, 5.0)]
    two = one + [_k("moments_scan_kernel", 200, 0.0),
                 _k("moments_merge_kernel", 210, 0.0)]
    read = spec.load_reader("k2_roofline")
    assert read(_run(one, {})) == pytest.approx(read(_run(two, {})))
    want = sum(roofline.bound_s(*roofline.moments_work(16384, n))
               for n in (90000, 95000))
    assert read(_run(one, {})) == pytest.approx(want / 85e-6 * 100)

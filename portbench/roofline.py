"""The least time the card could take for the work a problem needs, and
that work counted from the problem's own sizes.

The bound is `chip_smoke.py:bound`'s rule (commit
d49b34b8df308b6b17527cfdc9cc292ea998a7ca): the larger of the FP32
operations over the H100 SXM's 67 TFLOP/s and the bytes over its
3.35 TB/s (NVIDIA's data sheet, at 700 W), each input read once and each
output written once; 8 operations per squared distance |q - r|^2 (3
subtractions, 3 multiplications, 2 additions) and 10 per neighbour summed
into the moments.

The counts here never look at a kernel: they take the number of valid
points, the ICP iterations of each phase and the radius neighbours the
inputs have, so they read the same work whatever implements it.
"""
from __future__ import annotations

PEAK_FP32 = 67e12          # FLOP/s, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12       # B/s, HBM3
OPS_PER_PAIR = 8
OPS_PER_NEIGHBOUR = 10


def bound_s(ops: float, nbytes: float) -> float:
    """Seconds: max(ops / peak FLOP/s, bytes / peak bytes/s)."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def nn_work(m_rows: int, m_valid: int, n_rows: int, n_valid: int,
            iterations: int) -> tuple:
    """(operations, bytes) of `iterations` exact 1-NN searches with the
    match's point and normal: every valid query against every valid
    reference. Read: queries (12 B and a mask byte a row), references and
    their normals (25 B a row). Written: each query's squared distance,
    matched point and normal (28 B)."""
    ops = OPS_PER_PAIR * m_valid * n_valid * iterations
    nbytes = (13 * m_rows + 25 * n_rows + 28 * m_rows) * iterations
    return ops, nbytes


def moments_work(rows: int, neighbours: int) -> tuple:
    """(operations, bytes) of radius moments: each neighbour pair's squared
    distance and its 10 moment sums. Read: points and mask (13 B a row).
    Written: 10 f32 moments a row."""
    ops = (OPS_PER_PAIR + OPS_PER_NEIGHBOUR) * neighbours
    return ops, (13 + 40) * rows

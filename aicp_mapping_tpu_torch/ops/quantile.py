"""Masked quantiles on padded arrays, PyTorch port of
`aicp_mapping_tpu.ops.quantile`.

Used by the trimmed-distance outlier filter of ICP (keep the `ratio`
fraction of matches with the smallest distance) and by the ICP quality
monitor (`registration.monitor`).
"""
from __future__ import annotations

import torch

_BIG = 3.4e38


def masked_quantile(values: torch.Tensor, mask: torch.Tensor,
                    q) -> torch.Tensor:
    """Quantile over valid entries: the smallest value v such that at least
    q * n_valid values are <= v (sort once, index ceil(q * n) - 1)."""
    sv = torch.sort(torch.where(mask, values, _BIG)).values
    n = mask.sum()
    pos = torch.ceil(q * n.to(torch.float32)).to(torch.int64) - 1
    pos = torch.minimum(torch.clamp(pos, min=0), torch.clamp(n - 1, min=0))
    return sv[pos]


def _linspace_f32(start: float, stop: float, num: int,
                  device) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` bit for bit in float32:
    start * (1 - step) + stop * step with step = iota / (num - 1), and the
    endpoint appended. The trim threshold is a histogram edge, so a
    one-ulp edge shift would move it."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    head = start * (1.0 - step) + stop * step
    return torch.cat([head, torch.full((1,), stop, dtype=torch.float32,
                                       device=device)])


def masked_quantile_hist(values: torch.Tensor, mask: torch.Tensor, q,
                         bins: int = 128, rounds: int = 2,
                         axis_name: str | None = None,
                         mesh=None) -> torch.Tensor:
    """Approximate masked quantile by iterative range-narrowing histograms
    (`rounds` x `bins` cumulative counts, no sort), as in the JAX twin.
    `q` may be a 0-d tensor; the result is a 0-d float32 tensor on the
    device of `values`, computed without a host sync.

    With `axis_name` (values sharded over that axis of `mesh`) the valid
    count and the bin counts are `psum`-reduced and the range `pmax`-ed,
    so every rank gets the same global quantile: `rounds` x `bins` floats
    and two scalars per call, never the values."""
    def preduce(x):
        return x if axis_name is None else mesh.psum(x, axis_name)

    dev = values.device
    n = preduce(mask.to(torch.float32).sum())
    target = torch.ceil(q * n)
    lo = torch.zeros((), dtype=torch.float32, device=dev)
    hi = torch.where(mask, values, -_BIG).max()
    if axis_name is not None:
        hi = mesh.pmax(hi, axis_name)
    hi = torch.clamp(hi, min=1e-12)
    vm = torch.where(mask, values, _BIG)
    base = _linspace_f32(1.0 / bins, 1.0, bins, dev)
    for _ in range(rounds):
        edges = lo + (hi - lo) * base
        # counts[b] = #values <= edges[b] (cumulative by construction)
        counts = preduce((vm[:, None] <= edges[None, :]).sum(0).to(
            torch.float32))
        meets = counts >= target
        b = torch.argmax(meets.to(torch.int32))       # first bracketing bin
        b = torch.where(meets.any(), b, bins - 1)
        width = (hi - lo) / bins
        new_lo = lo + width * b.to(torch.float32)
        hi = new_lo + width
        lo = torch.where(b > 0, new_lo, lo)
    return hi


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    w = mask.to(values.dtype)
    return (values * w).sum() / torch.clamp(w.sum(), min=1.0)


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return masked_quantile(values, mask, 0.5)


def masked_max(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, values, -_BIG).max()

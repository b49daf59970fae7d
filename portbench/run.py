"""Run one cell of the port's benchmark once, on the card(s) of this
machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json` and
`aicp_mapping_tpu_torch`. The cell's configuration, traffic mix, check
limits and metrics are found by name (`portbench/spec.py`). With
`--trace 0` the run sets up, warms up, measures for `--seconds` and
reports the cell's end-to-end metrics; with `--trace 1` it runs the mix's
staged and traced segments instead and reports the per-layer metrics.
Either way it then checks a sample of the frames against the plain
reference and prints each compared number beside its limit, on standard
error and as the result's last key. The last line of standard output is
the result: one JSON object. Without the cards the cell asks for, or with
JAX loaded, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    the port's CUDA kernels already build under build/aicp_torch_kernels."""
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from portbench import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda", log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, row in out["check"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Count the instructions of the 1-NN scans' inner loops in the built
kernel library, and the issue-rate floor they imply, on a machine with
the CUDA toolkit.

    python3 -m aicp_mapping_tpu_torch.tools.kernel_sass [--lib PATH]

Disassembles the library (`cuobjdump -sass`; by default the port's own,
built from `_kernels/csrc` if needed) and, for each kernel whose name
holds "scan_kernel" or "nn_kernel" or "banded_stream_kernel", finds its
hottest innermost loop: the backward branch with no other inside it that
holds the most FSETP instructions. Each distance evaluation ends in one
FSETP (d < best), so the loop's instructions over its FSETPs are the
instructions per (query, reference) pair. The issue-rate floor of a
launch is pairs x instructions per pair / (132 SMs x 4 schedulers x 32
lanes x the SM clock), one warp instruction per scheduler and cycle;
`--clock-ghz` defaults to the card's maximum SM clock by `nvidia-smi`.
Prints one JSON object and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_NAMES = ("scan_kernel", "nn_kernel", "banded_stream_kernel")
# (kernel, queries, window) of the main paths' launches: K1 against the
# whole reference, K5 against its band of 1024-point blocks.
SHAPES = {
    "nn": [(8192, 8192), (1024, 8192), (65536, 65536)],
    "banded": [(1024, 131072), (8192, 32768), (1024, 65536), (8192, 16384),
               (8192, 65536)],
}


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")


def functions(sass: str) -> dict:
    """{mangled name: [(address, opcode, operands)]} of a SASS listing."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return out


def inner_loop(insns: list):
    """The instructions of the innermost loop with the most FSETPs."""
    loops = []
    for k, (addr, op, args) in enumerate(insns):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                body = [i for i in insns if lo <= i[0] <= addr]
                loops.append((lo, addr, body))
    inner = [(lo, hi, body) for lo, hi, body in loops
             if not any(lo <= lo2 and hi2 < hi or lo < lo2 and hi2 <= hi
                        for lo2, hi2, _ in loops)]
    if not inner:
        return []
    return max(inner, key=lambda loop: sum(
        op.startswith("FSETP") for _, op, _ in loop[2]))[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--clock-ghz", type=float, default=None)
    ap.add_argument("--out", default="chiprun_out/kernel_sass.json")
    args = ap.parse_args(argv)
    if args.lib is None:
        from .. import _kernels
        args.lib = str(_kernels.build())
    clock = args.clock_ghz
    gpu = None
    if clock is None:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.strip()
        gpu = smi.splitlines()[0]
        clock = float(gpu.split(",")[-1]) / 1e3
    sass = subprocess.run([_cuobjdump(), "-sass", args.lib],
                          capture_output=True, text=True, check=True).stdout
    lanes_per_s = 132 * 4 * 32 * clock * 1e9
    rows = []
    for name, insns in sorted(functions(sass).items()):
        if not any(k in name for k in _NAMES):
            continue
        body = inner_loop(insns)
        pairs = sum(op.startswith("FSETP") for _, op, _ in body)
        if not pairs:
            continue
        per_pair = len(body) / pairs
        hist = collections.Counter(op.split(".")[0] for _, op, _ in body)
        kind = "banded" if "banded" in name else "nn"
        rows.append(dict(
            kernel=name, loop_instructions=len(body), pairs_per_loop=pairs,
            instructions_per_pair=per_pair, opcodes=dict(hist.most_common()),
            floor_us={f"{m}x{w}": m * w * per_pair / lanes_per_s * 1e6
                      for m, w in SHAPES[kind]}))
    result = dict(library=args.lib, gpu=gpu, clock_ghz=clock, kernels=rows)
    print(json.dumps(result, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())

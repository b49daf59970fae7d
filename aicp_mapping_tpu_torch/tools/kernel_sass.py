"""Count the instructions of the scans' inner loops in the built kernel
library, and the issue-rate floor they imply, on a machine with the CUDA
toolkit.

    python3 -m aicp_mapping_tpu_torch.tools.kernel_sass [--lib PATH]

Disassembles the library (`cuobjdump -sass`; by default the port's own,
built from `_kernels/csrc` if needed) and, for each kernel whose name
holds "scan_kernel" or "nn_kernel" or "banded_stream_kernel" (the 1-NN
scans K1 and K5, the moments scan of K2 and K3), finds its hottest
innermost loop: the backward branch with no other inside it that holds the
most FSETP instructions. Each distance evaluation ends in one FSETP (the
1-NN scans' d < best, the moments' radius test d <= r^2), so the
instructions the loop runs when it skips its f64 path, over the FSETPs
among them, are the instructions per (query, reference) pair. The f64 path
is the moments scan's neighbour sums: a run of the loop that a forward
branch skips and that holds f64 arithmetic, entered only where a warp
found a neighbour; its instructions are counted apart
(`f64_path_instructions_per_pair`: spread over the loop's pairs, what a
pair would cost if every reference were entered). The issue-rate floor of
a launch is pairs x instructions per pair / (132 SMs x 4 schedulers x 32
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
# whole reference, K5 against its band of 1024-point blocks, K2 against
# its 8 blocks (the prefilter's 16,384 points, the map's 262,144) and K3
# against the whole cloud (the golden scenario's 4,096, and 8,192).
SHAPES = {
    "nn": [(8192, 8192), (1024, 8192), (65536, 65536)],
    "banded": [(1024, 131072), (8192, 32768), (1024, 65536), (8192, 16384),
               (8192, 65536)],
    "moments": [(16384, 8192), (262144, 8192), (4096, 4096), (8192, 8192)],
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


_F64 = ("DADD", "DFMA", "DMUL")


def _count(body: list, ops) -> int:
    return sum(op.split(".")[0] in ops for _, op, _ in body)


def f64_path(body: list) -> set:
    """Addresses of the loop's instructions that a forward branch skips
    where the skipped run holds f64 arithmetic."""
    cold = set()
    for addr, op, args in body:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") \
            else None
        if m and int(m.group(1), 16) > addr:
            run = [i for i in body if addr < i[0] < int(m.group(1), 16)]
            if _count(run, _F64):
                cold.update(a for a, _, _ in run)
    return cold


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
    return max(inner, key=lambda loop: _count(loop[2], ("FSETP",)))[2]


def sm_clock_ghz() -> tuple:
    """(the card's nvidia-smi line: name, power limit, max SM clock in MHz;
    the max SM clock in GHz)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = smi.splitlines()[0]
    return gpu, float(gpu.split(",")[-1]) / 1e3


def analyse(lib: str, clock: float) -> list:
    """One row per scan kernel of the library at `lib`: its inner loop's
    instructions per pair, opcode counts, and issue-rate floors in µs at
    SHAPES, for an SM clock of `clock` GHz."""
    sass = subprocess.run([_cuobjdump(), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    lanes_per_s = 132 * 4 * 32 * clock * 1e9
    rows = []
    for name, insns in sorted(functions(sass).items()):
        if not any(k in name for k in _NAMES):
            continue
        body = inner_loop(insns)
        cold = f64_path(body)
        hot = [i for i in body if i[0] not in cold]
        pairs = _count(hot, ("FSETP",))
        if not pairs:
            continue
        per_pair = len(hot) / pairs
        hist = collections.Counter(op.split(".")[0] for _, op, _ in hot)
        kind = ("moments" if "moments" in name
                else "banded" if "banded" in name else "nn")
        row = dict(
            kernel=name, loop_instructions=len(body), pairs_per_loop=pairs,
            instructions_per_pair=per_pair,
            f64_path_instructions_per_pair=len(cold) / pairs,
            opcodes=dict(hist.most_common()),
            floor_us={f"{m}x{w}": m * w * per_pair / lanes_per_s * 1e6
                      for m, w in SHAPES[kind]})
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--clock-ghz", type=float, default=None)
    ap.add_argument("--out", default="chiprun_out/kernel_sass.json")
    args = ap.parse_args(argv)
    if args.lib is None:
        from .. import _kernels
        args.lib = str(_kernels.build())
    clock, gpu = args.clock_ghz, None
    if clock is None:
        gpu, clock = sm_clock_ghz()
    rows = analyse(args.lib, clock)
    result = dict(library=args.lib, gpu=gpu, clock_ghz=clock, kernels=rows)
    print(json.dumps(result, indent=1))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())

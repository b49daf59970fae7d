"""Nothing the benchmark runs loads JAX or the JAX package: whole
top-level module names, in the sources (by `ast`) and in `sys.modules`
after a CPU dry run at a tiny size."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from conftest import REPO
from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "aicp_mapping_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    seen = set()
    for base, _, files in os.walk(os.path.join(REPO, "portbench")):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(base, f)))
                assert not names & FORBIDDEN, (f, names & FORBIDDEN)
                seen |= names
    # the port's name begins with the JAX package's: a whole-name match
    assert "aicp_mapping_tpu_torch" in seen


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "aicp_mapping_tpu_torch_x", sys)
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(harness.forbidden_modules()) - base == {"jax"}


def test_a_dry_run_loads_no_jax(tiny):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{tiny!r}, {REPO!r}]\n"
        "from portbench import harness, spec\n"
        f"cell = spec.load_cell({tiny!r}, 'bench60k.online', "
        f"{os.path.join(tiny, 'portbench')!r})\n"
        "out = harness.run_cell(cell, 5, 0.5, False, device='cpu', "
        "log=lambda m: None)\n"
        "print(json.dumps(dict(mods=harness.forbidden_modules(), "
        "correct=out['correct'])))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=600, cwd=tiny)
    assert p.returncode == 0, p.stderr[-2000:]
    last = p.stdout.strip().splitlines()[-1]
    assert '"mods": []' in last and '"correct": true' in last

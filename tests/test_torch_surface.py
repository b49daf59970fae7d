"""The port's public surface by the JAX package's names. The JAX package is
walked by AST (neither package is imported for the walk): every export
list of an `__init__.py`, every public module-level function and class,
and every public method of those classes must exist in the port's twin
module, unless the name stands in `RENAMED` (the port's name, which must
exist) or `LEFT_OUT` (the reason)."""
import ast
import importlib
import os

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_PKG, PORT_PKG = "aicp_mapping_tpu", "aicp_mapping_tpu_torch"

# (module, JAX name) -> the port's name for it
RENAMED = {
    ("ops", "nn_argmin_pallas"): "nn_argmin_kernel",
    ("ops", "nn_argmin_xla"): "nn_argmin",
    ("ops.knn", "nn_argmin_pallas"): "nn_argmin_kernel",
    ("ops.knn", "nn_argmin_xla"): "nn_argmin",
    ("ops.knn", "nn_payload_pallas"): "nn_payload_tiled_kernel",
    ("ops.knn", "nn_payload_pallas_split"): "nn_payload_kernel",
    ("ops.knn", "nn_payload_xla"): "nn_payload",
    ("ops.banded_nn", "nn_payload_banded_resident_split"):
        "nn_payload_banded_stream_kernel",
    ("ops.banded_nn", "nn_payload_banded_stream_split"):
        "nn_payload_banded_stream_kernel",
    ("ops.normals", "sorted_radius_moments_split"):
        "sorted_radius_moments_kernel",
}

_BF16 = ("a TPU bf16-split trick of the Pallas kernels; the port keeps "
         "the contract (exact f32 distances), not the TPU's layout")
# (module, JAX name) -> why the port has no counterpart
LEFT_OUT = {
    ("ops.knn", "split3_bf16"): _BF16,
    ("ops.knn", "cross_pack_q"): _BF16,
    ("ops.knn", "cross_pack_r"): _BF16,
    ("ops.banded_nn", "banded_blocks_split"):
        "the resident Pallas kernel's VMEM block layout; K5 streams the "
        "sorted map instead",
    ("parallel.localizer", "partial_shard_map"):
        "a jax.shard_map compatibility shim; the port's mesh is "
        "torch.distributed process groups",
    ("native", "load"):
        "returns the JAX package's C++ library handle; the port loads no "
        "C++ runtime (its native module is numpy and threads)",
    ("native", "available"):
        "reports whether that C++ library loaded; no such library here",
    ("eval.multichip", "project_ici_efficiency"):
        "projects a TPU interconnect from v5e figures; porting it would put "
        "TPU numbers into the port, and no NVLink figures are invented",
}


def _jax_modules():
    """(dotted module relative to the package, path) of every JAX module
    but `__main__`."""
    base = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py") or f == "__main__.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            yield ".".join(parts), os.path.join(dirpath, f)


def _public_names(path: str):
    """(name, class or None) of the module's public surface: the export
    list of an `__init__.py`, public functions and classes, and the public
    methods of those classes."""
    tree = ast.parse(open(path).read())
    init = path.endswith("__init__.py")
    for node in tree.body:
        if init and isinstance(node, ast.ImportFrom) and node.level >= 1:
            for a in node.names:
                yield a.asname or a.name, None
        elif (isinstance(node, (ast.FunctionDef, ast.ClassDef))
              and not node.name.startswith("_")):
            yield node.name, None
            if isinstance(node, ast.ClassDef):
                for b in node.body:
                    if (isinstance(b, ast.FunctionDef)
                            and not b.name.startswith("_")):
                        yield b.name, node.name


SURFACE = [(mod, name, cls) for mod, path in _jax_modules()
           for name, cls in _public_names(path)]


def test_the_walk_sees_the_whole_package():
    mods = {m for m, _, _ in SURFACE}
    assert {"", "ops", "registration", "overlap", "io", "utils",
            "utils.live_viz", "eval.plots", "io.vtk", "io.planar",
            "geometry.se3", "cloud"} <= mods
    assert len(SURFACE) > 300


@pytest.mark.parametrize("mod", sorted({m for m, _, _ in SURFACE}))
def test_every_public_name_exists_in_the_port(mod):
    port = importlib.import_module(f"{PORT_PKG}.{mod}" if mod else PORT_PKG)
    missing = []
    for m, name, cls in SURFACE:
        if m != mod:
            continue
        if cls is None and (mod, name) in LEFT_OUT:
            assert not hasattr(port, name), (mod, name)
            continue
        if cls is None and (mod, name) in RENAMED:
            name = RENAMED[(mod, name)]
        owner = getattr(port, cls) if cls else port
        if not hasattr(owner, name):
            missing.append(f"{cls}.{name}" if cls else name)
    assert not missing, (mod, missing)


def test_the_exceptions_name_real_jax_names():
    """Every entry of the two dicts names a public JAX name, and every
    port name in RENAMED is callable."""
    names = {(m, n) for m, n, c in SURFACE if c is None}
    assert set(RENAMED) <= names, set(RENAMED) - names
    assert set(LEFT_OUT) <= names, set(LEFT_OUT) - names
    for (mod, _), port_name in RENAMED.items():
        port = importlib.import_module(f"{PORT_PKG}.{mod}")
        assert callable(getattr(port, port_name)), (mod, port_name)

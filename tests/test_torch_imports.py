"""The port stands alone: no module of det3d_tpu_torch, and not
chip_smoke.py, imports the JAX package, jax or flax; and its own copy of
the synthetic scan generator gives the JAX package's scans."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from det3d_tpu.utils.synth import structured_batch as jstructured_batch
from det3d_tpu_torch.utils.synth import structured_batch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("det3d_tpu", "jax", "jaxlib", "flax", "optax")


def port_sources():
    files = sorted((REPO / "det3d_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def imported_modules(path):
    """Every module an import statement of the file names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_found():
    names = {p.name for p in port_sources()}
    assert {"chip_smoke.py", "window_conv_cuda.py", "backbones.py",
            "sparse_host.py", "dist_utils.py", "sampler.py"} <= names


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_package_imports(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("batch,points,seed", [(2, 3000, 3), (1, 16384, 7)])
def test_synth_equals_jax_package(batch, points, seed):
    pc = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    ours = structured_batch(batch, points, pc, seed=seed)
    ref = jstructured_batch(batch, points, pc, seed=seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)

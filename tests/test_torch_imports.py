"""ceph_tpu_torch stands alone: no JAX and nothing of ceph_tpu.

An AST scan of every module of the port and of chip_smoke.py, and a
fresh interpreter that imports the port — its erasure-code plane, CRUSH,
the OSD map and its mapping, the stores, residency, the profiler and the
scrub functions — and finds
no ``jax`` in ``sys.modules``.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ceph_tpu")


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_ceph_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and _forbidden(str(node.args[0].value))
        ):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ceph_tpu_torch, ceph_tpu_torch.ec, ceph_tpu_torch.ops\n"
        "import ceph_tpu_torch.tools.ec_benchmark\n"
        "import ceph_tpu_torch.ec.lrc, ceph_tpu_torch.ec.shec, ceph_tpu_torch.ec.clay\n"
        "import ceph_tpu_torch.ec.example, ceph_tpu_torch.ec.stripe, ceph_tpu_torch.native\n"
        "import ceph_tpu_torch.osd.ec_pg, ceph_tpu_torch.tools.ec_non_regression\n"
        "import ceph_tpu_torch.crush, ceph_tpu_torch.crush.torchmap\n"
        "import ceph_tpu_torch.tools.crushtool\n"
        "import ceph_tpu_torch.common, ceph_tpu_torch.store, ceph_tpu_torch.store.pg_backend\n"
        "import ceph_tpu_torch.store.remote, ceph_tpu_torch.ops.scrub_kernels\n"
        "import ceph_tpu_torch.ops.residency, ceph_tpu_torch.ops.profiler\n"
        "import ceph_tpu_torch.crush.encode, ceph_tpu_torch.osd.osdmap\n"
        "import ceph_tpu_torch.osd.mapping, ceph_tpu_torch.osd.balancer\n"
        "import ceph_tpu_torch.tools.osdmaptool\n"
        "import ceph_tpu_torch.msg, ceph_tpu_torch.auth, ceph_tpu_torch.compressor\n"
        "import ceph_tpu_torch.store.wal_store, ceph_tpu_torch.store.blockstore\n"
        "import ceph_tpu_torch.store.kstore, ceph_tpu_torch.osd.failure\n"
        "import ceph_tpu_torch.osd.scrub, ceph_tpu_torch.tools.objectstore_tool\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr

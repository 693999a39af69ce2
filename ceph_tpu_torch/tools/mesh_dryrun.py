"""One storage step over a device mesh: the multi-device smoke check.

The JAX package's dryrun (``dryrun_multichip``) runs a storage step
sharded across its device mesh; this is that step over a
``DeviceMesh`` of the port (``ops/mesh.py``):

- encode: reed_sol_van k=4 m=2 w=8, ``2·s`` stripes of ``256·b`` bytes
  (``(s, b)`` the most-square factoring of the mesh size, as the JAX
  step lays its (stripe, byte) grid), seeded, through
  ``sharded_matrix_stripes``;
- a checksum: the u32 sum of every parity and data byte;
- decode: data chunks {0, 1} erased and rebuilt from the k survivors
  through the same sharded product, every byte compared;
- placement: ``4·n + 3`` PGs (ragged for every mesh size above 1) of an
  indep rule over 4 hosts of 3 OSDs through ``sharded_batch_do_rule``,
  every lane held against the oracle.

``chip_smoke.py`` phase 16 runs it on the card (``DeviceMesh(["cuda:0"]
* 4)``), tests/test_torch_mesh.py on CPU meshes against the JAX step.
"""

from __future__ import annotations

import numpy as np

K, M, W = 4, 2, 8
ERASURES = (0, 1)


def mesh_axes(n_devices: int) -> tuple[int, int]:
    """Factor n into the most-square (stripe, byte) grid."""
    a = 1
    for d in range(1, int(n_devices**0.5) + 1):
        if n_devices % d == 0:
            a = d
    return n_devices // a, a


def placement_map():
    """4 hosts of 3 OSDs under one straw2 root, an indep rule."""
    from ..crush import CRUSH_BUCKET_STRAW2, CrushMap

    cmap = CrushMap()
    hosts = [
        cmap.add_bucket(
            CRUSH_BUCKET_STRAW2, 1, [h * 3, h * 3 + 1, h * 3 + 2], [0x10000] * 3,
            name=f"host{h}",
        )
        for h in range(4)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts],
        name="default",
    )
    rule = cmap.add_simple_rule("r", "default", "host", mode="indep")
    return cmap, rule


def step(dmesh) -> dict:
    """Run the step over ``dmesh``; returns the parity (numpy), the
    checksum, the decode's byte errors and the placement's
    (results, counts).  Raises where placement differs from the
    oracle."""
    from .. import gf
    from ..ops.gf_matmul import matrix_to_device_bitmatrix
    from ..ops.mesh import sharded_matrix_stripes
    from ..osd.sharded_mapping import sharded_batch_do_rule

    sd, bd = mesh_axes(dmesh.n)
    batch, chunk = 2 * sd, 256 * bd
    matrix = gf.reed_sol_vandermonde_coding_matrix(K, M, W)
    rng = np.random.default_rng(0)
    stripes = rng.integers(0, 256, size=(batch, K, chunk), dtype=np.uint8)
    dev = dmesh.devices[0]
    parity = sharded_matrix_stripes(
        matrix_to_device_bitmatrix(matrix, W, dev), stripes, W, dmesh
    )
    checksum = int(parity.sum(dtype=np.uint64) + stripes.sum(dtype=np.uint64)) & 0xFFFFFFFF
    rows, survivors = gf.make_decoding_matrix(matrix, list(ERASURES), K, W)
    full = np.concatenate([stripes, parity], axis=1)
    rec = sharded_matrix_stripes(
        matrix_to_device_bitmatrix(rows, W, dev), full[:, survivors], W, dmesh
    )
    errors = int((rec != stripes[:, : len(ERASURES)]).sum())

    cmap, rule = placement_map()
    n_pgs = 4 * dmesh.n + 3
    res, counts = sharded_batch_do_rule(cmap, rule, np.arange(n_pgs), 3, dmesh=dmesh)
    for x in range(n_pgs):
        oracle = cmap.do_rule(rule, x, 3)
        if counts[x] != len(oracle) or res[x].tolist()[: len(oracle)] != oracle:
            raise AssertionError(
                f"pg {x}: sharded {res[x].tolist()[: counts[x]]} != oracle {oracle}"
            )
    return {"parity": parity, "checksum": checksum, "errors": errors,
            "placement": (res, counts), "pgs": n_pgs}

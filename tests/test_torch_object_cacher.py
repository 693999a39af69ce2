"""The port's ObjectCacher held against the JAX package's, on the CPU.

The same seeded sequence of reads, writes, per-object and whole
flushes, discards and invalidations runs on a JAX and a port
``ObjectCacher``, each over its own ``FakeIoctx`` (the backing stand-in
of ``tests/test_object_cacher.py``, copied here). The caches are sized
so that clean extents evict and writers cross the dirty limit, and the
flusher's age is an hour, so every flush is one the sequence or the
dirty throttle asks for and the run is a pure function of the seed.

Equal after every step, exactly: the bytes a read returns, the
backend's read and write counts, dirty and total bytes, hits, misses
and the cacher's backend writes; at the end, the backend's objects,
which also equal a plain model of the writes and discards.
"""

from __future__ import annotations

import random
import threading

import pytest

from ceph_tpu.osdc.object_cacher import ObjectCacher as JObjectCacher
from ceph_tpu.osdc.objecter import ObjectNotFound as JObjectNotFound
from ceph_tpu_torch.osdc.object_cacher import ObjectCacher
from ceph_tpu_torch.osdc.objecter import ObjectNotFound


class FakeIoctx:
    """Object-store stand-in counting backend traffic."""

    def __init__(self, not_found):
        self.objects: dict[str, bytearray] = {}
        self.reads = 0
        self.writes = 0
        self.lock = threading.Lock()
        self.not_found = not_found

    def read(self, oid, length=-1, offset=0):
        with self.lock:
            self.reads += 1
            if oid not in self.objects:
                raise self.not_found(oid)
            data = bytes(self.objects[oid])
        if length < 0:
            return data[offset:]
        return data[offset : offset + length]

    def write(self, oid, data, offset=0):
        with self.lock:
            self.writes += 1
            buf = self.objects.setdefault(oid, bytearray())
            end = offset + len(data)
            if len(buf) < end:
                buf.extend(b"\0" * (end - len(buf)))
            buf[offset:end] = data


def _ops(seed: int, n: int, objects: int, span: int):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        oid = f"o{rng.randrange(objects)}"
        r = rng.random()
        off = rng.randrange(0, span - 1)
        ln = rng.randint(1, min(4096, span - off))
        if r < 0.45:
            out.append(("write", oid, off, bytes([rng.randrange(256)]) * ln))
        elif r < 0.85:
            out.append(("read", oid, off, ln))
        elif r < 0.91:
            out.append(("flush", oid))
        elif r < 0.95:
            out.append(("flush", None))
        elif r < 0.985:
            out.append(("discard", oid))
        else:
            out.append(("invalidate",))
    return out


def _run(cacher_cls, not_found, ops, sizes, preload):
    io = FakeIoctx(not_found)
    for oid, data in preload.items():
        io.objects[oid] = bytearray(data)
    c = cacher_cls(io, flush_age=3600.0, **sizes)
    steps = []
    try:
        for op in ops:
            got = None
            if op[0] == "write":
                c.write(op[1], op[2], op[3])
            elif op[0] == "read":
                got = c.read(op[1], op[2], op[3])
            elif op[0] == "flush":
                c.flush(op[1])
            elif op[0] == "discard":
                c.discard(op[1])
                # the caller deletes what it discards (rbd's whole-object discard)
                io.objects.pop(op[1], None)
            else:
                c.invalidate_all()
            steps.append((got, io.reads, io.writes, c.dirty_bytes, c.total_bytes, c.hits,
                          c.misses, c.backend_writes))
    finally:
        c.close()
    final = (io.writes, c.backend_writes, c.dirty_bytes,
             {k: bytes(v) for k, v in sorted(io.objects.items())})
    return steps, final


def _model(ops, preload):
    objs = {k: bytearray(v) for k, v in preload.items()}
    for op in ops:
        if op[0] == "write":
            buf = objs.setdefault(op[1], bytearray())
            end = op[2] + len(op[3])
            if len(buf) < end:
                buf.extend(b"\0" * (end - len(buf)))
            buf[op[2]:end] = op[3]
        elif op[0] == "discard":
            objs.pop(op[1], None)
    return {k: bytes(v) for k, v in sorted(objs.items())}


CASES = {
    "evicting": (11, 600, 6, 16384, dict(max_dirty=32 << 10, target_dirty=16 << 10,
                                          max_size=48 << 10)),
    "throttled": (23, 500, 4, 32768, dict(max_dirty=12 << 10, target_dirty=4 << 10,
                                           max_size=1 << 20)),
    "roomy": (5, 400, 3, 8192, dict(max_dirty=8 << 20, target_dirty=4 << 20,
                                     max_size=32 << 20)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_sequence_same_cache(name):
    seed, n, objects, span, sizes = CASES[name]
    rng = random.Random(seed + 1)
    preload = {f"o{i}": rng.randbytes(rng.randrange(1, span)) for i in range(0, objects, 2)}
    ops = _ops(seed, n, objects, span)
    mine = _run(ObjectCacher, ObjectNotFound, ops, sizes, preload)
    ref = _run(JObjectCacher, JObjectNotFound, ops, sizes, preload)
    for i, (a, b) in enumerate(zip(mine[0], ref[0])):
        assert a == b, (i, ops[i][:3])
    assert mine[1] == ref[1]
    # what reached the backend is what a plain model of the ops holds,
    # up to the zero-filled tails that reads of holes never write back
    model = _model(ops, preload)
    got = mine[1][3]
    assert sorted(got) == sorted(model)
    for k, v in got.items():
        assert v.rstrip(b"\0") == model[k].rstrip(b"\0"), k
    assert mine[1][2] == 0
    assert any(s[4] for s in mine[0]) and any(s[6] for s in mine[0])

"""Object classes (cls) — in-OSD stored procedures
(src/cls/, src/objclass/class_api.cc, src/osd/ClassHandler.cc).

The reference loads ``libcls_*.so`` modules into the OSD; pools call
their methods through CEPH_OSD_OP_CALL (PrimaryLogPG::do_osd_ops →
ClassHandler dispatch).  Here classes self-register with the
``ClassHandler`` registry (the dlopen role, same pattern as the EC
and compressor registries) and methods declare RD/WR flags exactly
like cls_register_cxx_method.

A method receives a ``MethodContext`` exposing the object primitives
(cls_cxx_read/stat/getxattr/...); WRITE methods stage mutations
(write_full / setxattr / remove) that the OSD folds into the SAME
replicated, logged transaction as any client write — a failed method
aborts with no side effects, matching the reference's all-or-nothing
op semantics.

Built-ins mirror the reference's most-used classes: ``hello``
(cls_hello), ``lock`` (cls_lock: exclusive/shared cooperative locks),
``version`` (cls_version: monotone object versions), ``log``
(cls_log: timestamped appends with trim).
"""

from __future__ import annotations

import json
import time

__all__ = [
    "ClassError",
    "ClassHandler",
    "MethodContext",
    "RD",
    "WR",
    "default_handler",
]

RD = 1  # CLS_METHOD_RD
WR = 2  # CLS_METHOD_WR


class ClassError(Exception):
    """Method failure — surfaces to the client as an op error."""


class MethodContext:
    """The objclass API surface handed to methods (class_api.cc):
    reads hit the live object; writes stage into the op's transaction."""

    def __init__(
        self,
        read_fn,
        attrs: dict[str, bytes],
        exists: bool,
        omap_fn=None,
    ):
        self._read = read_fn
        self._attrs = dict(attrs)
        self._omap_fn = omap_fn
        self._omap_cache: dict[str, bytes] | None = None
        self.exists = exists
        # staged mutations the OSD materializes into the txn
        self.new_data: bytes | None = None
        self.new_attrs: dict[str, bytes] = {}
        self.new_omap: dict[str, bytes] = {}
        self.rm_omap: set[str] = set()
        self.removed = False
        # payloads to deliver to the object's watchers AFTER the op
        # commits (cls_cxx_notify; cls_lock's unlock broadcast)
        self.notifies: list[bytes] = []

    # -- reads (cls_cxx_read / stat / getxattr) ----------------------------
    def read(self) -> bytes:
        if self.new_data is not None:
            return self.new_data
        return self._read() if self.exists else b""

    def stat(self) -> int:
        return len(self.read())

    def getxattr(self, name: str) -> bytes | None:
        if name in self.new_attrs:
            return self.new_attrs[name]
        return self._attrs.get(name)

    # -- omap (cls_cxx_map_get_val / get_vals / set_val / remove_key) ------
    def _omap_base(self) -> dict[str, bytes]:
        if self._omap_cache is None:
            self._omap_cache = (
                dict(self._omap_fn())
                if self._omap_fn is not None and self.exists
                else {}
            )
        return self._omap_cache

    def omap_get(self) -> dict[str, bytes]:
        """Merged view: stored omap + staged writes of THIS op."""
        merged = dict(self._omap_base())
        for k in self.rm_omap:
            merged.pop(k, None)
        merged.update(self.new_omap)
        return merged

    def omap_get_val(self, key: str) -> bytes | None:
        return self.omap_get().get(key)

    def omap_set(self, kv: dict[str, bytes]) -> None:
        for k, v in kv.items():
            self.new_omap[k] = bytes(v)
            self.rm_omap.discard(k)

    def omap_rm(self, keys) -> None:
        for k in keys:
            self.rm_omap.add(k)
            self.new_omap.pop(k, None)

    # -- staged writes (cls_cxx_write_full / setxattr / remove) ------------
    def write_full(self, data: bytes) -> None:
        self.new_data = bytes(data)
        self.removed = False

    def setxattr(self, name: str, value: bytes) -> None:
        self.new_attrs[name] = bytes(value)

    def remove(self) -> None:
        self.removed = True
        self.new_data = None

    def notify(self, payload: bytes) -> None:
        """Queue a watcher notification delivered once the op commits."""
        self.notifies.append(bytes(payload))

    @property
    def has_staged_writes(self) -> bool:
        return bool(
            self.new_data is not None
            or self.new_attrs
            or self.new_omap
            or self.rm_omap
            or self.removed
        )


class ClassHandler:
    """class/method registry (ClassHandler.cc + cls_register)."""

    def __init__(self):
        self._classes: dict[str, dict[str, tuple[int, object]]] = {}

    def register(self, cls: str, method: str, flags: int, fn) -> None:
        self._classes.setdefault(cls, {})[method] = (flags, fn)

    def cls_method(self, cls: str, method: str, flags: int):
        def deco(fn):
            self.register(cls, method, flags, fn)
            return fn

        return deco

    def flags_of(self, cls: str, method: str) -> int:
        entry = self._classes.get(cls, {}).get(method)
        if entry is None:
            raise ClassError(
                f"class {cls!r} method {method!r} not found (-EOPNOTSUPP)"
            )
        return entry[0]

    def call(
        self, cls: str, method: str, ctx: MethodContext, indata: bytes
    ) -> bytes:
        flags, fn = self._classes.get(cls, {}).get(method, (0, None))
        if fn is None:
            raise ClassError(
                f"class {cls!r} method {method!r} not found (-EOPNOTSUPP)"
            )
        return fn(ctx, indata) or b""

    def classes(self) -> list[str]:
        return sorted(self._classes)


default_handler = ClassHandler()


# -- built-in classes ------------------------------------------------------

_LOCK_ATTR = "cls_lock"


@default_handler.cls_method("hello", "say_hello", RD)
def _hello(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_hello's say_hello (src/cls/hello/cls_hello.cc)."""
    name = indata.decode() or "world"
    return f"Hello, {name}!".encode()


@default_handler.cls_method("hello", "record_hello", WR)
def _record_hello(ctx: MethodContext, indata: bytes) -> bytes:
    ctx.write_full(b"Hello, " + (indata or b"world") + b"!")
    return b""


def _lock_state(ctx: MethodContext) -> dict:
    raw = ctx.getxattr(_LOCK_ATTR)
    return json.loads(raw) if raw else {"type": "", "holders": {}}


@default_handler.cls_method("lock", "lock", WR)
def _lock(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_lock lock_op: exclusive or shared cooperative lock."""
    req = json.loads(indata)
    name, typ = req["cookie"], req.get("type", "exclusive")
    state = _lock_state(ctx)
    if state["holders"]:
        if typ == "exclusive":
            # exclusive needs to be the SOLE holder (an upgrade while
            # other shared holders remain would not be exclusive)
            if set(state["holders"]) != {name}:
                raise ClassError("object is locked (-EBUSY)")
        elif state["type"] == "exclusive":
            if name not in state["holders"]:
                raise ClassError("object is locked (-EBUSY)")
    state["type"] = typ
    state["holders"][name] = time.time()
    ctx.setxattr(_LOCK_ATTR, json.dumps(state).encode())
    return b""


@default_handler.cls_method("lock", "unlock", WR)
def _unlock(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    state = _lock_state(ctx)
    if req["cookie"] not in state["holders"]:
        raise ClassError("no such lock holder (-ENOENT)")
    del state["holders"][req["cookie"]]
    if not state["holders"]:
        state["type"] = ""
    ctx.setxattr(_LOCK_ATTR, json.dumps(state).encode())
    # waiters watch the object and retry on this broadcast
    # (cls_lock's unlock → watch/notify wakeup pattern)
    ctx.notify(
        json.dumps({"event": "unlocked", "cookie": req["cookie"]}).encode()
    )
    return b""


@default_handler.cls_method("lock", "get_info", RD)
def _lock_info(ctx: MethodContext, indata: bytes) -> bytes:
    return json.dumps(_lock_state(ctx)).encode()


@default_handler.cls_method("version", "set", WR)
def _version_set(ctx: MethodContext, indata: bytes) -> bytes:
    ctx.setxattr("cls_version", indata)
    return b""


@default_handler.cls_method("version", "inc", WR)
def _version_inc(ctx: MethodContext, indata: bytes) -> bytes:
    cur = int(ctx.getxattr("cls_version") or b"0")
    ctx.setxattr("cls_version", str(cur + 1).encode())
    return str(cur + 1).encode()


@default_handler.cls_method("version", "read", RD)
def _version_read(ctx: MethodContext, indata: bytes) -> bytes:
    return ctx.getxattr("cls_version") or b"0"


# cls_log (src/cls/log/cls_log.cc): entries live in the OMAP keyed by
# zero-padded "<stamp>.<seq>" so listing pages in time order and trim
# is a ranged key removal — the index-style workload omap exists for.

_LOG_SEQ_ATTR = "cls_log_seq"


def _log_key(stamp: float, seq: int) -> str:
    return f"{stamp:020.6f}.{seq:012d}"


@default_handler.cls_method("log", "add", WR)
def _log_add(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_log add: one omap entry per line, timestamp-ordered keys."""
    seq = int(ctx.getxattr(_LOG_SEQ_ATTR) or b"0")
    entries = json.loads(indata) if indata.startswith(b"[") else [
        indata.decode()
    ]
    now = time.time()
    staged: dict[str, bytes] = {}
    for entry in entries:
        seq += 1
        staged[_log_key(now, seq)] = json.dumps(
            {"stamp": now, "entry": entry}
        ).encode()
    ctx.omap_set(staged)
    ctx.setxattr(_LOG_SEQ_ATTR, str(seq).encode())
    return b""


@default_handler.cls_method("log", "list", RD)
def _log_list(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_log list: [from_key, max] page of entries in key order."""
    req = json.loads(indata) if indata else {}
    start = req.get("from", "")
    limit = int(req.get("max", -1))
    omap = ctx.omap_get()
    out = []
    for key in sorted(omap):
        if start and key <= start:
            continue
        out.append({"key": key, **json.loads(omap[key])})
        if 0 <= limit <= len(out):
            break
    return json.dumps(out).encode()


@default_handler.cls_method("log", "trim", WR)
def _log_trim(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_log trim: remove entries with key <= to_key (or keep the
    newest N when indata is a bare integer)."""
    omap = ctx.omap_get()
    keys = sorted(omap)
    if indata.isdigit():
        keep = int(indata)
        doomed = keys[: max(0, len(keys) - keep)]
    else:
        req = json.loads(indata) if indata else {}
        to_key = req.get("to", "")
        doomed = [k for k in keys if k <= to_key]
    ctx.omap_rm(doomed)
    return b""

"""dout-style logging (src/log/Log.cc + common/subsys.h).

Per-subsystem debug levels gate cheaply at call time; accepted entries
go to an in-memory ring buffer whose recent tail can be dumped on
crash (the reference's async log keeps `log_max_recent` entries for
exactly this).  Gather levels control what also reaches the python
``logging`` stream.  Levels follow the reference's 0..30 convention
(0 = always, higher = chattier).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

DEFAULT_SUBSYS_LEVEL = 5

# subsys.h's table, covering every subsystem the daemons log under
# (a name missing here would silently gate at the default level)
SUBSYSTEMS = {
    "crush": 1,
    "ec": 1,
    "osd": 5,
    "store": 5,
    "config": 5,
    "balancer": 5,
    "mon": 5,
    "mgr": 5,
    "msg": 1,
    "mds": 5,
    "rgw": 5,
    "rbd": 5,
    "client": 5,
    # the cluster-log mirror (LogClient entries echo into the local
    # dout ring so a crash dump shows what the daemon clogged)
    "clog": 5,
}


class Log:
    def __init__(self, max_recent: int = 500, gather_level: int = 5):
        self._levels = dict(SUBSYSTEMS)
        self._recent: deque = deque(maxlen=max_recent)
        self._lock = threading.Lock()
        self.gather_level = gather_level
        self._py = logging.getLogger("ceph_tpu_torch")

    # -- levels ------------------------------------------------------------
    def set_level(self, subsys: str, level: int) -> None:
        self._levels[subsys] = level

    def get_level(self, subsys: str) -> int:
        return self._levels.get(subsys, DEFAULT_SUBSYS_LEVEL)

    def should_log(self, subsys: str, level: int) -> bool:
        return level <= self.get_level(subsys)

    # -- entry points ------------------------------------------------------
    def dout(self, subsys: str, level: int, message: str) -> None:
        """The dout(n) macro role: cheap gate, ring append, optional
        python-logging passthrough."""
        if not self.should_log(subsys, level):
            return
        entry = (time.time(), subsys, level, message)
        with self._lock:
            self._recent.append(entry)
        if level <= self.gather_level:
            self._py.log(
                logging.DEBUG if level > 0 else logging.INFO,
                "%s %d: %s",
                subsys,
                level,
                message,
            )

    def derr(self, subsys: str, message: str) -> None:
        self.dout(subsys, 0, message)

    # -- crash dump --------------------------------------------------------
    def dump_recent(self, subsys: str | None = None) -> list[dict]:
        """The SIGSEGV-handler dump of the ring buffer, optionally
        filtered to one subsystem."""
        with self._lock:
            return [
                {
                    "stamp": stamp,
                    "subsys": s,
                    "level": level,
                    "message": message,
                }
                for stamp, s, level, message in self._recent
                if subsys is None or s == subsys
            ]

    def register_admin_commands(self, admin_socket) -> None:
        admin_socket.register_command(
            "log dump",
            lambda args: self.dump_recent(args.get("subsys")),
            "dump recent log entries (optional subsys filter)",
        )

        def _set(args):
            self.set_level(args["subsys"], int(args["level"]))
            return {"success": True}

        admin_socket.register_command(
            "log set-level", _set, "set a subsystem debug level"
        )


_global = Log()


def log() -> Log:
    return _global


def dout(subsys: str, level: int, message: str) -> None:
    _global.dout(subsys, level, message)

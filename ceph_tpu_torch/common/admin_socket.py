"""Admin socket — per-daemon JSON command endpoint
(src/common/admin_socket.cc, 789 LoC).

A unix-domain socket served from a background thread; commands are
newline-terminated JSON (or bare command strings) answered with JSON,
exactly the `ceph daemon <name> <command>` interaction.  Built-in
commands mirror the reference: help, version, perf dump, perf reset,
config show, config diff, config set/get.  Subsystems register extra
hooks with ``register_command``.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from ..version import FRAMEWORK_VERSION
from .config import Config, ConfigError
from .perf_counters import PerfCountersCollection


class AdminSocket:
    def __init__(
        self,
        path: str,
        config: Config | None = None,
        perf: PerfCountersCollection | None = None,
    ):
        self.path = path
        self.config = config or Config()
        self.perf = perf or PerfCountersCollection()
        self._hooks: dict[str, callable] = {}
        self._server: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._register_builtins()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.path)
        os.chmod(self.path, 0o600)
        self._server.listen(8)
        self._server.settimeout(0.2)
        self._thread = threading.Thread(
            target=self._serve, name="admin_socket", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._server is not None:
            self._server.close()
        if os.path.exists(self.path):
            os.unlink(self.path)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- commands ----------------------------------------------------------
    def register_command(self, prefix: str, fn, help="") -> None:
        """fn(args: dict) -> jsonable (AdminSocketHook::call role)."""
        if prefix in self._hooks:
            raise ValueError(f"command {prefix!r} already registered")
        self._hooks[prefix] = (fn, help)

    def _register_builtins(self) -> None:
        self.register_command(
            "help",
            lambda args: {
                name: help for name, (_, help) in sorted(self._hooks.items())
            },
            "list available commands",
        )
        self.register_command(
            "version",
            lambda args: {"version": FRAMEWORK_VERSION},
            "framework version",
        )
        self.register_command(
            "perf dump", lambda args: self.perf.dump(),
            "dump perfcounters",
        )

        def _perf_reset(args):
            self.perf.reset()
            return {"success": True}

        self.register_command(
            "perf reset", _perf_reset, "zero all perfcounters"
        )
        self.register_command(
            "config show", lambda args: self.config.show_config(),
            "show effective config",
        )
        self.register_command(
            "config diff", lambda args: self.config.diff(),
            "show non-default config with sources",
        )
        self.register_command(
            "config get",
            lambda args: {args["var"]: self.config.get(args["var"])},
            "get one option",
        )

        def _set(args):
            self.config.set(args["var"], args["val"])
            return {"success": True}

        self.register_command("config set", _set, "set one option")

    def execute(self, command) -> dict:
        """Run a command (str prefix or {"prefix": ..., args...})."""
        if isinstance(command, str):
            request = {"prefix": command.strip()}
        else:
            request = dict(command)
        prefix = request.pop("prefix", "")
        hook = self._hooks.get(prefix)
        if hook is None:
            return {
                "error": f"unknown command {prefix!r}; try 'help'"
            }
        fn, _help = hook
        try:
            return {"ok": fn(request)}
        except Exception as e:  # noqa: BLE001 — a hook must never be
            # able to kill the serve thread; every failure becomes a
            # JSON error reply (the reference logs and answers too)
            return {"error": f"{type(e).__name__}: {e}"}

    # -- wire --------------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except (socket.timeout, OSError):
                continue
            with conn:
                try:
                    data = b""
                    conn.settimeout(2)
                    while not data.endswith(b"\n"):
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        data += chunk
                    line = data.decode().strip()
                    try:
                        command = json.loads(line)
                    except json.JSONDecodeError:
                        command = line
                    response = self.execute(command)
                    conn.sendall(json.dumps(response).encode() + b"\n")
                except OSError:
                    pass


def admin_command(path: str, command) -> dict:
    """Client helper: the `ceph daemon` side."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(10)
        s.connect(path)
        payload = (
            json.dumps(command)
            if not isinstance(command, str)
            else command
        )
        s.sendall(payload.encode() + b"\n")
        data = b""
        while not data.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    return json.loads(data.decode())

"""One run of one cell: set-up, a measured window, the check against
the reference, and the result line (see the package docstring)."""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import time
import types

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
PROGRAM = "ceph_tpu_torch"
# set by __main__ from the process's start time; a run started in-process
# (the tests) counts from its own start
T0 = time.perf_counter()


class NoCard(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat field 22)."""
    with open("/proc/self/stat") as f:
        stat = f.read()
    start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(spec: dict, workload: str, root: pathlib.Path = HERE.parent) -> tuple[dict, dict, dict]:
    """The cell's entry, its traffic file and its configuration file,
    found by name under the checkout ``root``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"perfbench: no cell {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    traffic = json.loads((root / "perfbench" / "workloads" / f"{cell['traffic']}.json").read_text())
    config = json.loads((root / conf["file"]).read_text())
    return cell, traffic, config


def end_to_end_of(spec: dict, workload: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer_of(spec: dict, workload: str) -> list[dict]:
    reported = {m["name"] for m in end_to_end_of(spec, workload)}
    out = []
    for m in spec["per_layer"]:
        if workload in m["workloads"] if "workloads" in m else m["moves"] in reported:
            out.append(m)
    return out


class Cell:
    """What a driver gets: the cell's parameters and the window."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device: str,
                 traffic: dict, config: dict, fault: str = ""):
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.device, self.traffic, self.config, self.fault = device, traffic, config, fault
        self.setup_s = None
        self.window_ns = None
        self.memory_peak_bytes = 0
        self.device_trace = None
        self.sampler = None

    @property
    def on_card(self) -> bool:
        return self.device.startswith("cuda")

    def note_memory(self) -> None:
        if self.on_card:
            import torch

            self.memory_peak_bytes = max(self.memory_peak_bytes,
                                         torch.cuda.max_memory_allocated())

    @contextlib.contextmanager
    def window(self):
        """Set-up ends where this opens; the measured window is its body.
        A traced run profiles the device and samples the host inside."""
        from . import trace

        if self.on_card:
            import torch

            torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            if self.trace:
                if self.on_card:
                    self.device_trace = stack.enter_context(trace.DeviceTrace())
                self.sampler = stack.enter_context(trace.HostSampler(PROGRAM))
            self.setup_s = time.perf_counter() - T0
            lo = time.time_ns()
            try:
                yield
            finally:
                self.window_ns = (lo, time.time_ns())
        self.note_memory()


def _checks_line(checks: list[dict]) -> dict:
    return {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str = "", traffic_overrides: dict | None = None,
             config_overrides: dict | None = None, root: pathlib.Path = HERE.parent) -> dict:
    """Run one cell in this process and return the result line's dict.
    ``device="cpu"`` and the overrides serve the CPU rehearsals only."""
    entry, traffic, config = find(spec, workload, root)
    here = root / "perfbench"
    traffic.update(traffic_overrides or {})
    config.update(config_overrides or {})
    driver = load_module(here / "drivers" / f"{traffic['driver']}.py",
                         f"perfbench.drivers.{traffic['driver']}")
    cell = Cell(workload, seed, seconds, trace, device, traffic, config, fault)
    res = driver.run(cell)
    cell.note_memory()

    metrics = {}
    if not trace:
        for m in end_to_end_of(spec, workload):
            v = cell.setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = None
    dev = {"platform": "gpu" if cell.on_card else "cpu",
           "kind": _device_kind(device), "count": entry["chips"] if cell.on_card else 0,
           "memory_peak_bytes": cell.memory_peak_bytes}
    if trace:
        from . import trace as tr

        lo, hi = cell.window_ns
        events = cell.device_trace.events if cell.device_trace else []
        red = tr.reduce(events, lo, hi, cell.sampler)
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        reading = types.SimpleNamespace(
            cell=workload, window_ns=(lo, hi), window_s=red["window_s"], busy_s=red["busy_s"],
            events=[e for e in events if e[2] > lo and e[1] < hi], on_card=cell.on_card,
            **res.get("layer", {}))
        for m in per_layer_of(spec, workload):
            reader = load_module(here / "metrics" / f"{m['name']}.py",
                                 f"perfbench.metrics.{m['name']}")
            v = reader.read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = _checks_line(res["checks"])
    return line


def _device_kind(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return "cpu"


def forbidden_modules() -> list[str]:
    return sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a planted fault or the control, for the proofs of the check only
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)

    root = pathlib.Path.cwd()
    spec = load_spec(root)
    entry, _t, _c = find(spec, args.workload, root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                    fault=args.fault, root=root)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

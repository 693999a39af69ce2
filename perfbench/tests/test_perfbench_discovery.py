"""A later change adds a configuration, a traffic mix, a driver and a
per-layer metric as new files; the harness takes them by name with no
edit to any file already there."""

import hashlib
import json
import pathlib
import shutil

from perfbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]

DRIVER = '''
def run(cell):
    with cell.window():
        pass
    n = cell.traffic["ops"] * cell.config["scale"]
    return {"e2e": {"toy_ops_per_s": n / cell.seconds}, "attempted": n, "failed": 0,
            "checks": [{"name": "wrong", "value": 0, "limit": 0}], "correct": True,
            "layer": {"toy_count": n}}
'''
METRIC = '''
def read(run):
    return float(run.toy_count)
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp_path / "perfbench"
    (here / "configs" / "toy.json").write_text(json.dumps({"scale": 3}))
    (here / "workloads" / "toy.burst.json").write_text(json.dumps({"driver": "toy", "ops": 5}))
    (here / "drivers" / "toy.py").write_text(DRIVER)
    (here / "metrics" / "toy.count.py").write_text(METRIC)
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "perfbench/configs/toy.json", "reduced": [], "why": "a toy"})
    spec["workloads"].append({"name": "toy.burst", "config": "toy", "traffic": "toy.burst",
                              "chips": 1, "why": "a toy"})
    spec["end_to_end"].append({"name": "toy_ops_per_s", "unit": "ops/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["toy.burst"]})
    spec["per_layer"].append({"name": "toy.count", "unit": "ops", "better": "higher",
                              "source": "program_counter", "layer": "Toy", "moves": "toy_ops_per_s",
                              "workloads": ["toy.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    line = run.run_cell(spec, "toy.burst", 1, 2.0, False, device="cpu", root=tmp_path)
    assert line["metrics"]["toy_ops_per_s"]["value"] == 7.5
    assert set(line["metrics"]) == {"toy_ops_per_s", "setup_s"}
    traced = run.run_cell(spec, "toy.burst", 1, 2.0, True, device="cpu", root=tmp_path)
    assert traced["metrics"] == {"toy.count": {"value": 15.0, "unit": "ops"}}
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())

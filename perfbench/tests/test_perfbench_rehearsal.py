"""Each driver end to end on the CPU at a tiny size, with the reference
deciding ``correct``; each planted fault and each control must turn
``correct`` false.  The measured command itself refuses to run without
a card, and in a directory that holds only the benchmark."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from perfbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]


SPEC = run.load_spec(ROOT)
CELL = "osdmap_10k.remap"

# a 400-OSD map in the cell's layout: 4 OSDs a host, 5 hosts a rack,
# 2 racks a row; one pool of 4096 PGs
OSDMAP = {"osds": 400, "fanout": [4, 5, 2], "pools": [
    {"pool_id": 1, "type": "replicated", "size": 3, "min_size": 2, "pg_num": 4096, "rule": 0}]}
TRAFFIC = {"check": {"cycles": 1, "random_pgs": 100, "domain_pgs": 30}}
FAULTS = ["control", "unchanged", "half_batch", "altered"]


def _run(fault="", trace=False, seed=2**31 + 12345):
    return run.run_cell(SPEC, CELL, seed, 3.0, trace, device="cpu", fault=fault,
                        traffic_overrides=TRAFFIC, config_overrides=OSDMAP)


def test_cell_rehearses_correct():
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["breakdown"]["idle_gaps"]
    assert list(line)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_cell_reports_its_end_to_end_metrics():
    line = _run()
    want = {m["name"] for m in run.end_to_end_of(SPEC, CELL)}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_turns_correct_false(fault):
    line = _run(fault=fault)
    assert not line["correct"], line["checks"]


def _command(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "perfbench", "--workload", CELL,
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _command(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_command_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_one_cell_on_the_card(card):
    line = run.run_cell(SPEC, CELL, 2**31 + 7, 2.0, False, device=card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"

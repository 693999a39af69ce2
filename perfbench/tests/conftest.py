"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from
the repository root.  They run on the CPU; the one that needs the card
carries the ``cuda`` marker and skips, from inside a fixture, where
there is none."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures only on the card")
    return "cuda"

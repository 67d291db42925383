"""Test set-up of the benchmark's own tests (the repository's
``tests/conftest.py`` imports JAX, which nothing here may load).

Tests that need the card are marked ``cuda`` and decide inside the
``card`` fixture whether there is one, never while a module is
imported."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "port_bench")

#: The cells at a size a CPU test holds: every width cut, the same
#: entries, traffic mixes and limits.
TINY = {
    "hadisst_scale": {"data": dict(n_samples=60, n_features=128),
                      "aa": dict(n_init=8, restart_chunk=4,
                                 compact_iterations=8, max_iterations=60)},
}

#: The cells of ``BENCHMARK.json``, read when the tests are collected.
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode)")
    return "cuda"


@pytest.fixture
def tiny(tmp_path):
    """A folder with ``BENCHMARK.json`` and the cells' configurations cut
    to :data:`TINY`, their traffic (smaller request banks), their limits
    and their proofs."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for sub in ("configs", "traffic", "limits", "proofs"):
        shutil.copytree(os.path.join(BENCH, sub), tmp_path / sub)
    for name, cut in TINY.items():
        path = tmp_path / "configs" / (name + ".json")
        config = json.loads(path.read_text())
        for group, values in cut.items():
            config[group].update(values)
        path.write_text(json.dumps(config))
    path = tmp_path / "traffic" / "aa_transform.json"
    traffic = json.loads(path.read_text())
    traffic.update(bank_rows=64, rows={"low": 1, "high": 20},
                   traced_requests=5)
    path.write_text(json.dumps(traffic))
    return tmp_path

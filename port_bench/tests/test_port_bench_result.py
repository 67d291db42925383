"""The result line: its keys, on a run of each cell at a CPU test's
size with the look for a card skipped, and no line without a card."""

import json
import subprocess
import sys
import time

import pytest

from port_bench import harness
from port_bench.tests.conftest import CELLS


def run_tiny(tiny, cell, trace=0, seed=2 ** 31 + 11, **kw):
    return harness.run_cell(cell, seed, 0.5, trace,
                            t_start=time.perf_counter(), root=tiny,
                            files=tiny, device="cpu", require_card=False,
                            **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_line_keys(tiny, cell):
    result, rec, numbers, lines = run_tiny(tiny, cell)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["attempted"] == len(rec["calls"]) >= 1
    assert "setup_s" in result["metrics"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    limits = harness.load_json(tiny / "limits" / (cell + ".json"))
    assert list(result["checks"]) == list(limits)
    assert len(lines) == len(limits)
    json.dumps(result)


def test_traced_line_has_the_trace(tiny):
    result, rec, _, _ = run_tiny(tiny, "hadisst_scale.aa_transform", trace=1)
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "device_idle_pct.transform" in result["metrics"]
    # The latencies are read from the requests run without the profiler.
    untraced = [c for c in rec["calls"] if not c["traced"]]
    assert ("request_p95_ms.transform" in result["metrics"]) == bool(untraced)
    assert "peak_mem_gb" not in result["metrics"]


def test_no_card_no_line(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_judge_fails_a_missing_or_high_number():
    ok, checks = harness.judge({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0})
    assert ok and checks == {"a": {"value": 1.0, "limit": 2.0},
                             "b": {"value": 0.0, "limit": 0}}
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not harness.judge({}, {"a": 2.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 2.0})[0]


def test_launcher_runs_one_process_a_card(tiny):
    """A cell that asks for two cards, as two gloo processes on the CPU:
    rank 0's line, with the fullest card's peak."""
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        if w["name"] == "hadisst_scale.aa_best100":
            w["chips"] = 2
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    result, rec, numbers, lines = harness.launch(
        "hadisst_scale.aa_best100", 3, 0.3, 0, t_start=time.perf_counter(), chips=2,
        timeout=240, root=str(tiny), files=str(tiny), device="cpu",
        require_card=False)
    assert result["device"]["count"] == 2
    assert isinstance(result["correct"], bool)
    assert list(result)[-1] == "checks"
    assert set(rec["setup_parts"]) >= {"data_s", "warm_s"}

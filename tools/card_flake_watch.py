#!/usr/bin/env python3
"""Run one card-only test many times, each in a fresh pytest process,
and count its passes and failures.

Usage, on a machine with a CUDA device, from the root of the
repository::

    python3 tools/card_flake_watch.py [runs] [test id] [output dir]

The defaults watch ``tests/test_torch_cuda.py::
test_fit_on_card_matches_cpu`` 20 times (ROADMAP.md queue 3: a float64
fit whose ``n_iters`` once differed between the card and the CPU).
Each run is ``python -m pytest --noconftest -m cuda`` on that test
(tests/conftest.py imports JAX, which such a machine need not have).
A run counts as passed when pytest exits with 0 and reports one test
passed.  The output of every failed run, with the card's name and power
limit, is written to ``<output dir>/flake_watch_<run>.txt`` (default
``flake_watch_out``); the last line is one JSON object with the
counts.
"""

import json
import os
import re
import subprocess
import sys

TEST = "tests/test_torch_cuda.py::test_fit_on_card_matches_cpu"


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    test = sys.argv[2] if len(sys.argv) > 2 else TEST
    out_dir = sys.argv[3] if len(sys.argv) > 3 else "flake_watch_out"
    name = card()
    os.makedirs(out_dir, exist_ok=True)
    counts = {"passed": 0, "failed": 0}
    for run in range(runs):
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest",
             "-p", "no:cacheprovider", "-m", "cuda", test],
            capture_output=True, text=True)
        # One test ran and passed (a skip, where there is no card, is
        # no pass).
        ok = proc.returncode == 0 and re.search(
            r"\b1 passed\b", proc.stdout) is not None
        counts["passed" if ok else "failed"] += 1
        print("run %d: %s" % (run, "passed" if ok else "FAILED"),
              flush=True)
        if not ok:
            path = os.path.join(out_dir, "flake_watch_%d.txt" % run)
            with open(path, "w") as f:
                f.write(name + "\n" + proc.stdout + proc.stderr)
    print(name)
    print(json.dumps(dict(test=test, runs=runs, **counts)))
    return 0 if counts["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

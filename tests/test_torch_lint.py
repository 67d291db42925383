"""Lint gate for the PyTorch port.

tools/lint.py's default paths cover the JAX package and the tests; the
port's package and chip_smoke.py are named here explicitly and held to
the same checks.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_is_lint_clean():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "lint.py"),
         "convex_dim_red_tpu_torch", "chip_smoke.py"],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, "lint findings:\n" + proc.stdout

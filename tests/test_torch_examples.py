"""The port's examples end to end on the CPU.

``python -m convex_dim_red_tpu_torch.examples.jra55_case_study OUT
--quick --platform cpu`` and its HadISST sibling must write the artifact
inventory that tests/test_jra55_case_study.py and
tests/test_case_study_artifacts.py hold the JAX examples to (the same
figure names, tables and driver products), and the scaling tour must
finish its walk in a gloo world of two CPU processes.  The three run at
once in child processes with one thread each (the JAX examples' tests
take minutes and are marked slow; these run in about a minute).
"""

import csv
import importlib
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch.examples import _common, distributed_scaling
from convex_dim_red_tpu_torch.pipelines.dataset import open_dataset
from tests.test_case_study_artifacts import (
    EXPECTED_FIGURES as HADISST_FIGURES)
from tests.test_jra55_case_study import (EXPECTED_FIGURES as JRA55_FIGURES,
                                         METHODS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Each example's time limit, in seconds.
TIMEOUT = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{example: (return code, output, output directory)}``."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    commands = {
        "jra55_case_study": [str(tmp / "jra55"), "--quick", "--platform",
                             "cpu"],
        "hadisst_case_study": [str(tmp / "hadisst"), "--quick",
                               "--platform", "cpu"],
        "distributed_scaling": ["--platform", "cpu"],
    }
    procs = {}
    try:
        for name, args in commands.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m",
                 "convex_dim_red_tpu_torch.examples." + name] + args,
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        out = {}
        for name, proc in procs.items():
            stdout, _ = proc.communicate(timeout=TIMEOUT)
            directory = commands[name][0]
            out[name] = (proc.returncode, stdout, directory)
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _finished(runs, name):
    rc, stdout, directory = runs[name]
    assert rc == 0, stdout[-4000:]
    return stdout, directory


def _assert_figures(directory, names):
    for name in names:
        path = os.path.join(directory, name)
        assert os.path.exists(path), name
        # A rendered multi-panel PNG is tens of kB; an empty canvas is not.
        assert os.path.getsize(path) > 5000, name


def _assert_model_selection(directory):
    with open(os.path.join(directory, "model_selection.csv")) as f:
        sel = list(csv.DictReader(f))
    ks = [int(r["k"]) for r in sel]
    assert ks == sorted(ks) and len(ks) >= 2
    costs = [float(r["cost"]) for r in sel]
    assert all(np.isfinite(costs))
    # More components never fit worse on the same data.
    assert costs[-1] <= costs[0] + 1e-9


def _assert_aa_product(path):
    aa = open_dataset(path)
    assert 'archetypes' in aa.data_vars and 'weights' in aa.data_vars
    assert np.isfinite(float(aa.attrs['training_set_cost']))


def test_jra55_case_study_writes_the_jax_inventory(runs):
    _, out = _finished(runs, "jra55_case_study")
    _assert_figures(out, JRA55_FIGURES)

    # State-sorting table: every method's 4 states ordered against the
    # leading EOFs, with finite correlations.
    with open(os.path.join(out, "state_sort.csv")) as f:
        rows = list(csv.DictReader(f))
    for method in METHODS:
        corrs = [float(r["abs_corr"]) for r in rows
                 if r["method"] == method]
        assert len(corrs) == 4, method
        assert all(np.isfinite(corrs)) and all(0 <= c <= 1.000001
                                               for c in corrs)

    # Cross-method match table: each AA archetype matched to a
    # grid-kmeans centroid.
    with open(os.path.join(out, "cross_method_match.csv")) as f:
        match = list(csv.DictReader(f))
    assert [int(r["aa_state"]) for r in match] == [0, 1, 2, 3]
    assert all(0 <= int(r["grid_kmeans_centroid"]) < 4 for r in match)

    _assert_model_selection(out)
    _assert_aa_product(os.path.join(out, "jra55_pca_aa.nc"))
    # The PC k-means ran the gap statistic with the PCA reference.
    km = open_dataset(os.path.join(out, "jra55_pca_kmeans.nc"))
    assert km.attrs['reference'] == 'pca'
    assert np.isfinite(float(km.attrs['gap_statistic']))


def test_hadisst_case_study_writes_the_jax_inventory(runs):
    _, out = _finished(runs, "hadisst_case_study")
    _assert_figures(out, HADISST_FIGURES)
    _assert_model_selection(out)
    _assert_aa_product(os.path.join(out, "hadisst_aa.nc"))
    for product in ("hadisst_gpnh.nc", "hadisst_kmeans.nc",
                    "hadisst_pca.nc", "anom.nc", "raw.nc"):
        assert os.path.exists(os.path.join(out, product)), product


def test_distributed_scaling_tour_on_cpu(runs):
    stdout, _ = _finished(runs, "distributed_scaling")
    lines = stdout.splitlines()
    assert "ranks: 2 x cpu" in lines
    assert lines[-1] == "distributed scaling tour OK"


@pytest.mark.parametrize("argv", [["out"], ["out", "--quick"]])
def test_case_studies_run_on_the_card_unless_asked(argv, tmp_path,
                                                   monkeypatch):
    # No fallback: with no CUDA device the default platform raises
    # before anything is written.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        _common.parse_args("case study", argv)
    assert not os.path.exists(tmp_path / "out")
    assert _common.parse_args("case study", argv + ["--platform", "cpu"]
                              ).device == 'cpu'


def test_scaling_tour_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        distributed_scaling.main([])


def test_every_jax_console_script_has_a_torch_one():
    """pyproject.toml names a ``cdr-torch-*`` script for each JAX
    ``cdr-*`` script, pointing at the port's function of the same
    name."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {name for name in scripts if name.startswith("cdr-torch-")}
    theirs = set(scripts) - ours
    assert {"cdr-torch-" + name[len("cdr-"):] for name in theirs} == ours
    for name in sorted(ours):
        module, function = scripts[name].split(":")
        jax_module, jax_function = scripts[
            "cdr-" + name[len("cdr-torch-"):]].split(":")
        assert module == jax_module.replace("convex_dim_red_tpu.",
                                            "convex_dim_red_tpu_torch.")
        assert function == jax_function
        assert callable(getattr(importlib.import_module(module), function))

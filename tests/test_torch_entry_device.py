"""Where the port's entry points run, and the team-width rule of the
K1/K2 kernel.

A tensor stays on its own device; anything else (a numpy array, a list)
goes to ``device``, by default the card, and without a CUDA device that
raises instead of running on the CPU.  The CUDA probe is patched to
report no device, so these tests ask the same on any machine.
"""

import math
import re

import numpy as np
import pytest
import torch

from convex_dim_red_tpu_torch import (PCA, ArchetypalAnalysis,
                                      GPNHConvexCoding, KernelAA, KMeans,
                                      gap_statistic, kmeans_fit)
from convex_dim_red_tpu_torch import (aa_fit_restarts, gpnh_fit_restarts,
                                      kernel_aa_fit_restarts)
from convex_dim_red_tpu_torch.cli import common, drivers
from convex_dim_red_tpu_torch.models.kmeans import kmeans_plusplus, random_init
from convex_dim_red_tpu_torch.parallel import (aa_model_selection_sweep,
                                               gpnh_model_selection_sweep,
                                               kmeans_model_selection_sweep)
from convex_dim_red_tpu_torch.pipelines.dataset import (Dataset, Variable,
                                                        open_dataset)
from convex_dim_red_tpu_torch.ops import simplex_qp
from convex_dim_red_tpu_torch.utils.validation import as_input

torch.set_num_threads(1)

N, D, K = 60, 8, 3
RESTARTS = dict(init='random', max_iterations=20,
                dictionary_solver_kwargs={'max_iterations': 1},
                weights_solver_kwargs={'max_iterations': 10},
                compact_iterations=8)
ESTIMATOR = dict(init='furthest_sum', random_state=0, max_iterations=20)
GPNH = dict(lambda_W=1e-3, max_iterations=10,
            weights_solver_kwargs={'max_iterations': 10})
SWEEP = dict(n_init=2, restart_chunk=None, **RESTARTS)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data(seed=0):
    return np.random.RandomState(seed).standard_normal((N, D))


def _fitted_on_cpu():
    return ArchetypalAnalysis(K, **ESTIMATOR).fit(torch.as_tensor(_data()))


@pytest.mark.parametrize("call", [
    lambda X: aa_fit_restarts(X, K, 0, 2, **RESTARTS),
    lambda X: ArchetypalAnalysis(K, **ESTIMATOR).fit(X),
    lambda X: ArchetypalAnalysis(K, **ESTIMATOR).fit_transform(X),
    lambda X: KernelAA(K, **ESTIMATOR).fit(X @ X.T),
    lambda X: _fitted_on_cpu().transform(X),
    lambda X: gpnh_fit_restarts(X, K, 0, 2, **GPNH),
    lambda X: GPNHConvexCoding(K, random_state=0, **GPNH).fit(X),
    lambda X: PCA(K).fit(X),
    lambda X: kernel_aa_fit_restarts(X @ X.T, K, 0, 2, **RESTARTS),
    lambda X: aa_model_selection_sweep(X, [2, K], 0, **SWEEP),
    lambda X: gpnh_model_selection_sweep(X, [2, K], 0, n_init=2, **GPNH),
    lambda X: KMeans(K, n_init=2).fit(X),
    lambda X: kmeans_fit(X, 0, n_clusters=K, n_init=2),
    lambda X: kmeans_plusplus(X, K, 0),
    lambda X: random_init(X, K, 0),
    lambda X: gap_statistic(X, 1.0, K, n_trials=2),
    lambda X: kmeans_model_selection_sweep(X, [2], 0, n_init=2, n_trials=2),
    lambda X: common.kmeans_analysis(X, None, n_components=K, n_init=2,
                                     max_iterations=10, n_trials=2,
                                     reference='uniform', random_seed=0),
    lambda X: common.pca_analysis(X, None, n_components=K),
], ids=["aa_fit_restarts", "fit", "fit_transform", "KernelAA.fit",
        "transform", "gpnh_fit_restarts", "GPNHConvexCoding.fit",
        "PCA.fit", "kernel_aa_fit_restarts", "aa_model_selection_sweep",
        "gpnh_model_selection_sweep", "KMeans.fit", "kmeans_fit",
        "kmeans_plusplus", "random_init", "gap_statistic",
        "kmeans_model_selection_sweep", "kmeans_analysis", "pca_analysis"])
def test_numpy_without_device_needs_the_card(no_cuda, call):
    with pytest.raises(RuntimeError, match=re.escape("device='cpu'")):
        call(_data())


def test_numpy_with_device_cpu_matches_the_cpu_tensor_fit(no_cuda):
    X = _data(1)
    want = aa_fit_restarts(torch.as_tensor(X), K, 0, 2, **RESTARTS)
    got = aa_fit_restarts(X, K, 0, 2, device='cpu', **RESTARTS)
    assert got['weights'].device.type == "cpu"
    np.testing.assert_array_equal(got['costs'], want['costs'])
    assert torch.equal(got['weights'], want['weights'])


def test_estimator_with_device_cpu_matches_the_cpu_tensor_fit(no_cuda):
    X, X_new = _data(2), _data(3)
    want = ArchetypalAnalysis(K, **ESTIMATOR).fit(torch.as_tensor(X))
    got = ArchetypalAnalysis(K, device='cpu', **ESTIMATOR).fit(X)
    assert got.weights.device.type == "cpu"
    assert got.cost == want.cost and got.n_iter == want.n_iter
    assert torch.equal(got.archetypes, want.archetypes)
    # transform draws its starting weights from the estimator's
    # generator, which both fits left in the same state.
    W_want, cost_want = want.transform(torch.as_tensor(X_new))
    W_got, cost_got = got.transform(X_new)
    assert cost_got == cost_want
    assert torch.equal(W_got, W_want)


def test_cpu_tensor_stays_on_the_cpu_without_device(no_cuda):
    X = torch.as_tensor(_data(4))
    res = aa_fit_restarts(X, K, 0, 2, **RESTARTS)
    assert res['weights'].device.type == "cpu"
    model = ArchetypalAnalysis(K, **ESTIMATOR).fit(X)
    assert model.weights.device.type == "cpu"
    W, cost = model.transform(X)
    assert W.device.type == "cpu" and np.isfinite(cost)
    # An array of weights goes to the archetypes' device.
    recon = model.inverse_transform(W.numpy())
    assert recon.device.type == "cpu"
    assert torch.equal(recon, model.inverse_transform(W))
    kernel = KernelAA(K, **ESTIMATOR).fit(X @ X.T)
    assert kernel.weights.device.type == "cpu"


def test_gpnh_and_pca_with_device_cpu_match_the_cpu_tensor_fit(no_cuda):
    X = _data(5)
    want = gpnh_fit_restarts(torch.as_tensor(X), K, 0, 2, **GPNH)
    got = gpnh_fit_restarts(X, K, 0, 2, device='cpu', **GPNH)
    assert got['weights'].device.type == "cpu"
    np.testing.assert_array_equal(got['costs'], want['costs'])
    model = GPNHConvexCoding(K, random_state=0, device='cpu', **GPNH).fit(X)
    same = GPNHConvexCoding(K, random_state=0, **GPNH).fit(
        torch.as_tensor(X))
    assert model.weights.device.type == "cpu" and model.cost == same.cost
    assert model.transform(X)[1] == same.transform(torch.as_tensor(X))[1]
    pca = PCA(K, device='cpu')
    scores = pca.fit_transform(X)
    assert scores.device.type == "cpu"
    assert torch.equal(scores, PCA(K).fit_transform(torch.as_tensor(X)))
    assert torch.equal(pca.transform(X), pca.transform(torch.as_tensor(X)))


def test_kernel_fit_and_sweeps_with_device_cpu_match_cpu_tensors(no_cuda):
    X = _data(6)
    Kmat = X @ X.T
    want = kernel_aa_fit_restarts(torch.as_tensor(Kmat), K, 0, 2, **RESTARTS)
    got = kernel_aa_fit_restarts(Kmat, K, 0, 2, device='cpu', **RESTARTS)
    assert got['weights'].device.type == "cpu"
    np.testing.assert_array_equal(got['costs'], want['costs'])
    for sweep, kw in ((aa_model_selection_sweep, SWEEP),
                      (gpnh_model_selection_sweep, dict(n_init=2, **GPNH))):
        want = sweep(torch.as_tensor(X), [2, K], 0, **kw)
        got = sweep(X, [2, K], 0, device='cpu', **kw)
        for k in (2, K):
            np.testing.assert_array_equal(got[k]['costs'], want[k]['costs'])
            assert got[k]['rmse'] == want[k]['rmse']


def test_kmeans_with_device_cpu_matches_the_cpu_tensor_fit(no_cuda):
    X = _data(7)
    want = KMeans(K, n_init=3, random_state=0).fit(torch.as_tensor(X))
    got = KMeans(K, n_init=3, random_state=0, device='cpu').fit(X)
    assert got.cluster_centers_.device.type == "cpu"
    assert got.inertia_ == want.inertia_
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    C, labels, inertia, n_iter = kmeans_fit(X, 0, n_clusters=K, n_init=3,
                                            device='cpu')
    C_t, labels_t, inertia_t, n_iter_t = kmeans_fit(
        torch.as_tensor(X), 0, n_clusters=K, n_init=3)
    assert C.device.type == "cpu" and torch.equal(C, C_t)
    assert torch.equal(labels, labels_t) and inertia == inertia_t
    assert n_iter == n_iter_t


@pytest.mark.parametrize("platform", [[], ["--platform", "cuda"]])
def test_driver_without_the_card_needs_platform_cpu(no_cuda, tmp_path,
                                                    platform):
    path, out = str(tmp_path / "in.nc"), str(tmp_path / "out.nc")
    Dataset({'sst_anom': Variable(('time', 'latitude', 'longitude'),
                                  _data(8).reshape(N, 2, 4))},
            {'time': Variable(('time',), np.arange(N) * 30.5,
                              {'units': 'days since 1990-1-1'}),
             'latitude': Variable(('latitude',), np.array([-10.0, 10.0])),
             'longitude': Variable(('longitude',), np.arange(4.0))}
            ).to_netcdf(path)
    argv = ['hadisst_kmeans', path, out, '--n-components', '2', '--n-init',
            '2', '--n-trials', '2', '--random-seed', '0']
    with pytest.raises(RuntimeError, match="--platform cpu"):
        drivers.main(argv + platform)
    drivers.main(argv + ['--platform', 'cpu'])
    assert open_dataset(out)['centroids'].data.shape == (2, 2, 4)


@pytest.mark.parametrize("data,dtype", [
    (np.zeros((2, 3), np.float32), torch.float32),
    (np.zeros((2, 3)), torch.float64),
    ([[0.0, 1.0]], torch.get_default_dtype())])
def test_as_input_keeps_the_dtype(no_cuda, data, dtype):
    out = as_input(data, 'cpu')
    assert out.dtype == dtype and out.device.type == "cpu"
    tensor = torch.zeros(2, dtype=torch.float64)
    assert as_input(tensor) is tensor


def test_team_width_rule():
    # Every k the K1/K2 kernel takes gets a power of two from 1 to 32
    # whose coordinates a lane cover the row.
    for k in range(1, simplex_qp.MAX_K + 1):
        team = simplex_qp.team_width(k)
        assert 1 <= team <= 32 and team & (team - 1) == 0, (k, team)
        assert math.ceil(k / team) * team >= k


def test_team_width_rule_is_instantiated():
    # csrc/simplex_qp.cu builds, for both dtypes, the (team, NC) pairs
    # marked RULE in SIMPLEX_QP_PAIRS, and a launch takes the first pair
    # of its team width with NC >= ceil(k / team): every k has one, and
    # every RULE pair serves some k.
    source = simplex_qp.PACKED_SOURCE.read_text()
    # The macro and its continued lines.
    listed = re.search(r"#define SIMPLEX_QP_PAIRS\(RULE, SWEEP\)"
                       r"((?:.*\\\n)*.*)", source).group(1)
    rule = [(int(a), int(b))
            for a, b in re.findall(r"\bRULE\((\d+), (\d+)\)", listed)]
    assert rule == sorted(rule)
    used = set()
    for k in range(1, simplex_qp.MAX_K + 1):
        team = simplex_qp.team_width(k)
        fits = [p for p in rule
                if p[0] == team and p[1] >= math.ceil(k / team)]
        assert fits, k
        used.add(fits[0])
    assert used == set(rule)

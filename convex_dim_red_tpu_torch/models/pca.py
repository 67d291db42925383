"""Principal component analysis (EOF analysis) in PyTorch.

Port of convex_dim_red_tpu/models/pca.py: the economy SVD of the
centred data matrix, or, for the very wide matrices of climate grids
(``n_features > 4 n_samples`` under ``use_gram='auto'``), the
eigendecomposition of the ``n x n`` Gram matrix.  The data's device is
set by the estimator's ``device`` (see
:func:`utils.validation.as_input`): a numpy array goes to the card
unless ``device='cpu'``.  Eigenvector signs are arbitrary, as in the
JAX package; nothing downstream depends on them.  ``PCA(mesh=...)``
runs ``parallel.sharded_models.sharded_pca``: the Gram path with the
features split over the mesh's sample axis.
"""

import numpy as np
import torch

from ..utils.precision import apply_matmul_precision
from ..utils.validation import as_input
from ._common import _check_mesh, _fit_device, prepare_estimator_mesh

__all__ = ["PCA", "pca_fit"]


@apply_matmul_precision
def pca_fit(X, *, n_components, center=True, use_gram=False):
    """Fit PCA; returns ``(components, explained_variance, mean,
    scores)``, tensors on ``X``'s device.

    ``use_gram=True`` takes the eigendecomposition of the ``n x n`` Gram
    matrix instead of the SVD of the ``n x d`` data: one product and a
    small ``eigh``, cheaper when ``n_features >> n_samples``.
    """
    X = torch.as_tensor(X)
    n_samples = X.shape[0]
    mean = (X.mean(dim=0) if center
            else torch.zeros((X.shape[1],), dtype=X.dtype, device=X.device))
    Xc = X - mean[None, :]

    if use_gram:
        evals, evecs = torch.linalg.eigh(Xc @ Xc.T)  # ascending
        evals = evals.flip(0)[:n_components]
        evecs = evecs.flip(1)[:, :n_components]
        svals = torch.sqrt(torch.clamp(evals, min=0.0))
        safe = torch.clamp(svals, min=torch.finfo(X.dtype).tiny)
        components = (Xc.T @ (evecs / safe[None, :])).T
        scores = evecs * svals[None, :]
    else:
        U, S, Vh = torch.linalg.svd(Xc, full_matrices=False)
        svals = S[:n_components]
        components = Vh[:n_components]
        scores = U[:, :n_components] * svals[None, :]

    explained_variance = svals ** 2 / max(n_samples - 1, 1)
    return components, explained_variance, mean, scores


class PCA:
    """Principal component analysis with the sklearn-style surface of
    the JAX package's estimator: ``fit`` / ``transform`` /
    ``fit_transform`` / ``inverse_transform``, ``components_``,
    ``explained_variance_``, ``explained_variance_ratio_``, ``mean_``,
    ``singular_values_`` and ``noise_variance_``.  ``tol`` and
    ``random_state`` are accepted for parity and unused (the SVD and
    ``eigh`` are exact).  ``device``: where the data goes (see the
    module docstring); ``mesh`` (a DeviceMesh whose restart axis has
    size 1) fits on the Gram path with the features split over its
    sample axis, on the mesh's device."""

    def __init__(self, n_components, center=True, use_gram='auto',
                 tol=0.0, random_state=None, mesh=None, device=None):
        _check_mesh(mesh)
        self.n_components = n_components
        self.center = center
        self.use_gram = use_gram
        self.mesh = mesh
        self.device = device
        self.tol = tol
        self.random_state = random_state

        self.components_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.mean_ = None
        self.singular_values_ = None
        self.noise_variance_ = None

    def fit(self, X):
        self.fit_transform(X)
        return self

    def fit_transform(self, X):
        X = as_input(X, _fit_device(self.mesh, self.device))
        n_samples, n_features = X.shape
        if self.mesh is not None:
            components, explained, mean, scores = self._fit_sharded(X)
        else:
            use_gram = (n_features > 4 * n_samples
                        if self.use_gram == 'auto'
                        else bool(self.use_gram))
            components, explained, mean, scores = pca_fit(
                X, n_components=int(self.n_components),
                center=self.center, use_gram=use_gram)
        self.components_ = components
        self.explained_variance_ = explained.cpu().numpy()
        self.mean_ = mean
        self.singular_values_ = np.sqrt(
            self.explained_variance_ * max(n_samples - 1, 1))

        total_var = float(torch.sum(torch.var(X, dim=0, correction=1)))
        self.explained_variance_ratio_ = (
            self.explained_variance_ / total_var if total_var > 0
            else self.explained_variance_ * 0.0)

        # sklearn's noise variance: the mean variance of the discarded
        # components.
        rank_bound = min(n_samples, n_features)
        if self.n_components < rank_bound:
            self.noise_variance_ = float(
                (total_var - self.explained_variance_.sum())
                / (rank_bound - self.n_components))
        else:
            self.noise_variance_ = 0.0
        return scores

    def _fit_sharded(self, X):
        """The Gram-path fit with the features split over the mesh."""
        # Deferred: parallel imports models.
        from ..parallel.sharded_models import sharded_pca

        mesh = prepare_estimator_mesh(self.mesh, X.shape[1],
                                      'PCA(mesh=...)',
                                      dim_name='n_features')
        res = sharded_pca(mesh, X, n_components=int(self.n_components),
                          center=self.center)
        return (res['components'], res['explained_variance'],
                res['mean'], res['scores'])

    @apply_matmul_precision
    def transform(self, X):
        X = as_input(X, _fit_device(self.mesh, self.device))
        return (X - self.mean_[None, :]) @ self.components_.T

    @apply_matmul_precision
    def inverse_transform(self, scores):
        """Map scores back to data space (an array goes to the
        components' device)."""
        scores = torch.as_tensor(scores, device=self.components_.device)
        return scores @ self.components_ + self.mean_[None, :]

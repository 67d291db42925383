"""FurthestSum initialization (Morup & Hansen, Neurocomputing 80 (2012)).

Port of convex_dim_red_tpu/ops/furthest_sum.py: greedy
max-dissimilarity-sum seed selection with drop-and-reselect refinement
passes, in the dense design of the JAX package (a length-``n`` running
distance-sum vector plus an active-candidate mask, so each selection
step is a masked argmax and a rank-1 sum update).

- :func:`furthest_sum`: host NumPy, with the reference's input
  validation and error messages; the estimators' initializer.
- :func:`furthest_sum_device`: the same greedy in torch on the
  dissimilarities' device, for a batch of start indices at once (one
  row of selections per restart of ``aa_fit_restarts``).

Both take the first maximum on ties, as the JAX versions do.
"""

import numpy as np
import torch

__all__ = ["furthest_sum", "furthest_sum_device",
           "dissimilarities_from_kernel"]


def dissimilarities_from_kernel(kernel):
    """Pairwise distances ``d_ij = sqrt(K_ii - 2 K_ij + K_jj)`` from a
    Gram matrix, clamped at zero against negative round-off."""
    diag = torch.diagonal(kernel)
    sq = diag[None, :] - 2.0 * kernel + diag[:, None]
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _validate(dissimilarity_matrix, n_components, start_index, exclude):
    if isinstance(dissimilarity_matrix, torch.Tensor):
        dissimilarity_matrix = dissimilarity_matrix.detach().cpu()
    d = np.asarray(dissimilarity_matrix)
    if d.ndim != 2 or d.shape[0] != d.shape[1]:
        raise ValueError(
            'Dissimilarity matrix must be square, but got shape %r' %
            list(d.shape))

    n_samples = d.shape[0]

    if start_index >= n_samples:
        raise ValueError('Start index %r is out of bounds (n_samples = %d)' %
                         (start_index, n_samples))

    exclude = np.asarray([] if exclude is None else exclude, dtype=np.int64)
    if np.any(exclude == start_index):
        raise ValueError('Start index %r is excluded' % start_index)

    n_excluded = exclude.size
    if n_excluded < n_samples and n_components > n_samples - n_excluded:
        raise ValueError(
            'Too few points available to select requested number of '
            'components (n_components=%d, n_samples=%d, n_excluded=%d)' %
            (n_components, n_samples, n_excluded))

    return d, exclude


def furthest_sum(dissimilarity_matrix, n_components, start_index,
                 exclude=None, extra_steps=1):
    """Select ``n_components`` mutually furthest sample indices.

    ``dissimilarity_matrix``: (n, n) array or tensor (read on the host).
    Parameters and error behaviour match the JAX package's (and the
    reference's).  Returns an int64 array of shape (n_components,).
    """
    d, exclude = _validate(dissimilarity_matrix, n_components, start_index,
                           exclude)

    if n_components == 0:
        return np.array([], dtype=np.int64)

    n_samples = d.shape[0]

    # active[i]: i is a selectable candidate; sums[i]: sum of distances
    # from i to every currently selected index (maintained only while
    # i is active).
    active = np.ones(n_samples, dtype=bool)
    active[exclude] = False
    active[start_index] = False

    selected = np.full(n_components, start_index, dtype=np.int64)
    sums = d[:, start_index].astype(np.float64).copy()

    def pick():
        nonlocal sums
        masked = np.where(active, sums, -np.inf)
        idx = int(np.argmax(masked))
        active[idx] = False
        sums = sums + d[:, idx]
        return idx

    for i in range(1, n_components):
        selected[i] = pick()

    for step in range(extra_steps):
        update_index = step % n_components
        r = selected[update_index]

        # Drop r from the selected set: remove its distance contribution
        # and make it a candidate again with a freshly computed sum.
        sums -= d[:, r]
        others = selected[selected != r]
        sums[r] = d[r, others].sum()
        active[r] = True

        selected[update_index] = pick()

    return selected


def furthest_sum_device(dissimilarities, n_components, start_index,
                        extra_steps=10, exclude_mask=None):
    """FurthestSum on a dissimilarity tensor, on its device.

    ``start_index``: an int or a 0-d tensor (returns (n_components,)),
    or a (R,) tensor of start indices (returns (R, n_components), one
    independent selection per start: the restart axis of
    ``aa_fit_restarts``).  ``exclude_mask``: optional (n,) bool tensor
    of excluded samples.  Running sums are kept in the dissimilarities'
    dtype, as in the JAX version.  Returns int64 indices.
    """
    d = dissimilarities
    n = d.shape[0]
    starts = torch.as_tensor(start_index, dtype=torch.long,
                             device=d.device)
    batched = starts.ndim == 1
    starts = starts.reshape(-1)
    rows = torch.arange(starts.shape[0], device=d.device)
    # Column j of d as a contiguous row: d[:, j] == cols[j].
    cols = d.T.contiguous()

    active = torch.ones((starts.shape[0], n), dtype=torch.bool,
                        device=d.device)
    if exclude_mask is not None:
        active &= ~torch.as_tensor(exclude_mask, dtype=torch.bool,
                                   device=d.device)
    active[rows, starts] = False
    selected = starts[:, None].repeat(1, n_components)
    sums = cols[starts]
    neg = torch.tensor(-float("inf"), dtype=d.dtype, device=d.device)

    def pick(sums):
        idx = torch.argmax(torch.where(active, sums, neg), dim=1)
        active[rows, idx] = False
        return idx, sums + cols[idx]

    for i in range(1, n_components):
        selected[:, i], sums = pick(sums)

    for step in range(extra_steps):
        update_index = step % n_components
        r = selected[:, update_index]
        sums = sums - cols[r]
        # Sum of distances from r to the other selected indices.
        is_other = selected != r[:, None]
        r_sum = torch.sum(torch.where(is_other, d[r[:, None], selected],
                                      0.0), dim=1)
        sums[rows, r] = r_sum
        active[rows, r] = True
        selected[:, update_index], sums = pick(sums)

    return selected if batched else selected[0]

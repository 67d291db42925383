"""The JRA-55 500 hPa height grid reduced to its principal components.

A frozen numpy copy of the arithmetic of
``convex_dim_red_tpu_torch.pipelines.synthetic.synthetic_jra55``
(``kind='grid'``, itself a copy of ``bin/make_synthetic_jra55.py``) and
of the drivers' preparation (latitude band, ``scos`` weights, flatten,
chronological split), followed by the benchmark's own PCA: a float64
Gram of the centred training months and ``numpy.linalg.eigh``.  Every
month of the grid is projected on the EOFs, as the PC drivers read the
PCs with none held out.
"""

import numpy as np


def grid(seed, *, n_years, n_lat, n_lon):
    """The gridded anomalies (months, lat, lon) float32 and the
    latitudes, drawn as ``synthetic_jra55`` draws them."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(int(seed) % 2 ** 32)
    n_t = n_years * 12
    lats = np.linspace(90.0, -90.0, n_lat)
    k = 4
    modes = np.stack([gaussian_filter(rng.standard_normal((n_lat, n_lon)),
                                      sigma=4) for _ in range(k)])
    pcs = rng.standard_normal((n_t, k)) * np.array([40, 25, 15, 10])
    anom = np.tensordot(pcs, modes, axes=(1, 0)) \
        + 5.0 * rng.standard_normal((n_t, n_lat, n_lon))
    return anom.astype('f4'), lats


def prepared(seed, *, n_years, n_lat, n_lon, min_latitude, max_latitude,
             validation_frac):
    """The drivers' float64 training and held-out rows of the weighted,
    flattened band (``cli/common.py:load_field``,
    ``cli/drivers.py:_prepare``)."""
    field, lats = grid(seed, n_years=n_years, n_lat=n_lat, n_lon=n_lon)
    band = (lats >= min_latitude) & (lats <= max_latitude)
    weights = np.clip(np.cos(np.deg2rad(lats[band])), 0.0, 1.0) ** 0.5
    flat = (field[:, band] * weights[:, None]).reshape(field.shape[0], -1)
    n_train = int(np.ceil((1 - validation_frac) * flat.shape[0]))
    return flat[:n_train], flat[n_train:]


def make(seed, *, n_years, n_lat, n_lon, min_latitude, max_latitude,
         validation_frac, n_eofs):
    """``{"X": PCs}``: every month projected on the ``n_eofs`` leading
    EOFs of the training months (float64, months x n_eofs)."""
    train, held = prepared(seed, n_years=n_years, n_lat=n_lat, n_lon=n_lon,
                           min_latitude=min_latitude,
                           max_latitude=max_latitude,
                           validation_frac=validation_frac)
    mean = train.mean(axis=0)
    centred = train - mean
    evals, evecs = np.linalg.eigh(centred @ centred.T)
    order = np.argsort(evals)[::-1][:n_eofs]
    eofs = (evecs[:, order].T @ centred) / np.sqrt(evals[order])[:, None]
    months = np.concatenate([train, held]) - mean
    return {"X": months @ eofs.T}

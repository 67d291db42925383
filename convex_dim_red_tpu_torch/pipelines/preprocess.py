"""Climate-data preprocessing: anomalies, weighting, flattening, splits.

NumPy implementations of the preprocessing pipeline the reference keeps
in its notebooks (notebooks/hadisst_sst_anom.ipynb): centered
moving-average trend estimate (half-weight endpoints), base-period
seasonal cycle of the detrended data, polynomial trend re-fit on the
deseasonalized data, and per-calendar-month standardization — plus the
latitude weighting / flatten / NaN-mask / chronological-split template
shared by every driver (reference bin/run_hadisst_aa.py:112-146,
198-209).  The per-feature ``linregress`` loop of the notebook is
replaced by one vectorized least-squares solve across all features.
A copy of convex_dim_red_tpu/pipelines/preprocess.py, kept in the port
so that it never imports the JAX package.
"""

import numpy as np

__all__ = [
    "latitude_weights",
    "weight_and_flatten",
    "missing_feature_mask",
    "restore_missing_features",
    "train_validation_split",
    "moving_average_trend",
    "calculate_seasonal_cycle",
    "calculate_polynomial_trend",
    "calculate_monthly_anomalies",
    "standardize_by_month",
]


def latitude_weights(lats, kind="scos"):
    """'none' | 'cos' | 'scos' (sqrt-cos) latitude weights
    (reference bin/run_hadisst_aa.py:112-124)."""
    lats = np.asarray(lats, dtype=float)
    if kind == "cos":
        return np.clip(np.cos(np.deg2rad(lats)), 0.0, 1.0)
    if kind == "scos":
        return np.clip(np.cos(np.deg2rad(lats)), 0.0, 1.0) ** 0.5
    if kind == "none":
        return np.ones_like(lats)
    raise ValueError("Invalid weights descriptor '%r'" % kind)


def weight_and_flatten(data, weights=None):
    """Apply broadcastable weights and flatten feature dims to 2-D
    (n_samples, n_features); the sample axis is axis 0."""
    data = np.asarray(data)
    if weights is not None:
        data = data * weights
    return data.reshape(data.shape[0], -1)


def missing_feature_mask(flat_data):
    """Boolean mask of feature columns containing any NaN."""
    return np.any(np.isnan(flat_data), axis=0)


def restore_missing_features(valid_values, missing_mask):
    """Re-embed (k, n_valid) values into (k, n_features) with NaN."""
    valid_values = np.asarray(valid_values)
    k = valid_values.shape[0]
    full = np.full((k, missing_mask.size), np.nan,
                   dtype=valid_values.dtype
                   if np.issubdtype(valid_values.dtype, np.floating)
                   else float)
    full[:, ~missing_mask] = valid_values
    return full


def train_validation_split(data, validation_frac=0.1):
    """Chronological split: first ceil((1-frac) n) samples train."""
    n_samples = data.shape[0]
    n_train = int(np.ceil((1 - validation_frac) * n_samples))
    return data[:n_train], data[n_train:], n_train


def moving_average_trend(data, period=12):
    """Centered moving average with half-weight endpoints for even
    periods; NaN where the window is incomplete."""
    data = np.asarray(data, dtype=float)
    n = data.shape[0]
    if period % 2 == 0:
        w = np.ones(period + 1)
        w[0] = w[-1] = 0.5
        w /= period
    else:
        w = np.ones(period) / period
    width = w.size
    half = width // 2

    out = np.full(data.shape, np.nan)
    flat = data.reshape(n, -1)
    res = np.full(flat.shape, np.nan)
    for offset in range(width):
        seg = flat[offset:n - (width - 1 - offset)]
        if offset == 0:
            acc = w[0] * seg
        else:
            acc = acc + w[offset] * seg
    res[half:n - half] = acc
    out = res.reshape(data.shape)
    return out


def calculate_seasonal_cycle(data, years, period=12,
                             base_period_start_year=None,
                             base_period_end_year=None):
    """Seasonal cycle as base-period means per cycle position of the
    (detrended) data, centered by the all-position mean; tiled to the
    full record (notebook ``calculate_seasonal_cycle``).

    Returns ``(seasonal_cycle, (start_year, end_year))``.
    """
    data = np.asarray(data, dtype=float)
    years = np.asarray(years)
    n = data.shape[0]

    if base_period_start_year is None:
        base_period_start_year = int(years.min())
    if base_period_end_year is None:
        base_period_end_year = int(years.max())

    boundary = period // 2 if period % 2 == 0 else (period - 1) // 2

    values = np.empty((period,) + data.shape[1:])
    for k in range(period):
        start = k + period if k < boundary else k
        idx = np.arange(start, n, period)
        sel = idx[(years[idx] >= base_period_start_year)
                  & (years[idx] <= base_period_end_year)]
        with np.errstate(invalid="ignore"):
            values[k] = np.nanmean(data[sel], axis=0)

    values -= np.nanmean(values, axis=0, keepdims=True)

    cycle = values[np.arange(n) % period]
    return cycle, (base_period_start_year, base_period_end_year)


def calculate_polynomial_trend(data, trend_order=1):
    """Least-squares polynomial trend per feature, vectorized.

    Returns a dict with ``fitted_value`` (same shape as data) and the
    coefficient arrays (``slope``/``intcpt`` for order 1, else
    ``parameters``); NaN features stay NaN (notebook
    ``calculate_polynomial_trend``, linregress loop vectorized away).
    """
    data = np.asarray(data, dtype=float)
    n = data.shape[0]
    flat = data.reshape(n, -1)
    missing = np.any(np.isnan(flat), axis=0)

    t = np.arange(n, dtype=float)
    # Vandermonde columns [1, t, t^2, ...]
    V = np.vander(t, trend_order + 1, increasing=True)

    filled = np.where(np.isnan(flat), 0.0, flat)
    coeffs, *_ = np.linalg.lstsq(V, filled, rcond=None)
    coeffs[:, missing] = np.nan

    fitted = V @ coeffs
    fitted[:, missing] = np.nan

    out = {
        "fitted_value": fitted.reshape(data.shape),
        "parameters": coeffs.T.reshape(data.shape[1:] + (trend_order + 1,)),
    }
    if trend_order == 1:
        out["intcpt"] = coeffs[0].reshape(data.shape[1:])
        out["slope"] = coeffs[1].reshape(data.shape[1:])
    return out


def calculate_monthly_anomalies(data, years, period=12, trend_order=1,
                                base_period_start_year=None,
                                base_period_end_year=None):
    """Detrend + deseasonalize monthly data (notebook
    ``calculate_monthly_anomalies``).

    Returns ``(anomalies, trend_dict, seasonal_cycle, base_period)``.
    """
    data = np.asarray(data, dtype=float)

    mt_hat = moving_average_trend(data, period=period)
    seasonal_cycle, base_period = calculate_seasonal_cycle(
        data - mt_hat, years, period=period,
        base_period_start_year=base_period_start_year,
        base_period_end_year=base_period_end_year)

    deseasonalized = data - seasonal_cycle
    trend = calculate_polynomial_trend(deseasonalized,
                                       trend_order=trend_order)
    anomalies = deseasonalized - trend["fitted_value"]
    return anomalies, trend, seasonal_cycle, base_period


def standardize_by_month(anomalies, months, years, base_period):
    """Per-calendar-month standardization over the base period
    (notebook std-anomaly cell)."""
    anomalies = np.asarray(anomalies, dtype=float)
    months = np.asarray(months)
    years = np.asarray(years)
    in_base = (years >= base_period[0]) & (years <= base_period[1])

    out = np.empty_like(anomalies)
    for m in np.unique(months):
        sel = months == m
        base_sel = sel & in_base
        with np.errstate(invalid="ignore"):
            mean = np.nanmean(anomalies[base_sel], axis=0)
            std = np.nanstd(anomalies[base_sel], axis=0)
        out[sel] = (anomalies[sel] - mean) / std
    return out

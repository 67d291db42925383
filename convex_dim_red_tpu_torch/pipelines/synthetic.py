"""Synthetic HadISST- and JRA-55-schema datasets.

Copies of bin/make_synthetic_hadisst.py and bin/make_synthetic_jra55.py,
kept in the port so that it never imports the JAX package: the same
draws from ``numpy.random.RandomState(seed)`` in the same order, the
same variables, dims and attrs, in the port's :class:`~.dataset.Dataset`
(numpy and ``scipy.ndimage.gaussian_filter``).  Run as::

    python -m convex_dim_red_tpu_torch.pipelines.synthetic hadisst out.nc \
        [--start-year Y] [--n-years N] [--n-lat N] [--n-lon N] \
        [--land-frac F] [--seed S]
    python -m convex_dim_red_tpu_torch.pipelines.synthetic jra55 out.nc \
        [--kind grid|pcs] [--start-year Y] [--n-years N] [--n-lat N] \
        [--n-lon N] [--n-modes N] [--seed S]

with the bin scripts' flags and defaults.  Writing netCDF needs
``h5py`` (or ``xarray``); :func:`synthetic_hadisst` and
:func:`synthetic_jra55` build the dataset in memory.
"""

import argparse
import sys

import numpy as np

from .dataset import Dataset, Variable

__all__ = ["synthetic_hadisst", "synthetic_jra55", "main"]


def synthetic_hadisst(start_year=1870, n_years=149, n_lat=180, n_lon=360,
                      land_frac=0.3, seed=0):
    """A HadISST-schema monthly SST field ``sst`` (float32, degC) over
    ``(time, latitude, longitude)``: a latitude-scaled base and seasonal
    cycle, a linear trend, five smoothed large-scale modes, noise, and
    land blobs (``land_frac`` of the cells) set to NaN.  Time is in days
    since ``start_year``-1-1 (30.4375-day months)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    n_t = n_years * 12
    lats = np.linspace(89.5, -89.5, n_lat)
    lons = np.linspace(-179.5, 179.5, n_lon)

    t = np.arange(n_t)
    month = t % 12

    # Seasonal cycle scaled by |latitude|, hemisphere-antisymmetric.
    seasonal = (np.cos(2 * np.pi * (month[:, None] - 1) / 12)[..., None]
                * np.sign(lats)[None, :, None]
                * (np.abs(lats) / 90.0)[None, :, None]
                * np.ones(n_lon)[None, None, :]) * 5.0
    trend = 0.8 * (t / n_t)[:, None, None]
    base = 20.0 * np.cos(np.deg2rad(lats))[None, :, None]

    # Low-rank anomaly structure (a few large-scale modes).
    k = 5
    modes = rng.standard_normal((k, n_lat, n_lon))
    modes = np.stack([gaussian_filter(m, sigma=8) for m in modes])
    pcs = rng.standard_normal((n_t, k)) * np.array([3, 2, 1.5, 1, 0.8])
    anom = np.tensordot(pcs, modes, axes=(1, 0))
    noise = 0.2 * rng.standard_normal((n_t, n_lat, n_lon))

    sst = base + seasonal + trend + anom + noise

    # Land mask: random blobs.
    land = gaussian_filter(rng.standard_normal((n_lat, n_lon)), sigma=6)
    thresh = np.quantile(land, 1 - land_frac)
    sst[:, land > thresh] = np.nan

    time = np.round(np.arange(n_t) * 30.4375).astype('f8')
    return Dataset(
        data_vars={'sst': Variable(('time', 'latitude', 'longitude'),
                                   sst.astype('f4'), {'units': 'degC'})},
        coords={
            'time': Variable(('time',), time,
                             {'units': 'days since %d-1-1' % start_year}),
            'latitude': Variable(('latitude',), lats,
                                 {'units': 'degrees_north'}),
            'longitude': Variable(('longitude',), lons,
                                  {'units': 'degrees_east'}),
        },
        attrs={'title': 'synthetic HadISST-schema SST'})


def synthetic_jra55(kind='grid', start_year=1958, n_years=20, n_lat=36,
                    n_lon=72, n_modes=30, seed=0):
    """A JRA-55-schema hgt500 product on a monthly axis in hours since
    ``start_year``-1-1: ``kind='grid'`` the gridded anomalies
    ``HGT_GDS0_ISBL_anom`` (float32, gpm) over ``(initial_time0_hours,
    g0_lat_2, g0_lon_3)``, four smoothed modes plus noise, latitudes from
    90 to -90; ``kind='pcs'`` the principal components ``PCs`` (float64)
    over ``(initial_time0_hours, mode)`` with the ``eofs_*_year`` attrs
    the PC drivers read."""
    rng = np.random.RandomState(seed)
    n_t = n_years * 12
    time = np.arange(n_t) * 730.5  # ~hourly CF axis, monthly spacing
    time_var = Variable(('initial_time0_hours',), time.astype('f8'),
                        {'units': 'hours since %d-1-1' % start_year})

    if kind == 'grid':
        from scipy.ndimage import gaussian_filter
        lats = np.linspace(90.0, -90.0, n_lat)
        lons = np.linspace(0.0, 360.0 - 360.0 / n_lon, n_lon)
        k = 4
        modes = np.stack([gaussian_filter(
            rng.standard_normal((n_lat, n_lon)), sigma=4)
            for _ in range(k)])
        pcs = rng.standard_normal((n_t, k)) * np.array([40, 25, 15, 10])
        anom = np.tensordot(pcs, modes, axes=(1, 0)) \
            + 5.0 * rng.standard_normal((n_t, n_lat, n_lon))
        return Dataset(
            data_vars={'HGT_GDS0_ISBL_anom': Variable(
                ('initial_time0_hours', 'g0_lat_2', 'g0_lon_3'),
                anom.astype('f4'), {'units': 'gpm'})},
            coords={
                'initial_time0_hours': time_var,
                'g0_lat_2': Variable(('g0_lat_2',), lats,
                                     {'units': 'degrees_north'}),
                'g0_lon_3': Variable(('g0_lon_3',), lons,
                                     {'units': 'degrees_east'}),
            },
            attrs={'title': 'synthetic JRA-55-schema hgt500 anomalies'})
    if kind != 'pcs':
        raise ValueError("kind must be 'grid' or 'pcs', got %r" % (kind,))
    variance = 100.0 / (1.0 + np.arange(n_modes))
    pcs = rng.standard_normal((n_t, n_modes)) * np.sqrt(variance)
    return Dataset(
        data_vars={'PCs': Variable(('initial_time0_hours', 'mode'),
                                   pcs.astype('f8'))},
        coords={
            'initial_time0_hours': time_var,
            'mode': Variable(('mode',), np.arange(n_modes)),
        },
        attrs={'title': 'synthetic JRA-55 hgt500 PCs',
               'eofs_start_year': str(start_year),
               'eofs_end_year': str(start_year + n_years - 1)})


def _hadisst_main(argv):
    parser = argparse.ArgumentParser(
        prog='python -m convex_dim_red_tpu_torch.pipelines.synthetic '
             'hadisst',
        description='Generate a synthetic HadISST-schema SST dataset')
    parser.add_argument('output_file')
    parser.add_argument('--start-year', type=int, default=1870)
    parser.add_argument('--n-years', type=int, default=149)
    parser.add_argument('--n-lat', type=int, default=180)
    parser.add_argument('--n-lon', type=int, default=360)
    parser.add_argument('--land-frac', type=float, default=0.3)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    ds = synthetic_hadisst(args.start_year, args.n_years, args.n_lat,
                           args.n_lon, args.land_frac, args.seed)
    ds.to_netcdf(args.output_file)
    print('wrote', args.output_file, 'shape', ds['sst'].data.shape)


def _jra55_main(argv):
    parser = argparse.ArgumentParser(
        prog='python -m convex_dim_red_tpu_torch.pipelines.synthetic jra55',
        description='Generate synthetic JRA-55-schema datasets')
    parser.add_argument('output_file')
    parser.add_argument('--kind', choices=['grid', 'pcs'], default='grid')
    parser.add_argument('--start-year', type=int, default=1958)
    parser.add_argument('--n-years', type=int, default=20)
    parser.add_argument('--n-lat', type=int, default=36)
    parser.add_argument('--n-lon', type=int, default=72)
    parser.add_argument('--n-modes', type=int, default=30)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    synthetic_jra55(args.kind, args.start_year, args.n_years, args.n_lat,
                    args.n_lon, args.n_modes, args.seed).to_netcdf(
                        args.output_file)
    print('wrote', args.output_file)


_GENERATORS = {'hadisst': _hadisst_main, 'jra55': _jra55_main}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in _GENERATORS:
        print('usage: python -m convex_dim_red_tpu_torch.pipelines.'
              'synthetic {hadisst,jra55} output_file [flags]',
              file=sys.stderr)
        return 2
    _GENERATORS[argv[0]](argv[1:])
    return 0


if __name__ == '__main__':
    sys.exit(main())

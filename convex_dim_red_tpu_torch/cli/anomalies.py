"""Anomaly-preprocessing CLI.

The reference computes SST anomalies inside a notebook
(notebooks/hadisst_sst_anom.ipynb): moving-average trend estimate →
base-period seasonal cycle → polynomial trend re-fit → anomalies, plus
per-calendar-month standardized anomalies.  This driver runs that
pipeline from the command line and writes the ``*_anom`` /
``*_std_anom`` dataset every other driver consumes.  A copy of
convex_dim_red_tpu/cli/anomalies.py (numpy only), run as ``python -m
convex_dim_red_tpu_torch.cli.anomalies in.nc out.nc``.
"""

import argparse

import numpy as np

from ..pipelines.dataset import Dataset, Variable, decode_cf_time, \
    open_dataset
from ..pipelines.preprocess import (calculate_monthly_anomalies,
                                    standardize_by_month)


def anomalies_main(argv=None, *, time_name='time', var_name='sst',
                   min_valid=-1000.0):
    parser = argparse.ArgumentParser(
        description='Compute monthly anomalies from a raw field')
    parser.add_argument('input_file')
    parser.add_argument('output_file')
    parser.add_argument('--var-name', default=var_name)
    parser.add_argument('--time-name', default=time_name)
    parser.add_argument('--base-period-start-year', type=int, default=None)
    parser.add_argument('--base-period-end-year', type=int, default=None)
    parser.add_argument('--trend-order', type=int, default=1)
    parser.add_argument('--period', type=int, default=12,
                        help='seasonal cycle period (months)')
    parser.add_argument('--min-valid', type=float, default=min_valid,
                        help='values below this are treated as missing '
                             '(e.g. HadISST ice flag -1000)')
    args = parser.parse_args(argv)

    ds = open_dataset(args.input_file)
    var = ds[args.var_name]
    years, months = decode_cf_time(ds.coords[args.time_name])

    data = np.asarray(var.data, dtype=float)
    data = np.where(data <= args.min_valid, np.nan, data)

    anomalies, trend, seasonal_cycle, base_period = (
        calculate_monthly_anomalies(
            data, years, period=args.period, trend_order=args.trend_order,
            base_period_start_year=args.base_period_start_year,
            base_period_end_year=args.base_period_end_year))

    std_anomalies = standardize_by_month(anomalies, months, years,
                                         base_period)

    out = Dataset(
        data_vars={
            args.var_name + '_anom': Variable(var.dims, anomalies),
            args.var_name + '_std_anom': Variable(var.dims, std_anomalies),
        },
        coords=ds.coords,
        attrs={
            'input_file': args.input_file,
            'base_period_start_year': '{:d}'.format(base_period[0]),
            'base_period_end_year': '{:d}'.format(base_period[1]),
            'trend_order': '{:d}'.format(args.trend_order),
            'seasonal_cycle_period': '{:d}'.format(args.period),
        })
    out.to_netcdf(args.output_file)


if __name__ == '__main__':
    anomalies_main()

"""Dataset specifications for the case-study drivers.

Constants mirrored from the reference drivers (bin/run_hadisst_*.py:20-47,
bin/run_jra55_*.py:20-32).  A copy of convex_dim_red_tpu/cli/specs.py,
kept in the port so that it never imports the JAX package.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class FieldSpec:
    time_name: str
    var_name: str
    std_var_name: str = None
    lat_name: str = None
    lon_name: str = None
    start_year: int = None
    end_year: int = None
    min_latitude: float = None
    max_latitude: float = None
    default_lat_weights: str = 'none'
    validation_frac: float = 0.1


HADISST = FieldSpec(
    time_name='time',
    var_name='sst_anom',
    std_var_name='sst_std_anom',
    lat_name='latitude',
    lon_name='longitude',
    start_year=1870,
    end_year=2018,
    min_latitude=-45.5,
    max_latitude=45.5,
    default_lat_weights='scos',
)

JRA55_HGT = FieldSpec(
    time_name='initial_time0_hours',
    var_name='HGT_GDS0_ISBL_anom',
    std_var_name='HGT_GDS0_ISBL_std_anom',
    lat_name='g0_lat_2',
    lon_name='g0_lon_3',
    start_year=1958,
    end_year=2018,
    min_latitude=20.0,
    max_latitude=90.0,
    default_lat_weights='scos',
)

JRA55_PCS = FieldSpec(
    time_name='initial_time0_hours',
    var_name='PCs',
    start_year=1870,
    end_year=2018,
    validation_frac=0.0,
)

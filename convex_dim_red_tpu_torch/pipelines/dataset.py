"""Minimal self-contained dataset container + netCDF4 (HDF5) IO.

A copy of convex_dim_red_tpu/pipelines/dataset.py (numpy only), kept
in the port so that it never imports the JAX package.  The reference's
drivers are built on xarray/netCDF4, but netCDF4 files are HDF5 files,
so ``h5py`` can read and write them.  This module provides a small
xarray-like ``Dataset`` (named dims, coords, attrs) sufficient for the
case-study pipelines, with CF-time decoding for the year/month filters
the drivers need.  If xarray is importable it is used for IO fidelity.
``h5py`` and ``xarray`` are imported only by the functions that read or
write a file, so importing this module needs neither.
"""

import datetime
import re

import numpy as np

__all__ = ["Variable", "Dataset", "open_dataset", "decode_cf_time"]


def _xarray():
    """xarray where it is installed, else None."""
    try:
        import xarray
    except ImportError:
        return None
    return xarray


class Variable:
    """A named array with dimension names and attributes."""

    def __init__(self, dims, data, attrs=None):
        self.dims = tuple(dims)
        self.data = np.asarray(data)
        self.attrs = dict(attrs or {})

    def __repr__(self):
        return f"Variable(dims={self.dims}, shape={self.data.shape})"


class Dataset:
    """Dict-of-variables container with named dimensions.

    Supports the subset of the xarray surface the drivers use:
    ``ds[name]``, ``ds.attrs``, ``ds.dims``, ``ds.coords``,
    ``sel_time_years``/``sel_range`` filters, and ``to_netcdf``.
    """

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars = dict(data_vars or {})
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, name):
        if name in self.data_vars:
            return self.data_vars[name]
        if name in self.coords:
            return self.coords[name]
        raise KeyError(name)

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    @property
    def dims(self):
        sizes = {}
        for v in list(self.data_vars.values()) + list(self.coords.values()):
            for d, s in zip(v.dims, v.data.shape):
                sizes[d] = s
        return sizes

    # -- filtering ---------------------------------------------------------

    def isel(self, dim, indexer):
        """Integer-index along one dimension (returns a new Dataset)."""
        def take(var):
            if dim not in var.dims:
                return var
            axis = var.dims.index(dim)
            return Variable(var.dims, np.take(var.data, indexer, axis=axis),
                            var.attrs)

        return Dataset({k: take(v) for k, v in self.data_vars.items()},
                       {k: take(v) for k, v in self.coords.items()},
                       self.attrs)

    def sel_range(self, coord_name, vmin, vmax):
        """Keep indices where coord in [vmin, vmax]."""
        coord = self.coords[coord_name]
        if len(coord.dims) != 1:
            raise ValueError("sel_range needs a 1-D coordinate")
        mask = (coord.data >= vmin) & (coord.data <= vmax)
        return self.isel(coord.dims[0], np.where(mask)[0])

    def sel_time_years(self, time_name, start_year, end_year):
        """Keep samples whose decoded calendar year is in range."""
        years, _ = decode_cf_time(self.coords[time_name])
        mask = (years >= start_year) & (years <= end_year)
        return self.isel(self.coords[time_name].dims[0], np.where(mask)[0])

    # -- IO ----------------------------------------------------------------

    def to_netcdf(self, path):
        xr = _xarray()
        if xr is not None:
            self._to_xarray(xr).to_netcdf(path)
            return
        import h5py

        with h5py.File(path, "w") as f:
            dim_sizes = self.dims
            # Coordinate variables double as netCDF dimension scales.
            for name, var in self.coords.items():
                d = f.create_dataset(name, data=var.data)
                for k, v in var.attrs.items():
                    d.attrs[k] = v
                d.attrs["_Netcdf4Coordinates"] = [
                    list(dim_sizes).index(dim) for dim in var.dims]
                d.make_scale(name)
            for name, var in self.data_vars.items():
                d = f.create_dataset(name, data=var.data)
                d.attrs["_ARRAY_DIMENSIONS"] = [
                    s.encode() for s in var.dims]
                for k, v in var.attrs.items():
                    d.attrs[k] = v
                for axis, dim in enumerate(var.dims):
                    if dim in self.coords and dim in f:
                        d.dims[axis].attach_scale(f[dim])
            for k, v in self.attrs.items():
                f.attrs[k] = v

    def _to_xarray(self, xr):  # pragma: no cover - xarray path
        coords = {k: (v.dims, v.data, v.attrs)
                  for k, v in self.coords.items()}
        data_vars = {k: (v.dims, v.data, v.attrs)
                     for k, v in self.data_vars.items()}
        return xr.Dataset(data_vars, coords=coords, attrs=self.attrs)


_UNITS_RE = re.compile(
    r"^\s*(seconds|minutes|hours|days|months|years)\s+since\s+"
    r"(\d{1,4})-(\d{1,2})-(\d{1,2})")


#: Cumulative month-start day offsets for the fixed-length CF model
#: calendars (CF conventions §4.4.1).
_NOLEAP_MONTH_STARTS = np.array(
    [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334])
_ALLLEAP_MONTH_STARTS = np.array(
    [0, 31, 60, 91, 121, 152, 182, 213, 244, 274, 305, 335])

_FIXED_CALENDARS = {
    "360_day": (360, None),                      # every month 30 days
    "noleap": (365, _NOLEAP_MONTH_STARTS),
    "365_day": (365, _NOLEAP_MONTH_STARTS),
    "all_leap": (366, _ALLLEAP_MONTH_STARTS),
    "366_day": (366, _ALLLEAP_MONTH_STARTS),
}


def _decode_fixed_calendar(days, y0, m0, d0, calendar):
    """(years, months) for the CF fixed-length model calendars.

    ``days``: float days since the (y0, m0, d0) base date *in that
    calendar*.  360_day years are 12 x 30 days; noleap/all_leap use
    the fixed Gregorian month lengths without/with a leap day.
    """
    year_len, month_starts = _FIXED_CALENDARS[calendar]
    if calendar == "360_day":
        month_abs = (y0 * 12 + (m0 - 1)
                     + ((d0 - 1) + np.floor(days).astype(int)) // 30)
        return month_abs // 12, month_abs % 12 + 1
    base_abs = (y0 * year_len + month_starts[m0 - 1] + (d0 - 1))
    abs_days = base_abs + np.floor(days).astype(int)
    years = abs_days // year_len
    day_in_year = abs_days % year_len
    months = np.searchsorted(month_starts, day_in_year, side="right")
    return years, months


def _decode_julian_calendar(days, y0, m0, d0):
    """(years, months) for the CF ``julian`` calendar.

    Julian rule: leap year every 4th year, NO Gregorian century
    exception — so Julian dates drift from Gregorian (13 days in the
    20th century) and must not be routed through datetime64.  The
    4-year cycle is exactly 1461 days (years 4c+1..4c+3 have 365,
    year 4c+4 has 366).
    """
    leap0 = int(y0 % 4 == 0 and m0 > 2)
    base = (365 * (y0 - 1) + (y0 - 1) // 4
            + int(_NOLEAP_MONTH_STARTS[m0 - 1]) + leap0 + (d0 - 1))
    abs_days = base + np.floor(days).astype(np.int64)
    cycle, r = np.divmod(abs_days, 1461)
    yr_off = np.minimum(r // 365, 3)
    day_in_year = r - 365 * yr_off
    years = 4 * cycle + 1 + yr_off
    starts = np.where((yr_off == 3)[..., None],
                      _ALLLEAP_MONTH_STARTS, _NOLEAP_MONTH_STARTS)
    months = (day_in_year[..., None] >= starts).sum(axis=-1)
    return years, months


def decode_cf_time(time_var):
    """Decode a CF-convention time variable to (years, months) arrays.

    Handles the unit bases used by HadISST/JRA-55 products, including
    the CF model calendars ``360_day`` / ``noleap`` (``365_day``) /
    ``all_leap`` (``366_day``) via the ``calendar`` attribute
    (CF conventions §4.4.1).  ``julian`` gets its own day arithmetic
    (leap every 4th year, no century exception — datetime64's
    proleptic Gregorian would mislabel months near boundaries);
    ``standard``/``gregorian``/``proleptic_gregorian`` use the
    datetime64 path.  Raw integer/float values with no CF units are
    passed through as years with month 1.
    """
    data = np.asarray(time_var.data)
    units = time_var.attrs.get("units", "")
    if isinstance(units, bytes):
        units = units.decode()
    calendar = time_var.attrs.get("calendar", "standard")
    if isinstance(calendar, bytes):
        calendar = calendar.decode()
    calendar = calendar.lower()

    if np.issubdtype(data.dtype, np.datetime64):
        dt = data.astype("datetime64[M]")
        years = dt.astype("datetime64[Y]").astype(int) + 1970
        months = (dt.astype(int) % 12) + 1
        return years, months

    m = _UNITS_RE.match(units)
    if not m:
        return data.astype(int), np.ones(data.shape, dtype=int)

    unit, y0, m0, d0 = (m.group(1), int(m.group(2)), int(m.group(3)),
                        int(m.group(4)))

    if unit == "months":
        total = (y0 * 12 + (m0 - 1)) + np.round(data).astype(int)
        return total // 12, total % 12 + 1
    if unit == "years":
        years = y0 + np.floor(data).astype(int)
        return years, np.ones(data.shape, dtype=int)

    seconds_per = {"seconds": 1, "minutes": 60, "hours": 3600,
                   "days": 86400}[unit]
    if calendar in _FIXED_CALENDARS:
        return _decode_fixed_calendar(
            data * (seconds_per / 86400.0), y0, m0, int(d0), calendar)
    if calendar == "julian":
        return _decode_julian_calendar(
            data * (seconds_per / 86400.0), y0, m0, int(d0))
    # Real-world calendars: datetime64 (proleptic Gregorian) month
    # arithmetic.  360_day-style base dates (e.g. Feb 30) cannot occur
    # here, so constructing the base datetime is safe.
    base = np.datetime64(datetime.datetime(max(y0, 1), m0, d0), "s")
    stamps = base + (data * seconds_per).astype("timedelta64[s]")
    months_abs = stamps.astype("datetime64[M]").astype(int)
    years = months_abs // 12 + 1970
    months = months_abs % 12 + 1
    return years, months


def open_dataset(path):
    """Open a netCDF4/HDF5 file as a :class:`Dataset`."""
    xr = _xarray()
    if xr is not None:  # pragma: no cover - xarray path
        xds = xr.open_dataset(path)
        coords = {k: Variable(v.dims, v.values, dict(v.attrs))
                  for k, v in xds.coords.items()}
        data_vars = {k: Variable(v.dims, v.values, dict(v.attrs))
                     for k, v in xds.data_vars.items()}
        return Dataset(data_vars, coords, dict(xds.attrs))

    import h5py

    coords = {}
    data_vars = {}
    attrs = {}

    def decode_attrs(h5attrs):
        out = {}
        for k, v in h5attrs.items():
            if k.startswith("_Netcdf4") or k in ("CLASS", "NAME",
                                                 "DIMENSION_LIST",
                                                 "REFERENCE_LIST",
                                                 "_ARRAY_DIMENSIONS"):
                continue
            if isinstance(v, bytes):
                v = v.decode(errors="replace")
            out[k] = v
        return out

    with h5py.File(path, "r") as f:
        attrs = decode_attrs(f.attrs)

        def dims_of(name, dset):
            # Prefer attached dimension scales; fall back to
            # _ARRAY_DIMENSIONS (zarr convention) or generated names.
            dims = []
            if dset.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                return (name,)
            if "_ARRAY_DIMENSIONS" in dset.attrs:
                return tuple(
                    d.decode() if isinstance(d, bytes) else d
                    for d in dset.attrs["_ARRAY_DIMENSIONS"])
            for axis in range(dset.ndim):
                scales = dset.dims[axis] if hasattr(dset, "dims") else []
                label = None
                try:
                    for scale in scales:
                        label = scale.name.lstrip("/")
                        break
                except Exception:
                    label = None
                dims.append(label or f"{name}_dim{axis}")
            return tuple(dims)

        def visit(name, obj):
            import h5py as _h
            if not isinstance(obj, _h.Dataset):
                return
            var = Variable(dims_of(name, obj), obj[()],
                           decode_attrs(obj.attrs))
            fill = obj.attrs.get("_FillValue")
            if fill is not None and np.issubdtype(var.data.dtype,
                                                  np.floating):
                var.data = np.where(var.data == fill, np.nan, var.data)
            if obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                coords[name] = var
            else:
                data_vars[name] = var

        f.visititems(visit)

    return Dataset(data_vars, coords, attrs)

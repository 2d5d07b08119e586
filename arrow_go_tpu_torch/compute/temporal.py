"""Temporal rounding: floor_temporal / ceil_temporal / round_temporal.

Port of arrow_go_tpu/compute/temporal.py (reference
arrow/compute/internal/kernels/rounding.go:830-1230 and the function
registrations in arrow/compute/arithmetic.go:593-625). A column rounds
as int64 vector arithmetic on its device: the calendar decomposition
uses the branch-free civil-from-days / days-from-civil algorithms
(Howard Hinnant's public-domain date algorithms), and every division
is a floor division, so values before 1970 round toward -inf as well.
A HostArray or ChunkedArray (combined) moves to `device` (the card
unless named) and the result is a DeviceColumn there, as the JAX
package's is. UTC and fixed offsets ("+05:30") run on the device; a named zone
observes DST, so it takes the host path through `zoneinfo` and the
result returns to the column's device. `v * tick` wraps in int64 for
values past about 292 years of nanoseconds, as in the JAX package.
"""
from __future__ import annotations

from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..array.record import ChunkedArray
from ..device.block import DeviceColumn, host_array_to_device
from .errors import ArrowInvalid

DAY_NS = 86_400_000_000_000

#: fixed-duration units in nanoseconds (reference rounding.go:884-905
#: unitInNanos); calendar units (year/quarter/month/week) have no entry.
_UNIT_NANOS = {
    "nanosecond": 1,
    "microsecond": 1_000,
    "millisecond": 1_000_000,
    "second": 1_000_000_000,
    "minute": 60 * 1_000_000_000,
    "hour": 3_600 * 1_000_000_000,
    "day": DAY_NS,
}
_CALENDAR_UNITS = ("year", "quarter", "month", "week")


def _tick_ns(t: dt.DataType) -> int:
    """Nanoseconds per stored tick for a temporal type."""
    if t.id == dt.TypeId.DATE32:
        return DAY_NS
    if t.id == dt.TypeId.DATE64:
        return 1_000_000
    if t.id in (dt.TypeId.TIMESTAMP, dt.TypeId.TIME32, dt.TypeId.TIME64,
                dt.TypeId.DURATION):
        return 10**9 // t.unit.multiplier
    raise ArrowInvalid(f"temporal rounding: unsupported type {t}")


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------------
# branch-free civil-date decomposition (vectorized int64)
# ---------------------------------------------------------------------------

def _civil_from_days(z):
    """days-since-epoch -> (year, month, day), proleptic Gregorian."""
    z = z + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097                                  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)                     # [1, 12]
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> days since epoch, proleptic Gregorian."""
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400                                      # [0, 399]
    doy = _fdiv(153 * (m + torch.where(m > 2, -3, 9)) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy  # [0, 146096]
    return era * 146097 + doe - 719468


def _months_start_ns(total_months):
    """months-since-year-0 -> ns of the first instant of that month."""
    y = _fdiv(total_months, 12)
    m = total_months - y * 12 + 1
    return _days_from_civil(y, m, torch.ones_like(m)) * DAY_NS


# ---------------------------------------------------------------------------
# core rounding (int64 nanoseconds, local time)
# ---------------------------------------------------------------------------

def _round_fixed(v_ns, interval: int, mode: str, strict_ceil: bool,
                 origin_ns=None):
    """Round ns values to a multiple of a fixed interval (reference
    roundToMultipleInt64, rounding.go:978-1040), with floor division
    and HalfUp ties for mode 'half', the mode RoundTemporalKernel pins
    (rounding.go:1219)."""
    x = v_ns if origin_ns is None else v_ns - origin_ns
    lo = _fdiv(x, interval) * interval
    hi = lo + interval
    if mode == "floor":
        out = lo
    elif mode == "ceil":
        out = hi if strict_ceil else torch.where(x == lo, lo, hi)
    else:  # half: t < midpoint -> period start, else period end
        out = torch.where(x < lo + interval // 2, lo, hi)
    return out if origin_ns is None else out + origin_ns


def _pick_period(v_ns, start_ns, end_ns, mode: str):
    """A variable-length period's start or end. Calendar-unit ceil is
    always the end (strictly greater), as Arrow C++/pyarrow, which the
    JAX package follows where the Go reference differs
    (rounding.go:1066)."""
    if mode == "floor":
        return start_ns
    if mode == "ceil":
        return end_ns
    mid = start_ns + _fdiv(end_ns - start_ns, 2)
    return torch.where(v_ns < mid, start_ns, end_ns)


def _round_calendar(v_ns, unit: str, multiple: int, mode: str,
                    week_starts_monday: bool):
    """Calendar-unit rounding (year/quarter/month/week), reference
    roundTimestampCalendar (rounding.go:1049-1200) with floor division
    throughout."""
    days = _fdiv(v_ns, DAY_NS)
    y, m, _d = _civil_from_days(days)
    if unit == "year":
        ry = _fdiv(y, multiple) * multiple
        one = torch.ones_like(ry)
        start = _days_from_civil(ry, one, one) * DAY_NS
        end = _days_from_civil(ry + multiple, one, one) * DAY_NS
    elif unit == "quarter":
        rq = _fdiv(y * 4 + _fdiv(m - 1, 3), multiple) * multiple
        start = _months_start_ns(rq * 3)
        end = _months_start_ns((rq + multiple) * 3)
    elif unit == "month":
        rm = _fdiv(y * 12 + m - 1, multiple) * multiple
        start = _months_start_ns(rm)
        end = _months_start_ns(rm + multiple)
    else:  # week: 1970-01-01 is a Thursday; Monday 1969-12-29 is day -3,
        # Sunday 1969-12-28 day -4
        anchor = -3 if week_starts_monday else -4
        rw = _fdiv(_fdiv(days - anchor, 7), multiple) * multiple
        start = (rw * 7 + anchor) * DAY_NS
        end = ((rw + multiple) * 7 + anchor) * DAY_NS
    return _pick_period(v_ns, start, end, mode)


def _round_named_tz_host(v_ns: np.ndarray, valid: np.ndarray, tz: str,
                         unit: str, multiple: int, mode: str,
                         strict_ceil: bool, week_starts_monday: bool,
                         calendar_origin: bool) -> np.ndarray:
    """Host path for DST-observing named timezones (reference
    rounding.go:908-955 tz-aware branches)."""
    from zoneinfo import ZoneInfo
    z = ZoneInfo(tz)
    out = np.zeros_like(v_ns)

    def to_ns(dtm: datetime) -> int:
        return int(dtm.timestamp()) * 10**9 + dtm.microsecond * 1000

    for i in np.nonzero(valid)[0]:
        ns = int(v_ns[i])
        t = datetime.fromtimestamp(ns / 10**9, tz=timezone.utc).astimezone(z)
        t = t.replace(microsecond=(ns % 10**9) // 1000)
        if unit in _CALENDAR_UNITS or unit == "day":
            if unit == "year":
                ry = (t.year // multiple) * multiple
                start = datetime(ry, 1, 1, tzinfo=z)
                end = datetime(ry + multiple, 1, 1, tzinfo=z)
            elif unit in ("quarter", "month"):
                per = 3 if unit == "quarter" else 1
                tp = (t.year * 12 + t.month - 1) // per
                rp = (tp // multiple) * multiple
                sy, sm = divmod(rp * per, 12)
                ey, em = divmod((rp + multiple) * per, 12)
                start = datetime(sy, sm + 1, 1, tzinfo=z)
                end = datetime(ey, em + 1, 1, tzinfo=z)
            elif unit == "week":
                wd = t.weekday() if week_starts_monday else (
                    t.weekday() + 1) % 7
                sow = (t - timedelta(days=wd)).date()
                anchor = np.datetime64("1969-12-29" if week_starts_monday
                                       else "1969-12-28")
                weeks = (np.datetime64(sow) - anchor).astype(int) // 7
                rw = (weeks // multiple) * multiple
                sdate = anchor + np.timedelta64(rw * 7, "D")
                edate = sdate + np.timedelta64(multiple * 7, "D")
                start = datetime(*sdate.astype(object).timetuple()[:3],
                                 tzinfo=z)
                end = datetime(*edate.astype(object).timetuple()[:3],
                               tzinfo=z)
            else:  # day
                start = datetime(t.year, t.month, t.day, tzinfo=z)
                end = start + timedelta(days=multiple)
            s_ns, e_ns = to_ns(start), to_ns(end)
            if mode == "floor":
                out[i] = s_ns
            elif mode == "ceil":
                # fixed-duration day keeps the boundary; calendar units
                # are strictly greater (Arrow C++ behavior)
                stay = unit == "day" and ns == s_ns and not strict_ceil
                out[i] = s_ns if stay else e_ns
            else:
                out[i] = s_ns if ns < s_ns + (e_ns - s_ns) // 2 else e_ns
        else:
            interval = _UNIT_NANOS[unit] * multiple
            origin = to_ns(datetime(t.year, t.month, t.day, tzinfo=z)) \
                if calendar_origin else 0
            x = ns - origin
            lo = (x // interval) * interval
            hi = lo + interval
            if mode == "floor":
                r = lo
            elif mode == "ceil":
                r = lo if (x == lo and not strict_ceil) else hi
            else:
                r = lo if x < lo + interval // 2 else hi
            out[i] = r + origin
    return out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _is_utc_or_fixed(tz: str) -> bool:
    if tz.upper() in ("UTC", "Z"):
        return True
    return len(tz) >= 3 and tz[0] in "+-" and ":" in tz


def _fixed_offset_ns(tz: str) -> int:
    if tz.upper() in ("UTC", "Z"):
        return 0
    sign = 1 if tz[0] == "+" else -1
    hh, mm = tz[1:].split(":")
    return sign * (int(hh) * 3600 + int(mm) * 60) * 10**9


def _round_temporal(values, mode: str, multiple: int, unit: str,
                    week_starts_monday: bool, ceil_is_strictly_greater: bool,
                    calendar_based_origin: bool, device=None) -> DeviceColumn:
    if isinstance(values, ChunkedArray):
        values = values.combine()
    col = values if isinstance(values, DeviceColumn) else \
        host_array_to_device(values, torchenv.device(device))
    t = col.type
    if multiple <= 0:
        raise ArrowInvalid("rounding multiple must be positive")
    if unit not in _UNIT_NANOS and unit not in _CALENDAR_UNITS:
        raise ArrowInvalid(f"unknown temporal rounding unit {unit!r}")
    tick = _tick_ns(t)
    is_time = t.id in (dt.TypeId.TIME32, dt.TypeId.TIME64)
    if is_time and unit in _CALENDAR_UNITS:
        raise ArrowInvalid(f"cannot round time type to unit {unit!r}")

    tz = getattr(t, "tz", None)
    named_tz = bool(tz) and not _is_utc_or_fixed(tz) and (
        unit in _CALENDAR_UNITS or unit == "day" or calendar_based_origin)
    v = col.values.to(torch.int64)
    if named_tz:
        n = col.length
        out_ns = _round_named_tz_host(
            v[:n].cpu().numpy() * tick,
            col.validity_mask()[:n].cpu().numpy(), tz, unit, multiple, mode,
            ceil_is_strictly_greater, week_starts_monday,
            calendar_based_origin)
        out = torch.zeros(col.padded, dtype=torch.int64)
        out[:n] = torch.from_numpy(out_ns // tick)
        return DeviceColumn(out.to(col.device).to(col.values.dtype),
                            col.validity, col.length, t)

    offset_ns = _fixed_offset_ns(tz) if tz else 0
    v_ns = v * tick + offset_ns  # local-time nanoseconds
    if unit in _CALENDAR_UNITS:
        out_ns = _round_calendar(v_ns, unit, multiple, mode,
                                 week_starts_monday)
    else:
        origin = None
        if calendar_based_origin and unit != "day" and not is_time:
            origin = _fdiv(v_ns, DAY_NS) * DAY_NS
        out_ns = _round_fixed(v_ns, _UNIT_NANOS[unit] * multiple, mode,
                              ceil_is_strictly_greater, origin)
    # back to ticks: calendar boundaries are whole days and fixed
    # intervals multiples of gcd(interval, tick); the floor division
    # matches the reference's convertFromNanos otherwise
    out = _fdiv(out_ns - offset_ns, tick)
    return DeviceColumn(out.to(col.values.dtype), col.validity, col.length,
                        t)


def floor_temporal(values, multiple: int = 1, unit: str = "day", *,
                   week_starts_monday: bool = True,
                   ceil_is_strictly_greater: bool = False,
                   calendar_based_origin: bool = False,
                   device=None) -> DeviceColumn:
    """Round temporal values down to the nearest multiple of `unit`
    (reference FloorTemporalKernel, rounding.go:1205). A DeviceColumn
    rounds on its device, host input on `device` (the card unless
    named)."""
    return _round_temporal(values, "floor", multiple, unit,
                           week_starts_monday, ceil_is_strictly_greater,
                           calendar_based_origin, device)


def ceil_temporal(values, multiple: int = 1, unit: str = "day", *,
                  week_starts_monday: bool = True,
                  ceil_is_strictly_greater: bool = False,
                  calendar_based_origin: bool = False,
                  device=None) -> DeviceColumn:
    """Round temporal values up to the nearest multiple of `unit`
    (reference CeilTemporalKernel, rounding.go:1211)."""
    return _round_temporal(values, "ceil", multiple, unit,
                           week_starts_monday, ceil_is_strictly_greater,
                           calendar_based_origin, device)


def round_temporal(values, multiple: int = 1, unit: str = "day", *,
                   week_starts_monday: bool = True,
                   ceil_is_strictly_greater: bool = False,
                   calendar_based_origin: bool = False,
                   device=None) -> DeviceColumn:
    """Round temporal values to the nearest multiple of `unit`
    (reference RoundTemporalKernel, rounding.go:1217)."""
    return _round_temporal(values, "half", multiple, unit,
                           week_starts_monday, ceil_is_strictly_greater,
                           calendar_based_origin, device)

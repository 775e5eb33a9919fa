"""Date and time expressions (the counterpart of
spark_rapids_tpu/expressions/datetime.py): year, month, day, the time
fields, day of week, date +- days, datediff, unix_timestamp and
from_unixtime, last_day, day of year, quarter, weekday and timestamp +
microseconds. DATE is int32 days since the epoch and TIMESTAMP int64
microseconds (UTC), so every field is integer arithmetic on the device:
the civil-from-days routine is Howard Hinnant's, with floor division on
int64 as the reference does it (a date before 1970 and a TIMESTAMP
before the epoch are where a truncating division would differ).
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dt
from spark_rapids_tpu_torch.columnar.column import Scalar
from spark_rapids_tpu_torch.expressions.base import (
    ColV, EvalContext, EvalValue, Expression, and_validity, operand,
    value_validity)

_US_PER_DAY = 86_400_000_000
_US_PER_HOUR = 3_600_000_000
_US_PER_MIN = 60_000_000
_US_PER_SEC = 1_000_000


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """days since 1970-01-01 -> (year, month [1-12], day [1-31]), int64."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) -
                _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                     ) -> torch.Tensor:
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _py(x: torch.Tensor, out: dt.DType):
    v = x.item()
    if out is dt.BOOLEAN:
        return bool(v)
    return float(v) if out.is_floating else int(v)


def eval_unary(expr: Expression, ctx: EvalContext, fn, out: dt.DType
               ) -> EvalValue:
    """Null in, null out; ``fn`` over the child's data (a literal's too,
    as a 0-d tensor of its type)."""
    v = expr.children[0].eval(ctx)
    if isinstance(v, Scalar):
        if v.is_null:
            return Scalar(out, None)
        return Scalar(out, _py(fn(operand(v)), out))
    return ColV(out, fn(v.data).to(out.torch_dtype), v.validity)


def eval_binary(expr: Expression, ctx: EvalContext, fn, out: dt.DType
                ) -> EvalValue:
    """Null if either side is null."""
    a = expr.children[0].eval(ctx)
    b = expr.children[1].eval(ctx)
    if (isinstance(a, Scalar) and a.is_null) or \
            (isinstance(b, Scalar) and b.is_null):
        return Scalar(out, None)
    if isinstance(a, Scalar) and isinstance(b, Scalar):
        return Scalar(out, _py(fn(operand(a), operand(b)), out))
    data = fn(operand(a).to(ctx.device), operand(b).to(ctx.device))
    return ColV(out, data.to(out.torch_dtype),
                and_validity(value_validity(a), value_validity(b)))


class _DateField(Expression):
    """A field of a DATE (or of a TIMESTAMP's day)."""

    part = None  # 'year' | 'month' | 'day'

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def _days(self, x):
        if self.children[0].dtype is dt.TIMESTAMP:
            return _fdiv(x, _US_PER_DAY)
        return x

    def eval(self, ctx):
        i = ("year", "month", "day").index(type(self).part)
        return eval_unary(
            self, ctx, lambda x: _civil_from_days(self._days(x))[i],
            dt.INT32)


class Year(_DateField):
    part = "year"


class Month(_DateField):
    part = "month"


class DayOfMonth(_DateField):
    part = "day"


class _TimeField(Expression):
    divisor = None
    modulus = None

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        div, mod = type(self).divisor, type(self).modulus

        def f(x):
            tod = torch.remainder(x.to(torch.int64), _US_PER_DAY)
            return torch.remainder(_fdiv(tod, div), mod)

        return eval_unary(self, ctx, f, dt.INT32)


class Hour(_TimeField):
    divisor = _US_PER_HOUR
    modulus = 24


class Minute(_TimeField):
    divisor = _US_PER_MIN
    modulus = 60


class Second(_TimeField):
    divisor = _US_PER_SEC
    modulus = 60


class DayOfWeek(Expression):
    """1 = Sunday ... 7 = Saturday (Spark's numbering)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        # 1970-01-01 was a Thursday (5 in Spark's numbering)
        return eval_unary(
            self, ctx,
            lambda d: torch.remainder(d.to(torch.int64) + 4, 7) + 1,
            dt.INT32)


def _days_op(sign: int):
    return lambda a, b: a.to(torch.int64) + sign * b.to(torch.int64)


class DateAdd(Expression):
    def __init__(self, start, days):
        super().__init__([start, days])

    @property
    def dtype(self):
        return dt.DATE

    def eval(self, ctx):
        return eval_binary(self, ctx, _days_op(1), dt.DATE)


class DateSub(Expression):
    def __init__(self, start, days):
        super().__init__([start, days])

    @property
    def dtype(self):
        return dt.DATE

    def eval(self, ctx):
        return eval_binary(self, ctx, _days_op(-1), dt.DATE)


class DateDiff(Expression):
    def __init__(self, end, start):
        super().__init__([end, start])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        return eval_binary(self, ctx, _days_op(-1), dt.INT32)


class UnixTimestamp(Expression):
    """A DATE or TIMESTAMP -> seconds since the epoch (UTC only, as in the
    reference)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT64

    def eval(self, ctx):
        if self.children[0].dtype is dt.DATE:
            return eval_unary(self, ctx,
                              lambda x: x.to(torch.int64) * 86400,
                              dt.INT64)
        return eval_unary(self, ctx, lambda x: _fdiv(x, _US_PER_SEC),
                          dt.INT64)


class FromUnixTime(Expression):
    """Seconds since the epoch -> TIMESTAMP."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.TIMESTAMP

    def eval(self, ctx):
        return eval_unary(self, ctx,
                          lambda x: x.to(torch.int64) * _US_PER_SEC,
                          dt.TIMESTAMP)


class LastDay(Expression):
    """The last day of a date's month."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.DATE

    def eval(self, ctx):
        def f(days):
            y, m, _ = _civil_from_days(days)
            ny = torch.where(m == 12, y + 1, y)
            nm = torch.where(m == 12, torch.ones_like(m), m + 1)
            return _days_from_civil(ny, nm, torch.ones_like(nm)) - 1

        return eval_unary(self, ctx, f, dt.DATE)


class DayOfYear(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        def f(days):
            y, _, _ = _civil_from_days(days)
            one = torch.ones_like(y)
            return days.to(torch.int64) - _days_from_civil(y, one, one) + 1

        return eval_unary(self, ctx, f, dt.INT32)


class Quarter(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        return eval_unary(
            self, ctx,
            lambda days: _fdiv(_civil_from_days(days)[1] - 1, 3) + 1,
            dt.INT32)


class WeekDay(Expression):
    """0 = Monday ... 6 = Sunday (Spark's WeekDay, against DayOfWeek's
    1 = Sunday)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def dtype(self):
        return dt.INT32

    def eval(self, ctx):
        # 1970-01-01 was a Thursday (3 counting Monday as 0)
        return eval_unary(
            self, ctx, lambda d: torch.remainder(d.to(torch.int64) + 3, 7),
            dt.INT32)


class ToUnixTimestamp(UnixTimestamp):
    """UnixTimestamp with SQL's other argument order; the same node."""


class TimeAdd(Expression):
    """TIMESTAMP + a microsecond delta (a literal interval with no month
    part, as in the reference)."""

    def __init__(self, start, delta_us):
        super().__init__([start, delta_us])

    @property
    def dtype(self):
        return dt.TIMESTAMP

    def eval(self, ctx):
        return eval_binary(
            self, ctx, lambda a, b: a.to(torch.int64) + b.to(torch.int64),
            dt.TIMESTAMP)

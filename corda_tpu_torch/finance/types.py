"""Financial time types: tenors, business calendars, day rolling.

The port's own copy of ``corda_tpu/finance/types.py``.

Capability match for the reference's FinanceTypes (reference:
core/src/main/kotlin/net/corda/core/contracts/FinanceTypes.kt — Tenor,
BusinessCalendar with holiday sets, date roll conventions, day-count
helpers; used by the IRS demo's fixing schedule). Dates are integer epoch
DAYS (UTC) so they serialize canonically like every other ledger number.
"""

from __future__ import annotations

import datetime as _dt
import re
from dataclasses import dataclass

from ..serialization.codec import register

_DAY = _dt.timedelta(days=1)
_EPOCH = _dt.date(1970, 1, 1)


def date_to_days(d: _dt.date) -> int:
    return (d - _EPOCH).days


def days_to_date(days: int) -> _dt.date:
    return _EPOCH + days * _DAY


@register
@dataclass(frozen=True, order=True)
class Tenor:
    """A duration token like 1D / 2W / 3M / 10Y (FinanceTypes.kt Tenor)."""

    name: str

    _PATTERN = re.compile(r"^(\d+)([DWMY])$")

    def __post_init__(self):
        if not self._PATTERN.match(self.name):
            raise ValueError(f"invalid tenor {self.name!r}")

    @property
    def amount(self) -> int:
        return int(self._PATTERN.match(self.name).group(1))

    @property
    def unit(self) -> str:
        return self._PATTERN.match(self.name).group(2)

    def days_from(self, start_days: int) -> int:
        """Approximate day count of this tenor from a start date (months/
        years advance calendar-wise, as the reference's TimeUnit maths)."""
        start = days_to_date(start_days)
        n = self.amount
        if self.unit == "D":
            end = start + n * _DAY
        elif self.unit == "W":
            end = start + 7 * n * _DAY
        elif self.unit == "M":
            month = start.month - 1 + n
            year = start.year + month // 12
            month = month % 12 + 1
            day = min(start.day, _days_in_month(year, month))
            end = _dt.date(year, month, day)
        else:  # Y
            end = _dt.date(start.year + n,
                           start.month,
                           min(start.day,
                               _days_in_month(start.year + n, start.month)))
        return date_to_days(end) - start_days

    def __str__(self) -> str:
        return self.name


def _days_in_month(year: int, month: int) -> int:
    nxt = _dt.date(year + month // 12, month % 12 + 1, 1)
    return (nxt - _dt.date(year, month, 1)).days


FOLLOWING = "Following"
MODIFIED_FOLLOWING = "ModifiedFollowing"
PREVIOUS = "Previous"


@register
@dataclass(frozen=True)
class BusinessCalendar:
    """Working-day calendar: weekends plus an explicit holiday set
    (FinanceTypes.kt BusinessCalendar — there loaded from resources; here the
    holiday list is part of the value)."""

    holidays: frozenset[int] = frozenset()  # epoch-day numbers

    def __post_init__(self):
        object.__setattr__(self, "holidays", frozenset(self.holidays))

    def is_working_day(self, day: int) -> bool:
        return days_to_date(day).weekday() < 5 and day not in self.holidays

    def roll(self, day: int, convention: str = FOLLOWING) -> int:
        """Move a non-working day onto a working one (applyRollConvention)."""
        if self.is_working_day(day):
            return day
        if convention == FOLLOWING:
            return self._step(day, +1)
        if convention == PREVIOUS:
            return self._step(day, -1)
        if convention == MODIFIED_FOLLOWING:
            rolled = self._step(day, +1)
            if days_to_date(rolled).month != days_to_date(day).month:
                return self._step(day, -1)
            return rolled
        raise ValueError(f"unknown roll convention {convention!r}")

    def _step(self, day: int, direction: int) -> int:
        while not self.is_working_day(day):
            day += direction
        return day

    def advance(self, start_day: int, tenor: Tenor,
                convention: str = FOLLOWING) -> int:
        """start + tenor, rolled to a working day (moveBusinessDays/
        applyTenor capability)."""
        return self.roll(start_day + tenor.days_from(start_day), convention)

    @staticmethod
    def union(*calendars: "BusinessCalendar") -> "BusinessCalendar":
        out: frozenset[int] = frozenset()
        for c in calendars:
            out = out | c.holidays
        return BusinessCalendar(out)


class Frequency:
    """Payment schedule frequencies (FinanceTypes.kt:242-263 Frequency):
    each is a (name, annual compound count, tenor) triple; ``offset`` steps a
    date forward n periods via the tenor's calendar arithmetic. The seven
    canonical instances below are the registry; constructing ad-hoc
    Frequency values is fine but never aliases ``Frequency.of``."""

    _BY_NAME: dict[str, "Frequency"] = {}

    def __init__(self, name: str, annual_compound_count: int, tenor_name: str):
        self.name = name
        self.annual_compound_count = annual_compound_count
        self.tenor = Tenor(tenor_name)

    def offset(self, day: int, n: int = 1) -> int:
        for _ in range(n):
            day += self.tenor.days_from(day)
        return day

    @staticmethod
    def of(name: str) -> "Frequency":
        try:
            return Frequency._BY_NAME[name]
        except KeyError:
            raise ValueError(f"unknown frequency {name!r}") from None

    def __repr__(self):
        return f"Frequency.{self.name}"


for _freq in (Frequency("Annual", 1, "1Y"), Frequency("SemiAnnual", 2, "6M"),
              Frequency("Quarterly", 4, "3M"), Frequency("Monthly", 12, "1M"),
              Frequency("BiWeekly", 26, "2W"), Frequency("Weekly", 52, "1W"),
              Frequency("Daily", 365, "1D")):
    Frequency._BY_NAME[_freq.name] = _freq
    setattr(Frequency, {"Annual": "ANNUAL", "SemiAnnual": "SEMI_ANNUAL",
                        "Quarterly": "QUARTERLY", "Monthly": "MONTHLY",
                        "BiWeekly": "BI_WEEKLY", "Weekly": "WEEKLY",
                        "Daily": "DAILY"}[_freq.name], _freq)
del _freq

"""Amount: integer quantities of a token, with mixing protection.

Capability match for the reference's Amount (reference:
core/src/main/kotlin/net/corda/core/contracts/FinanceTypes.kt:32-98):
quantities are non-negative longs counted in the token's smallest unit
(pennies, cents); arithmetic refuses to mix tokens; `token` is any
codec-serializable value — a currency code string, or an Issued wrapping one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

from ..serialization.codec import register


@register
@dataclass(frozen=True, order=True)
class Amount:
    quantity: int
    token: Any

    def __post_init__(self):
        if self.quantity < 0:
            raise ValueError(f"Negative amounts are not allowed: {self.quantity}")

    def _check(self, other: "Amount") -> None:
        if not isinstance(other, Amount) or other.token != self.token:
            raise ValueError(f"Token mismatch: {self.token!r} vs "
                             f"{getattr(other, 'token', other)!r}")

    def __add__(self, other: "Amount") -> "Amount":
        self._check(other)
        return Amount(self.quantity + other.quantity, self.token)

    def __sub__(self, other: "Amount") -> "Amount":
        self._check(other)
        return Amount(self.quantity - other.quantity, self.token)

    def __mul__(self, k: int) -> "Amount":
        return Amount(self.quantity * k, self.token)

    def __str__(self) -> str:
        return f"{self.quantity} {self.token}"


def sum_or_zero(amounts: Iterable[Amount], token: Any) -> Amount:
    """Sum amounts of one token; empty -> zero of that token
    (FinanceTypes.kt sumOrZero)."""
    total = Amount(0, token)
    for a in amounts:
        total = total + a
    return total

"""Interpolators for rate curves.

Capability match for the reference's math package (reference:
core/src/main/kotlin/net/corda/core/math/Interpolators.kt — Linear and
CubicSpline interpolation over (x, y) knots, used by the IRS demo's rate
oracle to price off a sparse curve). Pure host math — these run per-fixing,
not on the verification hot path.

The port's own copy of ``corda_tpu/utils/interpolators.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LinearInterpolator:
    xs: tuple[float, ...]
    ys: tuple[float, ...]

    def __post_init__(self):
        _check_knots(self.xs, self.ys)

    def interpolate(self, x: float) -> float:
        i = _bracket(self.xs, x)
        x0, x1 = self.xs[i], self.xs[i + 1]
        y0, y1 = self.ys[i], self.ys[i + 1]
        return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


@dataclass(frozen=True)
class CubicSplineInterpolator:
    """Natural cubic spline (second derivative zero at the ends), matching
    the reference's CubicSplineInterpolator semantics."""

    xs: tuple[float, ...]
    ys: tuple[float, ...]

    def __post_init__(self):
        _check_knots(self.xs, self.ys)
        n = len(self.xs) - 1
        h = [self.xs[i + 1] - self.xs[i] for i in range(n)]
        # Solve the tridiagonal system for second derivatives (natural BCs).
        alpha = [0.0] * (n + 1)
        for i in range(1, n):
            alpha[i] = (3 / h[i]) * (self.ys[i + 1] - self.ys[i]) \
                - (3 / h[i - 1]) * (self.ys[i] - self.ys[i - 1])
        l = [1.0] + [0.0] * n
        mu = [0.0] * (n + 1)
        z = [0.0] * (n + 1)
        for i in range(1, n):
            l[i] = 2 * (self.xs[i + 1] - self.xs[i - 1]) - h[i - 1] * mu[i - 1]
            mu[i] = h[i] / l[i]
            z[i] = (alpha[i] - h[i - 1] * z[i - 1]) / l[i]
        c = [0.0] * (n + 1)
        b = [0.0] * n
        d = [0.0] * n
        for j in range(n - 1, -1, -1):
            c[j] = z[j] - mu[j] * c[j + 1]
            b[j] = (self.ys[j + 1] - self.ys[j]) / h[j] \
                - h[j] * (c[j + 1] + 2 * c[j]) / 3
            d[j] = (c[j + 1] - c[j]) / (3 * h[j])
        object.__setattr__(self, "_coeffs", (tuple(b), tuple(c), tuple(d)))

    def interpolate(self, x: float) -> float:
        i = _bracket(self.xs, x)
        b, c, d = self._coeffs
        dx = x - self.xs[i]
        return self.ys[i] + b[i] * dx + c[i] * dx * dx + d[i] * dx ** 3


def _check_knots(xs, ys):
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("need >= 2 knots with matching lengths")
    if any(xs[i] >= xs[i + 1] for i in range(len(xs) - 1)):
        raise ValueError("x knots must be strictly increasing")


def _bracket(xs, x) -> int:
    if x < xs[0] or x > xs[-1]:
        raise ValueError(f"{x} outside the curve [{xs[0]}, {xs[-1]}]")
    for i in range(len(xs) - 1):
        if x <= xs[i + 1]:
            return i
    return len(xs) - 2

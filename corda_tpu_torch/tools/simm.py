"""Deterministic fixed-point SIMM-style initial-margin model.

The port's own copy of ``corda_tpu/tools/simm.py``.

Capability match for the simm-valuation-demo's analytics tier (reference:
samples/simm-valuation-demo/src/main/kotlin/net/corda/vega/analytics/
AnalyticsEngine.kt — OpenGamma Strata computes per-trade curve
sensitivities, then an ISDA-SIMM margin aggregates them;
flows/SimmFlow.kt drives both sides to compute independently and agree).
The reference's engine is double-precision OpenGamma; a consensus protocol
built on doubles only works because both sides run the SAME jar. Here the
model is **integer fixed-point end to end** — every node computes the
bit-identical margin from the shared portfolio and oracle fix, which is the
property the on-ledger agreement actually needs.

Model shape (simplified but structurally the ISDA SIMM delta-margin
pipeline):

1. **Curve**: a 12-tenor zero curve built deterministically from the
   oracle's rate fix (flat + a fixed slope), rates in basis points.
2. **Pricing**: each IRS trade (notional, fixed rate, maturity) PVs as
   annual-fixed-leg-vs-float-leg with simple-compounding integer discount
   factors at SCALE=1e8 fixed point.
3. **Sensitivities**: first-order bump-and-revalue — PV delta per +1bp bump
   of each tenor bucket (CurveCalibrator/parameterSensitivity capability,
   AnalyticsEngine.kt:77-93).
4. **Aggregation**: ISDA-SIMM delta margin shape — per-tenor risk weights,
   then margin = isqrt(sum_kl rho_kl * WS_k * WS_l) with a PSD
   exponential-decay correlation matrix (rho^|k-l|, the Kac-Murdock-Szego
   form; decays 1.00 -> 0.31 across the tenor span, matching the published
   ISDA IR correlation decay).
"""

from __future__ import annotations

from dataclasses import dataclass
from math import isqrt

from ..serialization.codec import register

SCALE = 10**8  # discount-factor / PV fixed point

# ISDA SIMM IR delta tenors (2w ... 30y), in days.
TENOR_DAYS = (14, 30, 91, 182, 365, 730, 1095, 1825, 3650, 5475, 7300, 10950)

# Per-tenor risk weights (ISDA SIMM v1 regular-volatility shape), integer.
RISK_WEIGHTS = (113, 113, 98, 69, 56, 52, 51, 51, 51, 53, 56, 64)

# Correlation in percent: rho_kl = round(100 * 0.9^|k-l|) — precomputed so
# no float touches the consensus path. KMS form => positive semi-definite.
_DECAY = (100, 90, 81, 73, 66, 59, 53, 48, 43, 39, 35, 31)
RHO_PCT = tuple(tuple(_DECAY[abs(k - l)] for l in range(len(TENOR_DAYS)))
                for k in range(len(TENOR_DAYS)))

# Deterministic curve slope added to the oracle's flat fix, per tenor (bp).
CURVE_SLOPE_BP = (0, 1, 2, 4, 7, 12, 16, 22, 30, 34, 37, 40)


@register
@dataclass(frozen=True)
class IRSTrade:
    """One interest-rate swap leg pair: positive notional receives fixed."""

    notional: int        # signed; units of portfolio currency
    fixed_rate_bp: int   # fixed leg rate, basis points
    maturity_days: int   # days from the valuation date; > 0


def curve_from_fix(fix_value: int) -> tuple[int, ...]:
    """Oracle fix (1 unit = 0.01 bp, e.g. 2_5000 = 2.5%) -> per-tenor zero
    rates in basis points."""
    base_bp = fix_value // 100
    return tuple(base_bp + slope for slope in CURVE_SLOPE_BP)


def _df(rate_bp: int, days: int) -> int:
    """Simple-compounded discount factor at SCALE: 1 / (1 + r*t)."""
    denominator = 10_000 * 365 + rate_bp * days
    return (SCALE * 10_000 * 365) // denominator


def _rate_at(curve_bp: tuple[int, ...], days: int) -> int:
    """Step interpolation: the first tenor >= days (flat extrapolation)."""
    for tenor, rate in zip(TENOR_DAYS, curve_bp):
        if days <= tenor:
            return rate
    return curve_bp[-1]


def trade_pv(trade: IRSTrade, curve_bp: tuple[int, ...]) -> int:
    """Integer PV at SCALE fixed point, from the fixed-receiver's side.

    Fixed leg: annual payments of notional * rate * 1y, discounted; the
    stub period at maturity pays pro-rata. Float leg: the textbook
    identity N * (1 - df(maturity))."""
    n = trade.notional
    fixed_pv = 0
    day = 365
    while day <= trade.maturity_days:
        df = _df(_rate_at(curve_bp, day), day)
        fixed_pv += n * trade.fixed_rate_bp * df // 10_000
        day += 365
    stub_days = trade.maturity_days - (day - 365)
    if stub_days > 0:
        df = _df(_rate_at(curve_bp, trade.maturity_days),
                 trade.maturity_days)
        fixed_pv += n * trade.fixed_rate_bp * stub_days * df \
            // (10_000 * 365)
    df_end = _df(_rate_at(curve_bp, trade.maturity_days),
                 trade.maturity_days)
    float_pv = n * (SCALE - df_end)
    return fixed_pv - float_pv


def trade_sensitivities(trade: IRSTrade,
                        curve_bp: tuple[int, ...]) -> tuple[int, ...]:
    """First-order bucket sensitivities: PV(+1bp bump of bucket k) - PV."""
    base = trade_pv(trade, curve_bp)
    out = []
    for k in range(len(TENOR_DAYS)):
        bumped = tuple(r + (1 if i == k else 0)
                       for i, r in enumerate(curve_bp))
        out.append(trade_pv(trade, bumped) - base)
    return tuple(out)


def portfolio_sensitivities(trades, curve_bp) -> tuple[int, ...]:
    total = [0] * len(TENOR_DAYS)
    for trade in trades:
        for k, s in enumerate(trade_sensitivities(trade, curve_bp)):
            total[k] += s
    return tuple(total)


def initial_margin(trades, fix_value: int) -> int:
    """The agreed number: ISDA-SIMM-shaped delta margin, integer end to end.

    margin = isqrt( sum_kl rho_kl * (RW_k s_k) * (RW_l s_l) ) de-scaled
    back to portfolio-currency units."""
    curve = curve_from_fix(fix_value)
    sens = portfolio_sensitivities(trades, curve)
    weighted = [RISK_WEIGHTS[k] * sens[k] for k in range(len(sens))]
    acc = 0
    for k, wk in enumerate(weighted):
        for l, wl in enumerate(weighted):
            acc += RHO_PCT[k][l] * wk * wl
    # acc is at (SCALE * 100-pct) fixed point squared; PSD correlation
    # keeps it non-negative, max(0) guards integer-rounding dust.
    return isqrt(max(0, acc) // 100) // SCALE

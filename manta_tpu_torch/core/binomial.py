"""One-sided exact binomial test (reference: blt_util/binomial_test.cpp
get_binomial_gte_n_success_exact_pval / is_reject_binomial_gte_n_success_exact).

P(X >= k | n, p) is evaluated through the regularized incomplete beta
function I_p(k, n-k+1), the same identity boost::math (reference) and
scipy.stats use, via the standard Lentz continued-fraction evaluation
in float64. Agreement with scipy.stats.binom.sf is ~1e-14 relative
(validated in tests/test_binomial.py); the callers only compare the
p-value against alpha thresholds far from that noise floor.

Implemented directly so the phase-2 hot path does not pay scipy's
~1-2 s import in every worker process.
"""

from __future__ import annotations

import math

_MAX_ITER = 300
_EPS = 3e-16
_FPMIN = 1e-300


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the incomplete beta (Lentz's method)."""
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = 1.0
    d = 1.0 - qab * x / qap
    if abs(d) < _FPMIN:
        d = _FPMIN
    d = 1.0 / d
    h = d
    for m in range(1, _MAX_ITER + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < _FPMIN:
            d = _FPMIN
        c = 1.0 + aa / c
        if abs(c) < _FPMIN:
            c = _FPMIN
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < _FPMIN:
            d = _FPMIN
        c = 1.0 + aa / c
        if abs(c) < _FPMIN:
            c = _FPMIN
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < _EPS:
            return h
    # Lentz converges slowly only near x ~ a/(a+b) with huge a and b;
    # no current caller reaches that regime (n_success <= 4 in the
    # significance filters). Fail loudly rather than return a silently
    # inaccurate tail probability.
    raise ArithmeticError(
        f"incomplete-beta continued fraction did not converge "
        f"(a={a}, b={b}, x={x})")


def reg_inc_beta(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
             + a * math.log(x) + b * math.log1p(-x))
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def binomial_gte_n_success_pval(p: float, n_success: int,
                                n_trials: int) -> float:
    """P(X >= n_success) for X ~ Binomial(n_trials, p)
    (reference: binomial_test.cpp:115-125)."""
    if n_success == 0:
        return 1.0
    if n_success > n_trials:
        return 0.0
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    return reg_inc_beta(float(n_success),
                        float(n_trials - n_success + 1), p)


def is_reject_binomial_gte_n_success_exact(alpha: float, p: float,
                                           n_success: int,
                                           n_trials: int) -> bool:
    """(reference: binomial_test.cpp:127-136)."""
    return binomial_gte_n_success_pval(p, n_success, n_trials) <= alpha

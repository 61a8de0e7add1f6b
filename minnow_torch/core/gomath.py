"""Vectorized replication of Go's math.Log10 (fdlibm algorithm).

minh log-columns are preprocessed with ``float32(math.Log10(float64(x)))``
on the write path (ref go/minh/minh.go:141-149), so byte-exact files
require reproducing Go's log algorithm, not the platform libm (glibc /
XLA logs differ from fdlibm in the last float64 bit, which survives the
float32 rounding for ~2**-29 of inputs).

Go's implementation (src/math/log.go, log10.go) is the classic
FDLIBM e_log.c scheme:

    log10(x) = log2(x) * (Ln2 / Ln10)
    log2(x)  = frexp(x) -> (frac, exp); exact for frac == 0.5;
               else log(frac)*(1/Ln2) + exp
    log(x)   = argument reduction to f in [sqrt(2)/2, sqrt(2)) - 1,
               s = f/(2+f), odd polynomial in s**2 with the published
               FDLIBM coefficients, compensated Ln2Hi/Ln2Lo summation.

Every operation is an IEEE-f64 add/mul/div on numpy, so results do not
depend on the platform's libm.

The port's own copy of ``minnow_tpu/core/gomath.py``: the same
arithmetic and the same bytes, on numpy, with no import from that
package.
"""

from __future__ import annotations

import numpy as np

# FDLIBM constants (as in Go src/math/log.go).
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_L1 = 6.666666666666735130e-01
_L2 = 3.999999999940941908e-01
_L3 = 2.857142874366239149e-01
_L4 = 2.222219843214978396e-01
_L5 = 1.818357216161805012e-01
_L6 = 1.531383769920937332e-01
_L7 = 1.479819860511658591e-01
_SQRT2 = 1.4142135623730951
_LN2 = 0.6931471805599453
_LN10 = 2.302585092994046
_LOG2E = 1.4426950408889634  # 1/Ln2


def _fdlibm_log(x):
    """FDLIBM natural log of positive finite x (float64 array)."""
    f1, ki = np.frexp(x)  # x = f1 * 2**ki, f1 in [0.5, 1)
    small = f1 < _SQRT2 / 2
    f1 = np.where(small, f1 * 2, f1)
    k = (ki - small.astype(ki.dtype)).astype(np.float64)

    f = f1 - 1.0
    s = f / (2.0 + f)
    s2 = s * s
    s4 = s2 * s2
    t1 = s2 * (_L1 + s4 * (_L3 + s4 * (_L5 + s4 * _L7)))
    t2 = s4 * (_L2 + s4 * (_L4 + s4 * _L6))
    r = t1 + t2
    hfsq = 0.5 * f * f
    return k * _LN2_HI - ((hfsq - (s * (hfsq + r) + k * _LN2_LO)) - f)


def log(x):
    """Go math.Log (float64).  Special cases follow Go: NaN->NaN, +Inf->+Inf,
    x<0 -> NaN, 0 -> -Inf."""
    x = np.asarray(x, np.float64)
    safe = np.where(x > 0, x, 1.0)
    out = _fdlibm_log(safe)
    out = np.where(x == 0, -np.inf, out)
    out = np.where(x < 0, np.nan, out)
    out = np.where(np.isnan(x) | (x == np.inf), x, out)
    return out


def log2(x):
    """Go math.Log2: exact for powers of two (frac == 0.5 fast path,
    ref go src/math/log.go log2)."""
    x = np.asarray(x, np.float64)
    safe = np.where(x > 0, x, 1.0)
    frac, exp = np.frexp(safe)
    exact = frac == 0.5
    gen = log(np.where(exact, 1.0, frac)) * _LOG2E + exp.astype(
        np.float64)
    out = np.where(exact, exp.astype(np.float64) - 1.0, gen)
    out = np.where(x == 0, -np.inf, out)
    out = np.where(x < 0, np.nan, out)
    out = np.where(np.isnan(x) | (x == np.inf), x, out)
    return out


def log10(x):
    """Go math.Log10 = Log2(x) * (Ln2 / Ln10)."""
    return log2(x) * (_LN2 / _LN10)

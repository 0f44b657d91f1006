"""Log-domain arithmetic.

The reference (sphinxbase/src/libsphinxbase/util/logmath.c:62-130) keeps all
scores as int32 logs in an arbitrary base (default 1.0001) with a precomputed
log-add table.  Here scores stay in *float* log space (natural log) with
`logaddexp` / `logsumexp` — float arithmetic makes the table pointless.  This
module provides:

- jnp helpers for float log-space math (`log_add`, `logsumexp` wrappers);
- a `LogMath` class replicating the reference's integer-log-base semantics for
  model I/O (DMP LMs, sendump mixture weights, transition matrices are stored
  as quantized base-b logs) and for bit-parity unit tests.
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np

LOG_ZERO = -1.0e30  # float log-space "impossible" (analog of WORST_SCORE hmm.h:74)


class LogMath:
    """Integer log-base arithmetic compatible with sphinxbase logmath.

    log(x) = round(ln(x) / ln(base)) stored as int; provides conversions
    between that domain and natural-log floats used on device.
    """

    def __init__(self, base: float = 1.0001, shift: int = 0):
        if base <= 1.0:
            raise ValueError("log base must be > 1")
        self.base = float(base)
        self.shift = int(shift)
        self.log_of_base = math.log(base)
        # Minimum representable value, as in logmath.c (int32 min guard).
        self.zero = -(2 ** 31)

    # --- scalar/ndarray conversions ---------------------------------------
    def log(self, p: Union[float, np.ndarray]):
        """Linear prob -> int log-base score."""
        p = np.asarray(p, dtype=np.float64)
        with np.errstate(divide="ignore"):
            v = np.log(p) / self.log_of_base
        v = np.where(np.isfinite(v), v, float(self.zero))
        out = np.rint(v).astype(np.int64) >> self.shift
        if out.ndim == 0:
            return int(out)
        return out

    def exp(self, x: Union[int, np.ndarray]):
        """Int log-base score -> linear prob."""
        x = np.asarray(x, dtype=np.float64)
        return np.exp((x * (1 << self.shift)) * self.log_of_base)

    def ln_to_log(self, ln_p: Union[float, np.ndarray]):
        """Natural-log value -> int log-base score."""
        v = np.asarray(ln_p, dtype=np.float64) / self.log_of_base
        out = np.rint(v).astype(np.int64) >> self.shift
        if out.ndim == 0:
            return int(out)
        return out

    def log_to_ln(self, x: Union[int, np.ndarray]):
        """Int log-base score -> natural log float."""
        return np.asarray(x, dtype=np.float64) * (1 << self.shift) * self.log_of_base

    def log10_to_log(self, l10: Union[float, np.ndarray]):
        return self.ln_to_log(np.asarray(l10, dtype=np.float64) * math.log(10.0))

    def log_to_log10(self, x: Union[int, np.ndarray]):
        return self.log_to_ln(x) / math.log(10.0)

    def add(self, a, b):
        """Log-domain addition log(b^a + b^b) in the integer domain."""
        ln = np.logaddexp(self.log_to_ln(a), self.log_to_ln(b))
        return self.ln_to_log(ln)


def log_add(a, b):
    """Float natural-log-space addition (device-friendly)."""
    import jax.numpy as jnp

    return jnp.logaddexp(a, b)


def logsumexp(x, axis=None, keepdims=False):
    import jax.nn

    return jax.nn.logsumexp(x, axis=axis, keepdims=keepdims)

"""Plain float64 numpy references for the frontend and the senone scorers.

Each evaluates the same semantics as the device code from the model's own
parameters in float64, where the expanded GMM form loses nothing, so that
a comparison shows the device path's rounding (chip_smoke.py and the
tests).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from cmusphinx_tpu.models.gauden import GaussianParams
from cmusphinx_tpu.ops.gmm import logadd8_table

# Bounds on the expanded-form GMM error, relative to the magnitude of the
# terms it sums (`cont_scores(...)[1]`), per -gmmprec mode, from the unit
# roundoff u of each operand format (f32 2^-24, bf16 2^-8):
# - highest: f32 products summed over 2D=78 terms, 78 u;
# - high: bf16 hi + lo keeps 16 bits of each operand and the lo*lo product
#   is dropped, ~3 * 2^-16 per product, plus the f32 sum;
# - bf16: both operands rounded to bf16, 2 * 2^-8, plus the f32 sum.
REL_BOUND = {
    "highest": 78 * 2.0 ** -24,
    "high": 3 * 2.0 ** -16 + 78 * 2.0 ** -24,
    "bf16": 2 * 2.0 ** -8 + 78 * 2.0 ** -24,
}


def mfcc(fe, samples: np.ndarray) -> np.ndarray:
    """Waveform -> cepstra with the Frontend's own window, filterbank and
    DCT matrices (fe.py Frontend._process_batch semantics)."""
    x = np.asarray(samples, np.float64)
    n = fe.n_frames(len(x))
    y = x - fe.alpha * np.concatenate([[0.0], x[:-1]]) if fe.alpha else x
    need = (n - 1) * fe.frame_shift + fe.frame_size
    y = np.concatenate([y, np.zeros(max(need - len(y), 0))])
    idx = (np.arange(n) * fe.frame_shift)[:, None] + np.arange(fe.frame_size)
    frames = y[idx]
    if fe.remove_dc:
        frames = frames - frames.mean(-1, keepdims=True)
    spec = np.fft.rfft(frames * fe.window, n=fe.nfft)
    mel = (spec.real ** 2 + spec.imag ** 2) @ fe.filters
    cep = np.where(mel > 0, np.log(np.maximum(mel, 1e-300)), -10.0) @ fe.dct
    return cep * fe.lifter if fe.lifter is not None else cep


def parity_densities(feats, g: GaussianParams, slices, f: int,
                     logbase: float = 1.0001) -> np.ndarray:
    """Stream f's integer logmath densities [T, K] (gauden_dist_precompute
    per-dim truncation, then C truncation toward zero)."""
    inv = 1.0 / math.log(logbase)
    ln = g.veclen[f]
    v = g.var[0, f, :, :ln].astype(np.float64)
    m = g.means[0, f, :, :ln].astype(np.float64)
    prec = np.trunc((1.0 / (2.0 * v)) * inv)
    det = np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v)) * inv).sum(-1)
    x = np.asarray(feats, np.float64)[:, slices[f]]
    d = det[None] - (((x[:, None, :] - m[None]) ** 2) * prec[None]).sum(-1)
    return np.trunc(np.clip(d, -2.0e9, 0.0)).astype(np.int64)


def parity_scores(feats, g: GaussianParams, raw_mixw: np.ndarray,
                  slices: Sequence[np.ndarray], topn: int = 4,
                  logbase: float = 1.0001, shift: int = 10,
                  max_neg_ascr: int = 96) -> np.ndarray:
    """s2_semi_mgau eval_topn + get_scores_8b_feat in float64/int64:
    natural-log senone scores [T, n_sen]."""
    table = logadd8_table(logbase, shift).astype(np.int64)
    acc = 0
    for f in range(g.n_feat):
        d = parity_densities(feats, g, slices, f, logbase)
        idx = np.argsort(-d, axis=1, kind="stable")[:, :topn]
        vals = np.take_along_axis(d, idx, 1)
        fsc = np.minimum(-((vals >> shift) - (vals[:, :1] >> shift)),
                         max_neg_ascr)
        w = raw_mixw[f].astype(np.int64)[idx]                 # [T, N, S]
        tmp = w[:, 0] + fsc[:, 0:1]
        for j in range(1, topn):
            y = w[:, j] + fsc[:, j:j + 1]
            tmp = np.minimum(tmp, y) - table[np.minimum(np.abs(tmp - y), 255)]
        acc = acc + tmp
    return -acc * ((1 << shift) * math.log(logbase))


def semi_scores(feats, g: GaussianParams, ln_mixw: np.ndarray,
                slices: Sequence[np.ndarray]) -> np.ndarray:
    """Exact semi-continuous senone scores [T, S] (no top-N)."""
    out = 0.0
    for f in range(g.n_feat):
        ln = g.veclen[f]
        x = np.asarray(feats, np.float64)[:, slices[f]]
        m = g.means[0, f, :, :ln].astype(np.float64)
        v = g.var[0, f, :, :ln].astype(np.float64)
        d = (-0.5 * (np.log(v).sum(-1) + ln * math.log(2 * math.pi))[None]
             - (((x[:, None, :] - m[None]) ** 2) / (2 * v[None])).sum(-1))
        mx = d.max(1, keepdims=True)
        out = out + np.log(np.exp(d - mx) @ np.exp(
            ln_mixw[f].astype(np.float64))) + mx
    return out


def cont_scores(feats, g: GaussianParams, ln_mixw: np.ndarray):
    """Continuous senone scores [T, S] and the magnitude [T, S] of the
    terms the expanded form sums (max over k of |const| + |x|.|lin| +
    x^2.prec), both float64.  ln_mixw [S, K]."""
    S, K, D = g.n_mgau, g.n_density, g.maxlen
    m = g.means[:, 0].astype(np.float64).reshape(S * K, D)
    v = g.var[:, 0].astype(np.float64).reshape(S * K, D)
    p = 0.5 / v
    const = (-0.5 * (np.log(v).sum(-1) + D * math.log(2 * math.pi))
             + ln_mixw.astype(np.float64).reshape(S * K)
             - (p * m * m).sum(-1))
    x = np.asarray(feats, np.float64)
    ll = const[None] + x @ (2 * p * m).T - (x * x) @ p.T      # [T, S*K]
    mag = np.abs(const)[None] + np.abs(x) @ np.abs(2 * p * m).T + (x * x) @ p.T
    ll = ll.reshape(-1, S, K)
    mx = ll.max(-1, keepdims=True)
    score = (np.log(np.exp(ll - mx).sum(-1)) + mx[..., 0])
    return score, mag.reshape(-1, S, K).max(-1)

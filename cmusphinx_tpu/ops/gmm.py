"""GMM senone scoring as batched matmul + log-sum-exp.

This replaces the reference's scalar hot loops (SURVEY.md §3.2: eval_topn /
eval_cb in s2_semi_mgau.c:81-180, senone logadd :217-530; ptm_mgau.c:99-260;
sphinx3 cont_mgau.c:1174 mgau_eval) with dense batched programs.

Key reformulation: the log Gaussian density

    ll[t, k] = lrd[k] - sum_d prec[k,d] * (x[t,d] - mean[k,d])^2

expands to `const[k] + x_t . lin[k] - (x_t*x_t) . prec[k]`, i.e. two matmuls
[T, D] @ [D, K] — the Mahalanobis distance for ALL codewords and ALL frames
is a pair of GEMMs.  The senone mixture then uses the exp-normalize trick:
with per-frame density max m_t,

    score[t, s] = log( sum_k exp(ll[t,k] - m_t) * w[k,s] ) + m_t

where the inner sum is again a single GEMM [T, K] @ [K, S] in linear space.
So semi-continuous senone scoring = 3 matmuls + 1 log, with no top-N
shortlist (the reference's top-4 is an approximation born of scalar CPUs).
A `topn` option reproduces the reference's shortlisting for parity tests.

Scorers return natural-log senone scores [T, n_sen].  Scores are exact
(unnormalized) log-likelihoods; decoders may subtract the per-frame max —
Viterbi paths and beams are invariant to per-frame constants.

All scorers are stateless pytrees of device arrays; `score()` is pure and
jit/vmap/pjit-compatible.  For multi-device serving, shard the senone axis
of the mixture-weight table (S is the large dimension) with
`NamedSharding(mesh, P(None, "mp"))` — the [T,K]@[K,S] GEMM then runs fully
sharded with no collectives until the final per-frame max (SURVEY.md §2.10 P5).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# GMM log-densities are numerically sensitive: a reduced-precision matmul
# (bf16 or TF32 operands) costs ~0.02-0.1 absolute in log space — enough to
# flip near-tie Viterbi paths.  All scoring GEMMs request full f32.
HIGHEST = jax.lax.Precision.HIGHEST

# Serving-precision ladder for the continuous scorer (-gmmprec), as explicit
# dot algorithms so that a mode means the same arithmetic on every backend
# (Precision.HIGH would be TF32 on the GPU and bf16x3 elsewhere):
# - "highest": IEEE f32 operands and accumulation;
# - "high": each f32 operand split into bf16 hi + lo and three bf16 products
#   (hi.hi + hi.lo + lo.hi) accumulated in f32, ~2^-16 relative operand
#   error;
# - "bf16": parameters stored in bfloat16 and one bf16 product with f32
#   accumulation.
# CAUTION on anything below "highest": the expanded quadratic form cancels
# prec*mean^2-magnitude terms, and trained GMMs with floored variances push
# those terms to ~1e6 nats.  A single bf16 pass (2^-8 operand rounding) then
# leaves thousands of nats of density error, which took a floored-variance
# CD model from 0% to 19.6% WER; TF32 (2^-11) would fail the same way.  "high"
# keeps the error to a few nats at that magnitude.  "highest" stays the
# default; precision is opt-in serving configuration, like the reference's
# own quantized scoring modes (sendump 8/4-bit, s2_semi_mgau.c:889).
GEMM_PRECISIONS = {
    "highest": jax.lax.DotAlgorithmPreset.F32_F32_F32,
    "high": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "bf16": jax.lax.DotAlgorithmPreset.BF16_BF16_F32,
}

from ..models.gauden import GaussianParams


def density_logliks(x, means, prec, lrd):
    """Log Gaussian densities for all codewords.

    x: [T, D]; means/prec: [K, D]; lrd: [K]  ->  [T, K]

    prec is 0.5/var (zero in padded dims); lrd is the log normalizer.
    """
    lin = 2.0 * prec * means                      # [K, D]
    const = lrd - jnp.sum(prec * means * means, -1)  # [K]
    return (const[None, :]
            + jnp.dot(x, lin.T, precision=HIGHEST)
            - jnp.dot(x * x, prec.T, precision=HIGHEST))


def _mask_topn(d, topn: int):
    """Keep only the top-N densities per frame (reference eval_topn
    semantics), masking the rest to -inf."""
    if topn <= 0 or topn >= d.shape[-1]:
        return d
    vals, _ = jax.lax.top_k(d, topn)
    thresh = vals[..., -1:]
    return jnp.where(d >= thresh, d, -jnp.inf)


class SemiContinuousScorer:
    """Semi-continuous / tied-codebook senone scorer (s2_semi_mgau capability).

    One shared codebook per feature stream; senones mix the same K densities
    with per-senone weights.  hub4wsj_sc_8k: 3 streams x 256 densities x
    5150 senones; tidigits: 4 streams (s2_4x) x 256 x 670.
    """

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray,
                 stream_slices: Sequence[np.ndarray], topn: int = 0):
        if gauden.n_mgau != 1:
            raise ValueError("semi-continuous scorer needs a single codebook set")
        self.n_feat = gauden.n_feat
        self.n_density = gauden.n_density
        self.n_sen = ln_mixw.shape[-1]
        self.topn = topn
        self.stream_slices = [np.asarray(s, np.int32) for s in stream_slices]
        if len(self.stream_slices) != self.n_feat:
            raise ValueError(
                f"{len(self.stream_slices)} streams but model has {self.n_feat}")
        # Per-stream parameter tensors (trim padding to each stream's veclen).
        self.means = []
        self.prec = []
        self.lrd = []
        for f in range(self.n_feat):
            ln = gauden.veclen[f]
            self.means.append(jnp.asarray(gauden.means[0, f, :, :ln]))
            self.prec.append(jnp.asarray(gauden.prec[0, f, :, :ln]))
            self.lrd.append(jnp.asarray(gauden.lrd[0, f]))
        # Linear-domain mixture weights for the GEMM trick.
        self.w = jnp.asarray(np.exp(ln_mixw.astype(np.float64)).astype(np.float32))

    def score(self, feats) -> jnp.ndarray:
        """feats [T, D_total] -> ln senone scores [T, n_sen]."""
        out = None
        for f in range(self.n_feat):
            x = feats[:, self.stream_slices[f]]
            d = density_logliks(x, self.means[f], self.prec[f], self.lrd[f])
            d = _mask_topn(d, self.topn)
            m = jnp.max(d, axis=-1, keepdims=True)          # [T, 1]
            e = jnp.exp(d - m)                               # [T, K]
            p = jnp.dot(e, self.w[f], precision=HIGHEST)     # [T, S] GEMM
            s = jnp.log(jnp.maximum(p, 1e-37)) + m
            out = s if out is None else out + s
        return out

    def __call__(self, feats):
        return self.score(feats)


class ContinuousScorer:
    """Fully-continuous per-senone GMM scorer (sphinx3 cont_mgau / ms_mgau
    capability): one codebook per senone.

    means/prec: [S, K, D]; ln_mixw: [S, K] (single stream) ->
    score[t,s] = logsumexp_k( lnw[s,k] + ll[t,s,k] ), computed as one GEMM
    of the augmented features [x, x*x] against w = [lin; -quad] [2D, S*K].
    """

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray,
                 topn: int = 0, precision: str = "highest"):
        if gauden.n_feat != 1:
            raise ValueError("continuous scorer expects a single feature stream")
        if precision not in GEMM_PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{sorted(GEMM_PRECISIONS)}, got {precision!r}")
        S, K, D = gauden.n_mgau, gauden.n_density, gauden.maxlen
        means = gauden.means[:, 0]       # [S, K, D]
        prec = gauden.prec[:, 0]
        lrd = gauden.lrd[:, 0]           # [S, K]
        lnw = ln_mixw.reshape(S, K) if ln_mixw.ndim != 2 else ln_mixw
        # Fold mixture weights into the density constant term.
        const = (lrd + lnw - (prec * means * means).sum(-1))  # [S, K]
        w = np.concatenate([(2.0 * prec * means).reshape(S * K, D).T,
                            -prec.reshape(S * K, D).T])       # [2D, S*K]
        self.precision = precision
        self.algorithm = GEMM_PRECISIONS[precision]
        self.ptype = jnp.bfloat16 if precision == "bf16" else jnp.float32
        self.w = jnp.asarray(w, self.ptype)
        self.const = jnp.asarray(const.reshape(S * K), jnp.float32)
        self.n_sen, self.n_density = S, K
        self.topn = topn

    def densities(self, feats) -> jnp.ndarray:
        """Weighted log densities lnw + ll, feats [T, D] -> [T, S, K]."""
        # Square in f32 first (x*x then round beats round(x)^2).
        xa = jnp.concatenate([feats, feats * feats], -1).astype(self.ptype)
        ll = self.const[None, :] + jnp.dot(
            xa, self.w, precision=self.algorithm,
            preferred_element_type=jnp.float32)
        return ll.reshape(feats.shape[0], self.n_sen, self.n_density)

    def score(self, feats) -> jnp.ndarray:
        """feats [T, D] -> [T, S]."""
        ll = self.densities(feats)
        if self.topn:
            ll = _mask_topn(ll, self.topn)
        return jax.nn.logsumexp(ll, axis=-1)

    def __call__(self, feats):
        return self.score(feats)


class PTMScorer:
    """Phonetically-tied-mixture scorer (ptm_mgau capability): one codebook
    per CI phone; each senone mixes its phone's codebook.

    gauden: n_mgau = n_ci codebooks; ln_mixw [n_sen, K]; sen2cb [n_sen]
    maps senone -> codebook.
    """

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray,
                 sen2cb: np.ndarray, topn: int = 0):
        if gauden.n_feat != 1:
            raise ValueError("PTM scorer expects a single feature stream")
        C, K, D = gauden.n_mgau, gauden.n_density, gauden.maxlen
        means = gauden.means[:, 0]       # [C, K, D]
        prec = gauden.prec[:, 0]
        lrd = gauden.lrd[:, 0]
        const = lrd - (prec * means * means).sum(-1)          # [C, K]
        self.lin = jnp.asarray((2.0 * prec * means).reshape(C * K, D).T)
        self.quad = jnp.asarray(prec.reshape(C * K, D).T)
        self.const = jnp.asarray(const.reshape(C * K))
        self.lnw = jnp.asarray(ln_mixw.astype(np.float32))    # [S, K]
        self.sen2cb = jnp.asarray(sen2cb.astype(np.int32))    # [S]
        self.n_cb, self.n_density = C, K
        self.n_sen = ln_mixw.shape[0]
        self.topn = topn

    def score(self, feats) -> jnp.ndarray:
        T = feats.shape[0]
        ll = (self.const[None, :]
              + jnp.dot(feats, self.lin, precision=HIGHEST)
              - jnp.dot(feats * feats, self.quad, precision=HIGHEST)
              ).reshape(T, self.n_cb, self.n_density)
        if self.topn:
            ll = _mask_topn(ll, self.topn)
        per_sen = ll[:, self.sen2cb, :]                       # [T, S, K] gather
        return jax.nn.logsumexp(per_sen + self.lnw[None], axis=-1)

    def __call__(self, feats):
        return self.score(feats)


def logadd8_table(base: float = 1.0001, shift: int = 10) -> np.ndarray:
    """The reference's 8-bit shifted logadd table (logmath.c:90-160 built with
    logmath_init(base, SENSCR_SHIFT, TRUE)): table[d] = shifted-round of
    log_base(1 + base^-(d<<shift)) evaluated at the first full-domain index
    mapping to d."""
    import math as _m
    ln_b = _m.log(base)
    d = np.arange(256, dtype=np.int64)
    i = (d << shift).astype(np.float64)
    k = np.floor((np.log1p(np.power(base, -i)) / ln_b) + 0.5 * (1 << shift))
    return (k.astype(np.int64) >> shift).astype(np.int32)


class PsParityScorer:
    """Bit-faithful emulation of the reference semi-continuous scorer
    (s2_semi_mgau.c eval_topn/eval_cb/mgau_norm/get_scores_8b_feat):

    densities in the quantized logmath domain (int32, units of
    2^shift * ln(base) ~= 0.1024 nats), per-frame/per-stream top-N, best
    normalized to 0, negated, clamped to MAX_NEG_ASCR; senone scores =
    8-bit-table logadd of (quantized mixw byte + density) summed over
    streams.  The clamps (MAX_NEG_ASCR=96 ~= 9.8 nats, MAX_NEG_MIXW=159)
    act as robustness floors and materially shape WER — use this scorer to
    reproduce the reference's decoding behavior on its shipped models.

    Returns natural-log senone scores [T, n_sen], frame-relative (<= 0).
    """

    MAX_NEG_ASCR = 96    # tied_mgau_common.h:85
    MAX_NEG_MIXW = 159   # tied_mgau_common.h:84

    def __init__(self, gauden: GaussianParams, raw_mixw: np.ndarray,
                 stream_slices: Sequence[np.ndarray], topn: int = 4,
                 logbase: float = 1.0001, shift: int = 10,
                 wrap_uint8: bool = False):
        import math as _m
        if gauden.n_mgau != 1:
            raise ValueError("parity scorer needs a single codebook set")
        self.n_feat = gauden.n_feat
        self.topn = topn
        self.ln_b = _m.log(logbase)
        self.shift = shift
        self.scale = float((1 << shift) * self.ln_b)
        self.stream_slices = [np.asarray(s, np.int32) for s in stream_slices]
        inv = 1.0 / self.ln_b
        self.means, self.prec, self.lrd = [], [], []
        for f in range(self.n_feat):
            ln = gauden.veclen[f]
            self.means.append(jnp.asarray(gauden.means[0, f, :, :ln]))
            # Logmath-domain precomputation with the reference's per-dim
            # integer truncation (gauden_dist_precompute ms_gauden.c:332-351:
            # det += (int)logmath_log(1/sqrt(2 pi var)) per dim; var =
            # (int)logmath_ln_to_log(1/(2 var))).
            v = gauden.var[0, f, :, :ln].astype(np.float64)
            # NB: the reference passes the *linear* precision 1/(2 var) to
            # logmath_ln_to_log, which only scales by 1/ln(base) — no log.
            prec_lm = np.trunc((1.0 / (2.0 * v)) * inv)
            det_lm = np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v)) * inv
                              ).sum(axis=-1)
            self.prec.append(jnp.asarray(prec_lm.astype(np.float32)))
            self.lrd.append(jnp.asarray(det_lm.astype(np.float32)))
        # Bytes are used as-is — MAX_NEG_MIXW clamping happens only when
        # quantizing float mixture_weights, not on sendump load.
        mw = raw_mixw.astype(np.int32)
        self.mixw = [jnp.asarray(mw[f]) for f in range(self.n_feat)]  # [K, S]
        # 4-bit models precompute w_den = mixw_cb + density in a uint8 array
        # (get_scores_4b_feat_*), so the sum wraps at 256; 8-bit models
        # promote to int and do not.
        self.wrap_uint8 = wrap_uint8
        self.n_sen = raw_mixw.shape[-1]
        table8 = logadd8_table(logbase, shift)
        # The 256-entry logadd table is monotone non-increasing with a tiny
        # value range (0..~7), so table8[dd] is re-expressed as a sum of
        # threshold comparisons sum_v [dd < t_v] — bit-exact, and an
        # elementwise chain that fuses instead of a [T, S] dynamic gather.
        assert np.all(np.diff(table8) <= 0), "logadd table must be monotone"
        vmax = int(table8[0])
        self._tbl_steps = jnp.asarray(
            np.asarray([(table8 >= v).sum() for v in range(1, vmax + 1)],
                       np.int32))
        self._score = jax.jit(self._score_impl)

    def _logadd_tbl(self, dd):
        """Exact table8[dd] via threshold sums (dd int32 >= 0, <= 255)."""
        out = jnp.zeros_like(dd)
        for v in range(self._tbl_steps.shape[0]):
            out = out + (dd < self._tbl_steps[v]).astype(jnp.int32)
        return out

    @staticmethod
    def _topn_select(d, n):
        """Top-n values+indices by iterative argmax + single-index mask.
        Selection-identical to jax.lax.top_k (argmax and top_k both take
        the lowest index on ties, and masking one index per round keeps
        duplicate values as separate entries — the reference's insertion
        sort does too, s2_semi_mgau.c:81-118), but runs as n max/argmax
        reductions instead of a full [T, K] sort."""
        iota = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
        vals, idxs = [], []
        for _ in range(n):
            am = jnp.argmax(d, axis=1).astype(jnp.int32)
            vals.append(jnp.max(d, axis=1))
            idxs.append(am)
            d = jnp.where(iota == am[:, None], jnp.iinfo(jnp.int32).min, d)
        return jnp.stack(vals, 1), jnp.stack(idxs, 1)

    def int_densities(self, feats, f: int):
        """Stream f's integer logmath densities [T, K]."""
        x = feats[:, self.stream_slices[f]]
        d = density_logliks(x, self.means[f], self.prec[f], self.lrd[f])
        # Saturate before the int cast (the reference's float->int32
        # overflow lands at INT_MIN on x86; these never reach the top-N).
        return jnp.clip(d, -2.0e9, 0.0).astype(jnp.int32)  # C trunc-to-zero

    def _score_impl(self, feats):
        acc = None
        for f in range(self.n_feat):
            d_int = self.int_densities(feats, f)
            vals, idx = self._topn_select(d_int, self.topn)   # [T, N]
            norm = jnp.right_shift(vals[:, :1], self.shift)
            fsc = -(jnp.right_shift(vals, self.shift) - norm) # [T, N] >= 0
            fsc = jnp.minimum(fsc, self.MAX_NEG_ASCR)
            w = self.mixw[f][idx]                             # [T, N, S]
            wrap = (lambda v: v & 0xFF) if self.wrap_uint8 else (lambda v: v)
            tmp = wrap(w[:, 0] + fsc[:, 0:1])
            for j in range(1, self.topn):
                y = wrap(w[:, j] + fsc[:, j : j + 1])
                lo = jnp.minimum(tmp, y)
                dd = jnp.minimum(jnp.abs(tmp - y), 255)
                tmp = lo - self._logadd_tbl(dd)
            acc = tmp if acc is None else acc + tmp
        return -acc.astype(jnp.float32) * jnp.float32(self.scale)

    def score(self, feats) -> jnp.ndarray:
        return self._score(feats)

    def __call__(self, feats):
        return self.score(feats)


def naive_semi_scores(feats, gauden: GaussianParams, ln_mixw, stream_slices):
    """Pure-numpy O(T*K*S) reference implementation for unit tests."""
    T = feats.shape[0]
    S = ln_mixw.shape[-1]
    out = np.zeros((T, S), np.float64)
    for f in range(gauden.n_feat):
        ln = gauden.veclen[f]
        x = np.asarray(feats)[:, stream_slices[f]]
        m = gauden.means[0, f, :, :ln]
        p = gauden.prec[0, f, :, :ln]
        d = gauden.lrd[0, f][None, :] - (
            (x[:, None, :] - m[None]) ** 2 * p[None]).sum(-1)  # [T, K]
        ll = d[:, :, None] + ln_mixw[f][None]                   # [T, K, S]
        mx = ll.max(axis=1, keepdims=True)
        out += (np.log(np.exp(ll - mx).sum(axis=1)) + mx[:, 0]).astype(np.float64)
    return out


class InterpolatedScorer:
    """Decode-time CD/CI senone interpolation (sphinx3
    libs3decoder/libam/interp.c:179-196 interp_all): every CD senone's
    score becomes

        logadd(score[cd] + log(lambda[cd]), score[ci(cd)] + log(1-lambda[cd]))

    with per-senone weights lambda (estimated by deleted interpolation,
    train/transform.py deleted_interpolation / the delint program).  CI
    senones pass through unchanged.  One vectorized logaddexp over the
    [T, S] score matrix — the reference's per-senone loop disappears.

    scorer: any senone scorer; cd2cisen [S]: parent CI senone per senone
    (mdef.cd2cisen); lam: scalar or [S] interpolation weights.
    """

    def __init__(self, scorer, cd2cisen: np.ndarray, n_ci_sen: int,
                 lam):
        self.inner = scorer
        self.n_sen = scorer.n_sen
        lam = np.broadcast_to(np.asarray(lam, np.float32),
                              (self.n_sen,)).copy()
        lam = np.clip(lam, 1e-6, 1.0 - 1e-6)
        self._log_cd = jnp.asarray(np.log(lam))
        self._log_ci = jnp.asarray(np.log1p(-lam))
        self._ci = jnp.asarray(np.asarray(cd2cisen, np.int32))
        self._is_cd = jnp.asarray(np.arange(self.n_sen) >= int(n_ci_sen))

    def score(self, feats):
        s = self.inner.score(feats)
        mixed = jnp.logaddexp(s + self._log_cd[None],
                              s[:, self._ci] + self._log_ci[None])
        return jnp.where(self._is_cd[None], mixed, s)

    def __call__(self, feats):
        return self.score(feats)

"""Feature-space and model-space transform estimation: LDA, MLLT, MAP
adaptation, deleted interpolation, mixture-weight interpolation.

Capability parity with the reference's transform toolchain:
- LDA: SphinxTrain/python/cmusphinx/lda.py (class-scatter eigenproblem) and
  pipeline stage scripts_pl/01.lda_train; application at decode time is
  sphinxbase feat/lda.c (already in frontend.feat).
- MLLT: SphinxTrain/python/cmusphinx/mllt.py:34-60 (maximum-likelihood
  linear transform objective optimized with l-bfgs in the reference; here
  jax autodiff + optax adam — same objective, on-device optimizer).
- MAP adaptation: SphinxTrain/src/programs/map_adapt (Bayesian interpolation
  of prior model with adaptation-data counts).
- Deleted interpolation: SphinxTrain/src/programs/delint +
  scripts_pl/90.deleted_interpolation (EM for CD/CI senone interpolation
  weights over held-out count blocks).
- mixw_interp: SphinxTrain/src/programs/mixw_interp (static interpolation of
  two mixture-weight sets).

All estimation is dense linear algebra on [D, D]/[S, K] tensors — a natural
fit for matrix hardware; everything here is pure and jit-compatible.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------------
# LDA / MLLT
# ----------------------------------------------------------------------

def class_scatter_stats(feats: np.ndarray, labels: np.ndarray,
                        n_classes: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-class first/second-order stats for LDA/MLLT.

    feats [N, D] with integer class labels [N] (e.g. senone ids from a
    Viterbi forced alignment, as the reference collects with `agg_seg` /
    `bw -outputaccs`).  Returns (counts [C], sums [C, D], sqsums [C, D, D]).
    """
    feats = np.asarray(feats, np.float64)
    labels = np.asarray(labels, np.int64)
    N, D = feats.shape
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    sums = np.zeros((n_classes, D))
    np.add.at(sums, labels, feats)
    sq = np.einsum("ni,nj->nij", feats, feats)
    sqsums = np.zeros((n_classes, D, D))
    np.add.at(sqsums, labels, sq)
    return counts, sums, sqsums


def estimate_lda(counts: np.ndarray, sums: np.ndarray, sqsums: np.ndarray,
                 dim_out: int = 0) -> np.ndarray:
    """LDA projection from class stats (lda.py capability).

    Solves the generalized eigenproblem Sb v = l Sw v via Sw^-1 Sb and
    returns the projection matrix [dim_out, D] sorted by decreasing
    eigenvalue.  With dim_out=0, returns the full square transform.
    """
    counts = np.asarray(counts, np.float64)
    ok = counts > 0
    Ntot = counts.sum()
    D = sums.shape[1]
    mean_c = np.zeros_like(sums)
    mean_c[ok] = sums[ok] / counts[ok, None]
    gmean = sums.sum(0) / Ntot
    # Within-class scatter: sum_c (sq_c - n_c mu_c mu_c^T)
    Sw = sqsums.sum(0) - np.einsum(
        "c,ci,cj->ij", counts, mean_c, mean_c)
    # Between-class scatter.
    dm = mean_c - gmean[None]
    Sb = np.einsum("c,ci,cj->ij", counts, dm, dm)
    Sw += 1e-6 * np.eye(D) * max(np.trace(Sw) / D, 1.0)
    evals, evecs = np.linalg.eig(np.linalg.solve(Sw, Sb))
    order = np.argsort(-evals.real)
    V = evecs[:, order].real.T          # rows are eigenvectors
    # Normalize rows (the reference normalizes the LDA rows to unit length).
    V = V / np.linalg.norm(V, axis=1, keepdims=True)
    if dim_out:
        V = V[:dim_out]
    return V.astype(np.float32)


def mllt_objective(A, cov, counts):
    """Negative MLLT log-likelihood (mllt.py:34-60 capability): maximize
    N log|det A| - 0.5 * sum_c n_c * log prod_d (A Sigma_c A^T)_dd."""
    import jax.numpy as jnp
    N = counts.sum()
    sign, logdet = jnp.linalg.slogdet(A)
    proj = jnp.einsum("id,cde,je->cij", A, cov, A)
    diag = jnp.diagonal(proj, axis1=1, axis2=2)
    ll = N * logdet - 0.5 * jnp.sum(counts * jnp.sum(
        jnp.log(jnp.maximum(diag, 1e-10)), axis=1))
    return -ll


def estimate_mllt(counts: np.ndarray, sums: np.ndarray, sqsums: np.ndarray,
                  n_iter: int = 500, lr: float = 1e-3) -> np.ndarray:
    """Maximum-likelihood linear transform [D, D] from class stats.

    The reference optimizes the same objective with scipy l-bfgs
    (mllt.py:60); here: optax adam on the jax gradient.
    """
    import jax
    import jax.numpy as jnp
    import optax

    counts = np.asarray(counts, np.float64)
    ok = counts > 0
    D = sums.shape[1]
    mean_c = np.zeros_like(sums)
    mean_c[ok] = sums[ok] / counts[ok, None]
    cov = np.zeros_like(sqsums)
    cov[ok] = (sqsums[ok] / counts[ok, None, None]
               - np.einsum("ci,cj->cij", mean_c[ok], mean_c[ok]))
    cov[ok] += 1e-6 * np.eye(D)[None]
    cnt = jnp.asarray(counts[ok], jnp.float32)
    cv = jnp.asarray(cov[ok], jnp.float32)

    loss = jax.jit(lambda A: mllt_objective(A, cv, cnt))
    grad = jax.jit(jax.grad(loss))
    A = jnp.eye(D, dtype=jnp.float32)
    opt = optax.adam(lr)
    state = opt.init(A)

    @jax.jit
    def step(A, state):
        g = grad(A)
        upd, state = opt.update(g, state)
        return optax.apply_updates(A, upd), state

    for _ in range(n_iter):
        A, state = step(A, state)
    return np.asarray(A, np.float32)


def apply_mllt_to_model(A: np.ndarray, means: np.ndarray, var: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate model means/diagonal variances into MLLT space:
    mu' = A mu; var' = diag(A diag(var) A^T)."""
    m2 = np.einsum("ij,skj->ski", A, means)
    v2 = np.einsum("ij,skj,dj->skid", A, var, A)
    v2 = np.diagonal(v2, axis1=2, axis2=3).copy()
    return m2.astype(np.float32), np.maximum(v2, 1e-5).astype(np.float32)


# ----------------------------------------------------------------------
# MAP adaptation (map_adapt capability)
# ----------------------------------------------------------------------

def map_adapt(params, acc: Dict[str, np.ndarray], tau: float = 10.0,
              adapt_mixw: bool = True):
    """MAP re-estimation of means (and optionally mixture weights) from one
    BW accumulation pass over adaptation data.

    mu_map = (tau * mu_prior + sum_t gamma x_t) / (tau + sum_t gamma);
    w_map ∝ (tau * w_prior + counts).  Variances keep the prior (the
    reference's default -varadapt no).  `params` is a train.trainer.HmmParams;
    returns a new HmmParams.
    """
    from .trainer import HmmParams

    g = np.asarray(acc["mixw"])          # [S, K] occupancy
    mx = np.asarray(acc["mean"])         # [S, K, D] weighted feature sums
    denom = tau + g
    means = (tau * params.means + mx) / denom[..., None]
    if adapt_mixw:
        w_prior = np.exp(params.lnw.astype(np.float64))
        w_prior = w_prior / np.maximum(w_prior.sum(-1, keepdims=True), 1e-10)
        w = tau * w_prior + g
        w = w / np.maximum(w.sum(-1, keepdims=True), 1e-10)
        lnw = np.log(np.maximum(w, 1e-10)).astype(np.float32)
    else:
        lnw = params.lnw
    return HmmParams(means=means.astype(np.float32), var=params.var,
                     lnw=lnw, tp=params.tp)


# ----------------------------------------------------------------------
# Deleted interpolation (delint capability)
# ----------------------------------------------------------------------

def deleted_interpolation(cd_count_blocks: Sequence[np.ndarray],
                          ci_count_blocks: Sequence[np.ndarray],
                          sen2ci: np.ndarray, n_iter: int = 20
                          ) -> np.ndarray:
    """EM estimation of per-CD-senone interpolation weights lambda such that

        w = lambda * w_cd + (1 - lambda) * w_ci[sen2ci]

    maximizes held-out likelihood: for each deleted block b, the counts of
    block b are scored with mixture weights estimated from all OTHER blocks
    (delint / 90.deleted_interpolation capability).  Blocks are >= 2
    [S, K] (or [S, F, K]) count arrays, e.g. per-part BW accumulators.
    Returns lambda [S].
    """
    cd = [np.asarray(b, np.float64) for b in cd_count_blocks]
    ci = [np.asarray(b, np.float64) for b in ci_count_blocks]
    nb = len(cd)
    if nb < 2:
        raise ValueError("deleted interpolation needs >= 2 count blocks")
    cd_tot = sum(cd)
    ci_tot = sum(ci)
    S = cd_tot.shape[0]
    sen2ci = np.asarray(sen2ci, np.int64)

    def norm(c):
        s = c.sum(-1, keepdims=True)
        return np.where(s > 0, c / np.maximum(s, 1e-20), 1.0 / c.shape[-1])

    lam = np.full(S, 0.5)
    for _ in range(n_iter):
        num = np.zeros(S)
        den = np.zeros(S)
        for b in range(nb):
            w_cd = norm(cd_tot - cd[b])           # trained w/o block b
            w_ci = norm(ci_tot - ci[b])[sen2ci]
            held = cd[b]                           # held-out counts
            lcd = lam.reshape(S, *([1] * (held.ndim - 1)))
            p_cd = lcd * w_cd
            p = p_cd + (1.0 - lcd) * w_ci
            post = np.where(p > 0, p_cd / np.maximum(p, 1e-20), 0.0)
            num += (held * post).reshape(S, -1).sum(-1)
            den += held.reshape(S, -1).sum(-1)
        lam = np.where(den > 0, num / np.maximum(den, 1e-20), 0.5)
        lam = np.clip(lam, 1e-4, 1.0 - 1e-4)
    return lam.astype(np.float32)


def mixw_interp(mixw_a: np.ndarray, mixw_b: np.ndarray,
                lam) -> np.ndarray:
    """Static interpolation of two mixture-weight sets (mixw_interp
    capability).  lam may be scalar or per-senone [S]."""
    a = np.asarray(mixw_a, np.float64)
    b = np.asarray(mixw_b, np.float64)
    an = a / np.maximum(a.sum(-1, keepdims=True), 1e-20)
    bn = b / np.maximum(b.sum(-1, keepdims=True), 1e-20)
    lam = np.asarray(lam, np.float64)
    lam = lam.reshape(-1, *([1] * (a.ndim - 1))) if lam.ndim else lam
    out = lam * an + (1.0 - lam) * bn
    return (out / np.maximum(out.sum(-1, keepdims=True), 1e-20)
            ).astype(np.float32)

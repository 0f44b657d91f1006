"""Approximate-GMM evaluation family, dense/masked device formulations.

The reference's fast-GMM layer (sphinx3
libs3decoder/libam/approx_cont_mgau.c:108-276) combines four tricks to
avoid evaluating every Gaussian of every senone on a scalar CPU:

- frame downsampling (`-ds`): evaluate GMMs every ds-th frame, reuse the
  previous frame's scores in between (approx_cont_mgau.c:108-115);
- CIGMMS (`-cipbeam`): evaluate the (cheap) CI senones every frame; a CD
  senone is fully evaluated ONLY when its parent CI senone scores within
  a beam of the frame-best CI senone, otherwise its parent's score is
  substituted (approx_cont_mgau.c:150-200);
- Gaussian shortlists from sub-vector quantization (subvq.c — see
  ops/subvq.py) or VQ Gaussian selectors (gs.c) or kd-trees (kdtree.c).

On the device the dense evaluation is a pair of GEMMs, so selective
evaluation saves nothing unless it removes whole GEMM rows/frames.  This
module provides the two tricks that CAN change device cost or accuracy —
downsampling (removes frames: real FLOP savings) and CIGMMS (masking
only: zero savings in the dense regime, kept for behavior parity) — in
exact masked/dense form, so `evals/run_approx_gmm.py` can measure each
trick's speed/WER trade on a real model and record the keep/reject
verdict.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


class DownsampledScorer:
    """Frame-downsampled senone scoring (reference -ds semantics):
    score frames [0, ds, 2ds, ...] and substitute the previous computed
    frame's scores for the skipped ones."""

    def __init__(self, scorer, ds_ratio: int = 2):
        if ds_ratio < 1:
            raise ValueError("ds_ratio must be >= 1")
        self.inner = scorer
        self.ds = int(ds_ratio)
        self.n_sen = scorer.n_sen

    def score(self, feats):
        T = feats.shape[0]
        if self.ds == 1 or T == 0:
            return self.inner.score(feats)
        base = self.inner.score(feats[:: self.ds])        # [ceil(T/ds), S]
        return jnp.repeat(base, self.ds, axis=0,
                          total_repeat_length=base.shape[0] * self.ds)[:T]

    def __call__(self, feats):
        return self.score(feats)


class CigmmsScorer:
    """CI-GMM selection (CIGMMS): CD senones whose parent CI senone falls
    below the frame-best CI score by more than `ci_pbeam` take the parent
    CI score instead of their own (approx_cont_mgau.c CIGMMS).

    Dense formulation: both CI and CD scores are computed (the GEMM does
    not get cheaper by masking), then the bypass is applied exactly — so
    this measures the ACCURACY cost of the trick at zero device speed
    gain, which is the verdict the reference's trade-off must be re-judged
    by on an accelerator.

    cd2cisen: [n_sen] parent CI senone per senone (mdef.cd2cisen;
    CI senones map to themselves).
    """

    def __init__(self, scorer, cd2cisen: np.ndarray, n_ci_sen: int,
                 ci_pbeam: float = 7.0):
        self.inner = scorer
        self.n_sen = scorer.n_sen
        self.cd2ci = jnp.asarray(np.asarray(cd2cisen, np.int32))
        self.n_ci_sen = int(n_ci_sen)
        self.beam = float(ci_pbeam)

    def score(self, feats):
        s = self.inner.score(feats)                        # [T, S]
        ci = s[:, : self.n_ci_sen]
        best = jnp.max(ci, axis=1, keepdims=True)
        parent = s[:, self.cd2ci]                          # broadcastable
        keep = parent >= best - self.beam
        out = jnp.where(keep, s, parent)
        # CI senones always keep their own scores.
        return out.at[:, : self.n_ci_sen].set(ci)

    def __call__(self, feats):
        return self.score(feats)


class GsSelectorScorer:
    """VQ Gaussian-selector shortlists (sphinx3 gs.c / gausubvq's sibling
    `gs` backend): a coarse VQ codebook over the feature space maps each
    frame to its nearest cluster; only Gaussians associated with that
    cluster (assignment by their means) are evaluated exactly — the rest
    take a floor.  Dense-masked formulation: the full density matrix is
    computed (GEMMs don't get cheaper from masking) and
    non-shortlisted Gaussians are floored, measuring the trick's accuracy
    cost at its reference semantics.

    scorer: a ContinuousScorer (single-stream); n_clusters: VQ size;
    top_c: clusters kept per frame (gs_mgau_shortlist semantics).
    """

    def __init__(self, scorer, gauden, n_clusters: int = 64,
                 top_c: int = 2, floor: float = -40.0, seed: int = 0,
                 n_iter: int = 10):
        self.inner = scorer
        self.n_sen = scorer.n_sen
        S, K = gauden.n_mgau, gauden.n_density
        D = int(gauden.veclen[0])
        M = gauden.means[:, 0, :, :D].reshape(S * K, D).astype(np.float64)
        rng = np.random.RandomState(seed)
        C = min(n_clusters, len(M))
        cent = M[rng.choice(len(M), C, replace=False)].copy()
        for _ in range(n_iter):
            d = ((M[:, None] - cent[None]) ** 2).sum(-1)
            a = d.argmin(1)
            for c in range(C):
                m = a == c
                if m.any():
                    cent[c] = M[m].mean(0)
        d = ((M[:, None] - cent[None]) ** 2).sum(-1)
        self._assign = jnp.asarray(d.argmin(1).reshape(S, K)
                                   .astype(np.int32))
        self._cent = jnp.asarray(cent.astype(np.float32))     # [C, D]
        self.top_c = int(top_c)
        self.floor = float(floor)
        self._S, self._K, self._D = S, K, D

    def score(self, feats):
        x = feats[:, : self._D]
        # nearest clusters per frame
        d2 = ((x[:, None, :] - self._cent[None]) ** 2).sum(-1)  # [T, C]
        thr = -jax.lax.top_k(-d2, self.top_c)[0][:, -1:]
        keep_c = d2 <= thr                                      # [T, C]
        keep = keep_c[:, self._assign]                          # [T, S, K]
        ll = self.inner.densities(feats)                        # [T, S, K]
        best = jnp.max(ll, axis=(1, 2), keepdims=True)
        ll = jnp.where(keep, ll, best + self.floor)
        return jax.nn.logsumexp(ll, axis=-1)

    def __call__(self, feats):
        return self.score(feats)


class KdTreeSelectorScorer:
    """Bucket-Box-Intersection kd-tree Gaussian shortlists (sphinx3
    libs3decoder/libam/kdtree.c:1-294, implementing Fritsch & Rogina's
    BBI algorithm, ICASSP 1996): a kd-tree partitions feature space into
    2^depth buckets; each Gaussian owns a box (mean +/- radius*stddev,
    the region where its density is within the BBI threshold of its
    peak), and a bucket's shortlist is every Gaussian whose box
    intersects the bucket.  At eval a frame descends the tree by `depth`
    scalar comparisons and only its bucket's shortlist is scored.

    Dense-masked formulation, like the rest of this family: the full
    density GEMM is computed (masking saves nothing in a GEMM), the
    descent is `depth` vectorized compares, and non-shortlisted Gaussians
    are floored — measuring the trick's accuracy cost at its reference
    semantics for the keep/reject verdict.

    scorer: a ContinuousScorer (single-stream).  depth: tree depth
    (2^depth buckets; reference -kdmaxdepth).  radius: box half-width in
    stddevs (the BBI threshold knob).  maxbbi caps a bucket's shortlist
    by box-volume overlap (reference -kdmaxbbi).
    """

    def __init__(self, scorer, gauden, depth: int = 6, radius: float = 3.0,
                 maxbbi: int = 0, floor: float = -40.0):
        self.inner = scorer
        self.n_sen = scorer.n_sen
        S, K = gauden.n_mgau, gauden.n_density
        D = int(gauden.veclen[0])
        M = gauden.means[:, 0, :, :D].reshape(S * K, D).astype(np.float64)
        SD = np.sqrt(gauden.var[:, 0, :, :D].reshape(S * K, D)
                     .astype(np.float64))
        box_lo = M - radius * SD
        box_hi = M + radius * SD
        n_nodes = 1 << depth               # heap-indexed internal nodes 1..
        n_leaves = 1 << depth
        node_dim = np.zeros(2 * n_nodes, np.int32)
        node_thr = np.zeros(2 * n_nodes, np.float32)
        leaf_keep = np.zeros((n_leaves, S * K), bool)

        def build(node: int, lo: np.ndarray, hi: np.ndarray, level: int,
                  cand: np.ndarray) -> None:
            if level == depth:
                leaf = node - n_nodes
                # Bucket-box intersection over the candidate set.
                inter = cand
                if maxbbi and inter.sum() > maxbbi:
                    # Keep the maxbbi Gaussians with the largest overlap
                    # volume fraction inside this bucket (read_bbi_list's
                    # maxbbi truncation semantics).
                    ov_lo = np.maximum(box_lo, lo[None])
                    ov_hi = np.minimum(box_hi, hi[None])
                    frac = np.where(
                        inter[:, None],
                        np.clip(ov_hi - ov_lo, 1e-10, None)
                        / np.clip(box_hi - box_lo, 1e-10, None), 0.0)
                    vol = np.sum(np.log(np.clip(frac, 1e-10, None)), 1)
                    vol = np.where(inter, vol, -np.inf)
                    keep_idx = np.argsort(vol, kind="stable")[-maxbbi:]
                    capped = np.zeros_like(inter)
                    capped[keep_idx] = inter[keep_idx]
                    inter = capped
                leaf_keep[leaf] = inter
                return
            # Split the dimension with the largest candidate-mean spread,
            # at the candidate median (the projection-search capability of
            # the reference builder, simplified to the median heuristic).
            cm = M[cand] if cand.any() else M
            dim = int(np.argmax(cm.max(0) - cm.min(0)))
            thr = float(np.median(cm[:, dim]))
            node_dim[node] = dim
            node_thr[node] = thr
            lhi = hi.copy(); lhi[dim] = min(hi[dim], thr)
            rlo = lo.copy(); rlo[dim] = max(lo[dim], thr)
            lcand = cand & (box_lo[:, dim] <= lhi[dim])
            rcand = cand & (box_hi[:, dim] >= rlo[dim])
            build(2 * node, lo, lhi, level + 1, lcand)
            build(2 * node + 1, rlo, hi, level + 1, rcand)

        INF = np.full(D, np.inf)
        build(1, -INF, INF, 0, np.ones(S * K, bool))
        self.depth = int(depth)
        self._node_dim = jnp.asarray(node_dim)
        self._node_thr = jnp.asarray(node_thr)
        self._leaf_keep = jnp.asarray(leaf_keep.reshape(n_leaves, S, K))
        self._n_nodes = n_nodes
        self.floor = float(floor)
        self._S, self._K, self._D = S, K, D

    def score(self, feats):
        x = feats[:, : self._D]
        # Vectorized descent: heap index doubles per level.
        idx = jnp.ones(x.shape[0], jnp.int32)
        for _ in range(self.depth):
            go = x[jnp.arange(x.shape[0]), self._node_dim[idx]] \
                 > self._node_thr[idx]
            idx = 2 * idx + go.astype(jnp.int32)
        leaf = idx - self._n_nodes
        keep = self._leaf_keep[leaf]                         # [T, S, K]
        ll = self.inner.densities(feats)                        # [T, S, K]
        best = jnp.max(ll, axis=(1, 2), keepdims=True)
        ll = jnp.where(keep, ll, best + self.floor)
        return jax.nn.logsumexp(ll, axis=-1)

    def __call__(self, feats):
        return self.score(feats)

"""Baum-Welch forward-backward: the training hot loop, batched on device.

Capability parity with SphinxTrain bw (reference:
SphinxTrain/src/programs/bw/forward.c:179-640 scaled alpha pass,
backward.c:308 fused beta + posterior accumulation, baum_welch.c:134-290,
accum.c:323-500 accumulators, viterbi.c Viterbi-mode alignment) —
reformulated for an accelerator (SURVEY.md §7 step 8):

- log-space alpha/beta (no per-frame scaling needed; forward.c's
  gauden_scale_densities_fwd machinery disappears);
- the sentence HMM's sparse transitions become a dense [S, S] log matrix
  (sentence HMMs are small — a padded dense logsumexp matmul replaces
  sparse bookkeeping);
- one `lax.scan` forward + one backward per utterance, `vmap`'d over a
  padded utterance batch; accumulators are summed per batch on device and
  reduced across devices with `psum` (replacing bw's accumulator files +
  `norm`'s file summation, SURVEY.md §2.10 P1/P8);
- Viterbi state alignment (forced alignment) shares the same graph with a
  max-instead-of-logsumexp scan.

Works on padded arrays: utterances padded to (Tmax, Smax) with masks; all
shapes static under jit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sentence_hmm import FlatModel, SentHmm

NEG = -1.0e30


@dataclass
class UttBatch:
    """Padded batch of sentence HMMs + features."""
    feats: np.ndarray      # [B, Tmax, D]
    T: np.ndarray          # [B]
    state_sen: np.ndarray  # [B, Smax] (padded with 0)
    smask: np.ndarray      # [B, Smax] bool
    entry_lp: np.ndarray   # [B, Smax] (0 / -inf)
    # transitions as dense coordinates for scatter
    esrc: np.ndarray       # [B, Emax]
    edst: np.ndarray
    etmat: np.ndarray
    eti: np.ndarray
    etj: np.ndarray
    emask: np.ndarray      # [B, Emax]
    fsrc: np.ndarray       # [B, Fmax]
    ftm: np.ndarray
    fti: np.ndarray
    fmask: np.ndarray
    state_phone: np.ndarray  # [B, Smax]
    state_word: np.ndarray   # [B, Smax]


jax.tree_util.register_dataclass(
    UttBatch,
    data_fields=["feats", "T", "state_sen", "smask", "entry_lp", "esrc",
                 "edst", "etmat", "eti", "etj", "emask", "fsrc", "ftm",
                 "fti", "fmask", "state_phone", "state_word"],
    meta_fields=[])


def pack_batch(hmms: Sequence[SentHmm], feats: Sequence[np.ndarray]) -> UttBatch:
    B = len(hmms)
    D = feats[0].shape[1]
    Tmax = max(f.shape[0] for f in feats)
    Smax = max(len(h.state_sen) for h in hmms)
    Emax = max(len(h.esrc) for h in hmms)
    Fmax = max(len(h.fsrc) for h in hmms)

    def pad1(a, L, fill):
        out = np.full((L,), fill, a.dtype if len(a) else np.int32)
        out[: len(a)] = a
        return out

    fe = np.zeros((B, Tmax, D), np.float32)
    T = np.zeros(B, np.int32)
    ss = np.zeros((B, Smax), np.int32)
    sm = np.zeros((B, Smax), bool)
    el = np.full((B, Smax), NEG, np.float32)
    es = np.zeros((B, Emax), np.int32)
    ed = np.zeros((B, Emax), np.int32)
    et = np.zeros((B, Emax), np.int32)
    ei = np.zeros((B, Emax), np.int32)
    ej = np.zeros((B, Emax), np.int32)
    em = np.zeros((B, Emax), bool)
    fs = np.zeros((B, Fmax), np.int32)
    fm = np.zeros((B, Fmax), bool)
    ft = np.zeros((B, Fmax), np.int32)
    fi = np.zeros((B, Fmax), np.int32)
    sp = np.zeros((B, Smax), np.int32)
    sw = np.full((B, Smax), -1, np.int32)
    for b, (h, f) in enumerate(zip(hmms, feats)):
        t, s, e, fn = f.shape[0], len(h.state_sen), len(h.esrc), len(h.fsrc)
        fe[b, :t] = f
        T[b] = t
        ss[b, :s] = h.state_sen
        sm[b, :s] = True
        el[b, :s] = h.entry_lp
        es[b, :e] = h.esrc
        ed[b, :e] = h.edst
        et[b, :e] = h.etmat
        ei[b, :e] = h.eti
        ej[b, :e] = h.etj
        em[b, :e] = True
        fs[b, :fn] = h.fsrc
        ft[b, :fn] = h.ftm
        fi[b, :fn] = h.fti
        fm[b, :fn] = True
        sp[b, :s] = h.state_phone
        sw[b, :s] = h.state_word
    return UttBatch(feats=fe, T=T, state_sen=ss, smask=sm, entry_lp=el,
                    esrc=es, edst=ed, etmat=et, eti=ei, etj=ej, emask=em,
                    fsrc=fs, ftm=ft, fti=fi, fmask=fm,
                    state_phone=sp, state_word=sw)


# ----------------------------------------------------------------------
def gmm_logliks(feats, means, prec, lnw):
    """Per-senone per-component log densities.

    feats [T, D]; means/prec(0.5/var) [n_sen, K, D]; lnw [n_sen, K]
    -> comp [T, n_sen, K], total [T, n_sen] (logsumexp over K).
    """
    lrd = -0.5 * (jnp.log(2.0 * jnp.pi / (2.0 * prec))).sum(-1)   # [n_sen, K]
    # ll = lrd - sum prec (x - m)^2 via the matmul expansion.
    S, K, D = means.shape
    lin = (2.0 * prec * means).reshape(S * K, D)
    quad = prec.reshape(S * K, D)
    const = (lrd - (prec * means * means).sum(-1)).reshape(S * K)
    ll = (const[None]
          + jnp.dot(feats, lin.T, precision=jax.lax.Precision.HIGHEST)
          - jnp.dot(feats * feats, quad.T,
                    precision=jax.lax.Precision.HIGHEST)).reshape(
              feats.shape[0], S, K)
    comp = ll + lnw[None]
    total = jax.nn.logsumexp(comp, axis=-1)
    return comp, total


def state_logliks(feats, state_sen, means, prec, lnw):
    """Per-STATE mixture log densities for one sentence HMM: params are
    gathered per state, so cost and memory scale with the sentence length
    (Smax), not the model size (n_sen) — the production-scale form.

    feats [T, D]; state_sen [S] senone per state ->
    comp [T, S, K] (incl. log mixture weights), ll [T, S] (logsumexp_K).
    """
    m = means[state_sen]                                     # [S, K, D]
    p = prec[state_sen]
    w = lnw[state_sen]
    lrd = -0.5 * jnp.log(2.0 * jnp.pi / (2.0 * p)).sum(-1)   # [S, K]
    const = lrd - (p * m * m).sum(-1) + w
    hp = jax.lax.Precision.HIGHEST
    comp = (const[None]
            + jnp.einsum("td,skd->tsk", feats, 2.0 * p * m, precision=hp)
            - jnp.einsum("td,skd->tsk", feats * feats, p, precision=hp))
    return comp, jax.nn.logsumexp(comp, axis=-1)


def _dense_trans(batch_row, log_tp, Smax):
    """Edge list -> dense [Smax, Smax] log transition matrix (one utt)."""
    esrc, edst, etm, eti, etj, emask = batch_row
    lp = log_tp[etm, eti, etj]
    lp = jnp.where(emask, lp, NEG)
    M = jnp.full((Smax, Smax), NEG, jnp.float32)
    # duplicate (src,dst) pairs don't occur in these graphs; use max to be safe
    M = M.at[esrc, edst].max(lp)
    return M


def phseg_to_frames(phsegs, T: int, phone_id: Dict[str, int]) -> np.ndarray:
    """Rasterize a phone segmentation (decode/align.py PhoneSeg list, the
    -phsegdir artifact) into a per-frame phone-id vector for the
    phseg-constrained forward-backward below.  Frames not covered by any
    segment get -1 (unconstrained)."""
    out = np.full(T, -1, np.int32)
    for seg in phsegs:
        pid = phone_id.get(seg.phone, -1)
        if pid >= 0:
            out[seg.start_frame : seg.end_frame + 1] = pid
    return out


def forward_backward(batch: UttBatch, means, prec, lnw, log_tp,
                     weights=None, phseg=None):
    """One EM pass over a padded utterance batch.

    Returns (total log-likelihood [B], accumulators dict).
    Pure function of (batch, params) — jit/vmap/psum-friendly.

    `weights` [B] optionally scales each utterance's contribution to the
    accumulators (used for lattice-posterior-weighted MMIE denominator
    statistics, SphinxTrain bw -mmie capability).

    `phseg` [B, Tmax] optionally constrains the state space per frame to
    states whose phone matches the given segmentation (the reference's
    -phsegdir gating, bw/forward.c:223-224 can_prune_phseg): a state is
    active at frame t only when phseg[b, t] < 0 (unconstrained) or equals
    the state's `state_phone` id.  Ids must live in the same space the
    sentence HMM was built with (`phseg_to_frames` maps PhoneSeg names).
    """
    B, Tmax, D = batch.feats.shape
    Smax = batch.state_sen.shape[1]
    n_sen, K, _ = means.shape
    n_tmat = log_tp.shape[0]
    nst = log_tp.shape[1]
    if phseg is None:
        phseg = np.full((B, Tmax), -1, np.int32)

    def one_utt(feats, T, state_sen, smask, entry_lp, erow, frow,
                state_phone, phseg_row):
        # ACTIVE-STATE densities: evaluate only the sentence HMM's Smax
        # states (params gathered per state) instead of all n_sen senones
        # — the reference's pattern (bw computes densities per active
        # state with per-(codebook, frame) caching, forward.c:383-405).
        # At production model sizes (5k senones x 32 Gaussians) the
        # all-senone [T, n_sen, K] tensor would be ~GBs per utterance;
        # the per-state [T, Smax, K] form is O(sentence length).
        comp_s, ll = state_logliks(feats, state_sen, means, prec, lnw)
        ll = jnp.where(smask[None], ll, NEG)
        allowed = ((phseg_row[:, None] < 0)
                   | (state_phone[None, :] == phseg_row[:, None]))
        ll = jnp.where(allowed, ll, NEG)
        M = _dense_trans(erow, log_tp, Smax)                 # [S, S]
        tmask = jnp.arange(Tmax) < T

        # Forward.
        a0 = entry_lp + ll[0]
        def fstep(a, x):
            llt, valid = x
            nxt = jax.nn.logsumexp(a[:, None] + M, axis=0) + llt
            nxt = jnp.maximum(nxt, NEG)
            return jnp.where(valid, nxt, a), jnp.where(valid, nxt, a)
        _, alpha_rest = jax.lax.scan(fstep, a0, (ll[1:], tmask[1:]))
        alpha = jnp.concatenate([a0[None], alpha_rest])      # [T, S]

        # Final exit arcs at the true last frame.
        fsrc, ftm, fti, fmask = frow
        a_last = alpha[T - 1]
        fexit = a_last[fsrc] + log_tp[ftm, fti, nst]
        fexit = jnp.where(fmask, fexit, NEG)
        llh = jax.nn.logsumexp(fexit)

        # Backward: beta[T-1, s] = exit contribution.
        bT = jnp.full((Smax,), NEG)
        bT = bT.at[fsrc].max(jnp.where(fmask, log_tp[ftm, fti, nst], NEG))
        def bstep(b, x):
            llt1, valid = x   # ll at t+1
            prev = jax.nn.logsumexp(M + (b + llt1)[None, :], axis=1)
            prev = jnp.maximum(prev, NEG)
            return jnp.where(valid, prev, b), jnp.where(valid, prev, b)
        _, beta_rev = jax.lax.scan(
            bstep, bT, (ll[1:][::-1], tmask[1:][::-1]))
        beta = jnp.concatenate([beta_rev[::-1], bT[None]])   # [T, S]

        # State posteriors.
        gamma = alpha + beta - llh                            # [T, S]
        gamma = jnp.where(tmask[:, None] & smask[None], gamma, NEG)
        g = jnp.exp(jnp.minimum(gamma, 0.0))                  # [T, S]

        # Component posteriors -> senone-indexed accumulation.
        compn = comp_s - ll[..., None]                        # [T, S, K]
        r = g[..., None] * jnp.exp(jnp.maximum(compn, -60.0))
        # Time-reduce with GEMMs (no [T, S, K, D] materialization: the
        # weighted-observation sums are einsums), THEN
        # scatter the small [S, K(, D)] per-state sums to senones.
        hp = jax.lax.Precision.HIGHEST
        rs = r.sum(0)                                         # [S, K]
        ms = jnp.einsum("tsk,td->skd", r, feats, precision=hp)
        vs = jnp.einsum("tsk,td->skd", r, feats * feats, precision=hp)
        seg = jnp.where(smask, state_sen, n_sen)              # pad -> dump row
        mixw_acc = jax.ops.segment_sum(rs, seg, num_segments=n_sen + 1)[:-1]
        mean_acc = jax.ops.segment_sum(ms, seg, num_segments=n_sen + 1)[:-1]
        var_acc = jax.ops.segment_sum(vs, seg, num_segments=n_sen + 1)[:-1]

        # Transition accumulation: xi over edges.
        esrc, edst, etm, eti, etj, emask = erow
        elp = log_tp[etm, eti, etj]
        # xi[t, e] for t in 0..T-2: alpha[t,src] + lp + ll[t+1,dst] + beta[t+1,dst] - llh
        xi = (alpha[:-1, :][:, esrc] + elp[None]
              + ll[1:, :][:, edst] + beta[1:, :][:, edst] - llh)
        xi = jnp.where(tmask[1:][:, None] & emask[None], xi, NEG)
        xe = jnp.exp(jnp.minimum(xi, 0.0)).sum(0)             # [E]
        # exit arcs count once at T-1
        fpost = jnp.exp(jnp.minimum(fexit - llh, 0.0))
        tacc = jnp.zeros((n_tmat, nst, nst + 1))
        tacc = tacc.at[etm, eti, etj].add(jnp.where(emask, xe, 0.0))
        tacc = tacc.at[ftm, fti, nst].add(jnp.where(fmask, fpost, 0.0))
        return llh, mixw_acc, mean_acc, var_acc, tacc

    erows = (batch.esrc, batch.edst, batch.etmat, batch.eti, batch.etj,
             batch.emask)
    frows = (batch.fsrc, batch.ftm, batch.fti, batch.fmask)
    llh, mixw, mean, var, tacc = jax.vmap(one_utt)(
        jnp.asarray(batch.feats), jnp.asarray(batch.T),
        jnp.asarray(batch.state_sen), jnp.asarray(batch.smask),
        jnp.asarray(batch.entry_lp),
        tuple(jnp.asarray(a) for a in erows),
        tuple(jnp.asarray(a) for a in frows),
        jnp.asarray(batch.state_phone), jnp.asarray(phseg))
    if weights is not None:
        w = jnp.asarray(weights, jnp.float32)
        mixw = mixw * w[:, None, None]
        mean = mean * w[:, None, None, None]
        var = var * w[:, None, None, None]
        tacc = tacc * w[:, None, None, None]
    acc = {"mixw": mixw.sum(0), "mean": mean.sum(0), "var": var.sum(0),
           "tmat": tacc.sum(0), "n_frames": jnp.sum(batch.T)}
    return llh, acc


def viterbi_align(batch: UttBatch, means, prec, lnw, log_tp):
    """Forced alignment: best state sequence per utterance (viterbi.c /
    pocketsphinx state_align_search capability).

    Returns (scores [B], states [B, Tmax]) — state index at each frame
    (into the utterance's sentence HMM; -1 on padding).
    """
    B, Tmax, D = batch.feats.shape
    Smax = batch.state_sen.shape[1]
    nst = log_tp.shape[1]

    def one_utt(feats, T, state_sen, smask, entry_lp, erow, frow):
        _, ll = state_logliks(feats, state_sen, means, prec, lnw)
        ll = jnp.where(smask[None], ll, NEG)
        M = _dense_trans(erow, log_tp, Smax)
        tmask = jnp.arange(Tmax) < T
        a0 = entry_lp + ll[0]

        def vstep(a, x):
            llt, valid = x
            cand = a[:, None] + M
            nxt = jnp.max(cand, axis=0) + llt
            bp = jnp.argmax(cand, axis=0)
            nxt = jnp.maximum(nxt, NEG)
            return jnp.where(valid, nxt, a), (jnp.where(valid, nxt, a), bp)
        _, (alphas, bps) = jax.lax.scan(vstep, a0, (ll[1:], tmask[1:]))
        alpha = jnp.concatenate([a0[None], alphas])           # [T, S]
        fsrc, ftm, fti, fmask = frow
        fexit = alpha[T - 1][fsrc] + log_tp[ftm, fti, nst]
        fexit = jnp.where(fmask, fexit, NEG)
        best = jnp.argmax(fexit)
        score = fexit[best]
        last_state = fsrc[best]

        # Backtrace through bps [T-1, S].
        def btstep(s, x):
            bp, t = x
            prev = bp[s]
            use = (t + 1) <= (T - 1)   # only trace within the true length
            return jnp.where(use, prev, s), s
        ts = jnp.arange(Tmax - 1)[::-1]
        s_final, states_rev = jax.lax.scan(btstep, last_state, (bps[::-1], ts))
        states = jnp.concatenate([s_final[None], states_rev[::-1]])
        states = jnp.where(tmask, states, -1)
        return score, states

    erows = (batch.esrc, batch.edst, batch.etmat, batch.eti, batch.etj,
             batch.emask)
    frows = (batch.fsrc, batch.ftm, batch.fti, batch.fmask)
    return jax.vmap(one_utt)(
        jnp.asarray(batch.feats), jnp.asarray(batch.T),
        jnp.asarray(batch.state_sen), jnp.asarray(batch.smask),
        jnp.asarray(batch.entry_lp),
        tuple(jnp.asarray(a) for a in erows),
        tuple(jnp.asarray(a) for a in frows))

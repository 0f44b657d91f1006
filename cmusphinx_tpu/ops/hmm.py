"""Vectorized per-HMM Viterbi step.

Replaces hmm_vit_eval (reference: pocketsphinx/src/libpocketsphinx/hmm.c:
789-825 dispatch, :330-470 unrolled 3/5-state kernels) with one batched
update over N HMMs at once — the decoder evaluates *all* active channels as
a dense [N, S] tensor program per frame.

Semantics (matching the reference exactly):
- emission first: s[j] = alpha[j] + sen[j]
- exit (into the nonemitting final state):
    exit = max(s[S-1] + tp[S-1, S], s[S-2] + tp[S-2, S])
- transitions (Bakis, at most one skip):
    alpha'[j] = max(s[j] + tp[j,j], s[j-1] + tp[j-1,j], s[j-2] + tp[j-2,j])
- integer "history" payloads (backpointer ids, multiplex ssids) ride along
  with the argmax.

Scores are float32 natural-log; NEG_INF plays WORST_SCORE (hmm.h:74).
The kernel is pure and shape-polymorphic over (N, S); under jit it unrolls
to a handful of fused elementwise ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Plain numpy scalar: a module-level jnp constant would initialize the JAX
# backend at import time, before the program can choose a platform.
NEG_INF = np.float32(-1.0e30)


def hmm_init_state(n: int, n_state: int, n_payload: int = 1):
    """Fresh (inactive) HMM state: scores at NEG_INF, payloads -1."""
    alpha = jnp.full((n, n_state), NEG_INF, jnp.float32)
    payloads = tuple(jnp.full((n, n_state), -1, jnp.int32) for _ in range(n_payload))
    return alpha, payloads


def _band(tp, off: int):
    """tp [N, S, S+1] -> banded vector tp[:, j, j+off] for valid j."""
    S = tp.shape[1]
    j = jnp.arange(S - off) if off > 0 else jnp.arange(S)
    return tp[:, j, j + off]  # [N, S-off]


def hmm_step(alpha, payloads, sen, log_tp,
             ) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, ...], jnp.ndarray, Tuple[jnp.ndarray, ...]]:
    """One Viterbi frame update for N HMMs.

    alpha:    [N, S] current state scores (emission NOT yet applied)
    payloads: tuple of [N, S] int32 arrays propagated with the argmax
    sen:      [N, S] senone scores for each state (natural log)
    log_tp:   [N, S, S+1] log transition probabilities

    Returns (new_alpha, new_payloads, exit_score [N], exit_payloads tuple of [N]).
    """
    N, S = alpha.shape
    s = alpha + sen  # emission first (hmm.c order)

    # Exit into the nonemitting final state from the last two states.
    e_last = s[:, S - 1] + log_tp[:, S - 1, S]
    if S >= 2:
        e_prev = s[:, S - 2] + log_tp[:, S - 2, S]
        take_last = e_last >= e_prev
        exit_score = jnp.where(take_last, e_last, e_prev)
        exit_payloads = tuple(
            jnp.where(take_last, p[:, S - 1], p[:, S - 2]) for p in payloads)
    else:
        exit_score = e_last
        exit_payloads = tuple(p[:, S - 1] for p in payloads)

    # Candidate scores into each state j.  Selection is a max/where chain,
    # NOT argmax + take_along_axis: compares/selects fuse into one
    # elementwise pass where a gather would not.  Tie order matches the
    # reference (self loop, then j-1, then j-2 — hmm.c evaluates in that
    # order and keeps the first max).
    d0 = _band(log_tp, 0)                      # [N, S] self loops
    c_self = s + d0
    if S == 1:
        new_alpha = jnp.maximum(c_self, NEG_INF)
        return (new_alpha, payloads, jnp.maximum(exit_score, NEG_INF),
                exit_payloads)

    d1 = _band(log_tp, 1)                      # [N, S-1] j -> j+1
    c_prev = jnp.concatenate(
        [jnp.full((N, 1), NEG_INF), s[:, :-1] + d1], axis=1)
    p_prev = [jnp.concatenate([p[:, :1], p[:, :-1]], axis=1)
              for p in payloads]
    if S >= 3:
        d2 = _band(log_tp, 2)                  # [N, S-2] j -> j+2
        c_skip = jnp.concatenate(
            [jnp.full((N, 2), NEG_INF), s[:, :-2] + d2], axis=1)
        p_skip = [jnp.concatenate([p[:, :2], p[:, :-2]], axis=1)
                  for p in payloads]
        m12 = jnp.maximum(c_prev, c_skip)
        new_alpha = jnp.maximum(c_self, m12)
        sel_self = c_self >= m12
        sel_prev = c_prev >= c_skip
        new_payloads = tuple(
            jnp.where(sel_self, p,
                      jnp.where(sel_prev, pp, ps))
            for p, pp, ps in zip(payloads, p_prev, p_skip))
    else:
        new_alpha = jnp.maximum(c_self, c_prev)
        sel_self = c_self >= c_prev
        new_payloads = tuple(
            jnp.where(sel_self, p, pp) for p, pp in zip(payloads, p_prev))
    new_alpha = jnp.maximum(new_alpha, NEG_INF)

    exit_score = jnp.maximum(exit_score, NEG_INF)
    return new_alpha, new_payloads, exit_score, exit_payloads


def hmm_bands(log_tp):
    """Precompute FLAT state-major transition bands from [N, S, S+1]
    matrices: (d0 [S*N] self loops, d1 [(S-1)*N], d2 [(S-2)*N] skips,
    e_last [N], e_prev [N] exits).  Host-side, once per graph."""
    N, S = log_tp.shape[0], log_tp.shape[1]
    d0 = np.concatenate([log_tp[:, j, j] for j in range(S)])
    d1 = (np.concatenate([log_tp[:, j, j + 1] for j in range(S - 1)])
          if S >= 2 else np.zeros((0,), log_tp.dtype))
    d2 = (np.concatenate([log_tp[:, j, j + 2] for j in range(S - 2)])
          if S >= 3 else np.zeros((0,), log_tp.dtype))
    e_last = log_tp[:, S - 1, S]
    e_prev = log_tp[:, S - 2, S] if S >= 2 else np.full(N, NEG_INF)
    return d0, d1, d2, e_last, e_prev


def hmm_step_sm(alpha, payloads, sen, bands):
    """FLAT state-major variant of hmm_step: alpha/payloads/sen are 1-D
    [S*N] arrays (state-major: element s*N + c).  1-D arrays keep the big
    channel axis minor (contiguous) — with 2-D [N, S] or [S, N] shapes
    XLA's layout assignment may put the S=3..5 axis minor, which cost most
    of the large-vocabulary scan on the accelerator this decoder was first
    built for.  Semantics identical to hmm_step.
    `bands` from hmm_bands(); N is inferred from e_last."""
    d0, d1, d2, e_last, e_prev = bands
    N = e_last.shape[0]
    S = alpha.shape[0] // N
    s = alpha + sen

    e_l = s[(S - 1) * N:] + e_last
    if S >= 2:
        e_p = s[(S - 2) * N: (S - 1) * N] + e_prev
        take_last = e_l >= e_p
        exit_score = jnp.where(take_last, e_l, e_p)
        exit_payloads = tuple(
            jnp.where(take_last, p[(S - 1) * N:],
                      p[(S - 2) * N: (S - 1) * N]) for p in payloads)
    else:
        exit_score = e_l
        exit_payloads = tuple(p[(S - 1) * N:] for p in payloads)

    c_self = s + d0
    if S == 1:
        return (jnp.maximum(c_self, NEG_INF), payloads,
                jnp.maximum(exit_score, NEG_INF), exit_payloads)

    pad = jnp.full((N,), NEG_INF)
    c_prev = jnp.concatenate([pad, s[: -N] + d1])
    p_prev = [jnp.concatenate([p[:N], p[: -N]]) for p in payloads]
    if S >= 3:
        pad2 = jnp.full((2 * N,), NEG_INF)
        c_skip = jnp.concatenate([pad2, s[: -2 * N] + d2])
        p_skip = [jnp.concatenate([p[: 2 * N], p[: -2 * N]])
                  for p in payloads]
        m12 = jnp.maximum(c_prev, c_skip)
        new_alpha = jnp.maximum(c_self, m12)
        sel_self = c_self >= m12
        sel_prev = c_prev >= c_skip
        new_payloads = tuple(
            jnp.where(sel_self, p, jnp.where(sel_prev, pp, ps))
            for p, pp, ps in zip(payloads, p_prev, p_skip))
    else:
        new_alpha = jnp.maximum(c_self, c_prev)
        sel_self = c_self >= c_prev
        new_payloads = tuple(
            jnp.where(sel_self, p, pp) for p, pp in zip(payloads, p_prev))
    return (jnp.maximum(new_alpha, NEG_INF), new_payloads,
            jnp.maximum(exit_score, NEG_INF), exit_payloads)


def hmm_step_bm(alpha, payloads, sen, bands):
    """Batch-major variant: alpha/payloads/sen are [B, S, C] — the batch
    rides the major axis and the big channel axis is minor, so every
    elementwise op runs over long contiguous rows for any batch size.
    `bands` are the flat state-major bands from hmm_bands(),
    viewed [S, C] / [C]."""
    B, S, C = alpha.shape
    d0f, d1f, d2f, e_last, e_prev = bands
    d0 = d0f.reshape(S, C)[None]
    s = alpha + sen

    e_l = s[:, S - 1] + e_last[None]
    if S >= 2:
        e_p = s[:, S - 2] + e_prev[None]
        take_last = e_l >= e_p
        exit_score = jnp.where(take_last, e_l, e_p)        # [B, C]
        exit_payloads = tuple(
            jnp.where(take_last, p[:, S - 1], p[:, S - 2]) for p in payloads)
    else:
        exit_score = e_l
        exit_payloads = tuple(p[:, S - 1] for p in payloads)

    c_self = s + d0
    if S == 1:
        return (jnp.maximum(c_self, NEG_INF), payloads,
                jnp.maximum(exit_score, NEG_INF), exit_payloads)

    d1 = d1f.reshape(S - 1, C)[None]
    pad = jnp.full((B, 1, C), NEG_INF)
    c_prev = jnp.concatenate([pad, s[:, :-1] + d1], axis=1)
    p_prev = [jnp.concatenate([p[:, :1], p[:, :-1]], axis=1)
              for p in payloads]
    if S >= 3:
        d2 = d2f.reshape(S - 2, C)[None]
        pad2 = jnp.full((B, 2, C), NEG_INF)
        c_skip = jnp.concatenate([pad2, s[:, :-2] + d2], axis=1)
        p_skip = [jnp.concatenate([p[:, :2], p[:, :-2]], axis=1)
                  for p in payloads]
        m12 = jnp.maximum(c_prev, c_skip)
        new_alpha = jnp.maximum(c_self, m12)
        sel_self = c_self >= m12
        sel_prev = c_prev >= c_skip
        new_payloads = tuple(
            jnp.where(sel_self, p, jnp.where(sel_prev, pp, ps))
            for p, pp, ps in zip(payloads, p_prev, p_skip))
    else:
        new_alpha = jnp.maximum(c_self, c_prev)
        sel_self = c_self >= c_prev
        new_payloads = tuple(
            jnp.where(sel_self, p, pp) for p, pp in zip(payloads, p_prev))
    return (jnp.maximum(new_alpha, NEG_INF), new_payloads,
            jnp.maximum(exit_score, NEG_INF), exit_payloads)


def hmm_enter_bm(alpha, payloads, entry_score, entry_payloads):
    """Batch-major hmm_enter: entry_score/payloads [B, C] into state 0."""
    better = entry_score > alpha[:, 0]
    new_alpha = jnp.concatenate(
        [jnp.where(better, entry_score, alpha[:, 0])[:, None],
         alpha[:, 1:]], axis=1)
    new_payloads = tuple(
        jnp.concatenate([jnp.where(better, ep, p[:, 0])[:, None],
                         p[:, 1:]], axis=1)
        for p, ep in zip(payloads, entry_payloads))
    return new_alpha, new_payloads


def hmm_enter_sm(alpha, payloads, entry_score, entry_payloads):
    """FLAT state-major hmm_enter: inject entry tokens into the state-0
    block (the first N elements); concat instead of scatter."""
    N = entry_score.shape[0]
    better = entry_score > alpha[:N]
    new_alpha = jnp.concatenate(
        [jnp.where(better, entry_score, alpha[:N]), alpha[N:]])
    new_payloads = tuple(
        jnp.concatenate([jnp.where(better, ep, p[:N]), p[N:]])
        for p, ep in zip(payloads, entry_payloads))
    return new_alpha, new_payloads


def hmm_enter(alpha, payloads, entry_score, entry_payloads, active=None):
    """Inject external entry tokens into state 0 (hmm_enter semantics):
    replace alpha[:, 0] where the entry score is better.

    entry_score: [N]; entry_payloads: tuple of [N].
    """
    better = entry_score > alpha[:, 0]
    if active is not None:
        better = better & active
    new_alpha = alpha.at[:, 0].set(jnp.where(better, entry_score, alpha[:, 0]))
    new_payloads = tuple(
        p.at[:, 0].set(jnp.where(better, ep, p[:, 0]))
        for p, ep in zip(payloads, entry_payloads))
    return new_alpha, new_payloads

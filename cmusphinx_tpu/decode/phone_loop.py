"""Phone-loop search: all-CI-phone Viterbi loop used as a lookahead
heuristic and as a lightweight phoneme recognizer.

Capability parity with pocketsphinx phone_loop_search (reference:
pocketsphinx/src/libpocketsphinx/phone_loop_search.c; consulted by the
fwdtree/fsg searches via phone_loop_search_score with a -pl_window frame
window and -pl_beam/-pl_pbeam penalties, ngram_search_fwdtree.c:1390-1420).

Batched formulation: all CI-phone HMMs run as ONE batched [n_ci, S]
`hmm_step` inside a `lax.scan`; the loop re-entry (every phone can follow
every phone with penalty pip) is a per-frame max over exit scores — no
active lists.  The whole utterance's heuristic is one device program:

- `phone_scores(feats)` -> [T, n_ci] best in-phone state score per frame;
- `heuristic(feats, window)` -> [T] windowed-max lookahead score used to
  predict beam viability `pl_window` frames ahead;
- `lookahead_mask(feats, window, pl_beam)` -> [T, n_ci] bool: phones whose
  windowed score is within pl_beam of the frame best — the dense analog of
  the reference's phone-loop pruning signal.  The dense exact decoders in
  this framework do not NEED the heuristic for correctness (they evaluate
  all channels); the mask exists for capability parity and for pruned
  configurations where it gates senone evaluation.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.mdef import Mdef
from ..models.tmat import TransitionMatrices
from ..ops.hmm import NEG_INF, hmm_enter, hmm_step

PHONE_LOOP_ARGS_DOC = """-pl_window / -pl_beam / -pl_pip analogs; see
pocketsphinx cmdln_macro.h phone-loop flags."""


class PhoneLoopSearch:
    """Batched CI-phone loop over a senone scorer."""

    def __init__(self, mdef: Mdef, tmat: TransitionMatrices, scorer,
                 pip: float = 1.0, pl_weight: float = 3.0):
        self.mdef = mdef
        self.scorer = scorer
        self.n_ci = mdef.n_ciphone
        self.log_pip = math.log(pip) if pip > 0 else 0.0
        self.pl_weight = pl_weight
        # Per-CI-phone senone ids and transition matrices.
        ssid = mdef.phone_ssid[: self.n_ci]
        sen = mdef.sseq[ssid].astype(np.int32)                  # [n_ci, S]
        sen = np.where(sen == np.iinfo(np.uint16).max, 0, sen)
        self._sen_idx = jnp.asarray(sen)
        tm = mdef.phone_tmat[: self.n_ci]
        self._tp = jnp.asarray(tmat.log_tp[tm])                 # [n_ci, S, S+1]
        self._n_state = sen.shape[1]
        self._run = jax.jit(self._run_impl)

    def _run_impl(self, scores):
        """scores [T, n_sen] -> (best [T], phone [T, n_ci])."""
        n, S = self.n_ci, self._n_state
        alpha = jnp.full((n, S), NEG_INF)
        # All phones enterable at t=0.
        alpha = alpha.at[:, 0].set(0.0)
        lp = jnp.float32(self.log_pip)

        def step(alpha, sen_t):
            sen_c = sen_t[self._sen_idx]                         # [n_ci, S]
            alpha, _, ex, _ = hmm_step(alpha, (), sen_c, self._tp)
            # Loop transition: best exit re-enters every phone.
            best_exit = jnp.max(ex) + lp
            alpha, _ = hmm_enter(alpha, (),
                                 jnp.full((n,), best_exit), ())
            phone_best = jnp.max(alpha, axis=1)                  # [n_ci]
            # Renormalize to stop drift on long utterances
            # (ngram_search_fwdtree.c:1467 renormalization capability).
            m = jnp.max(phone_best)
            alpha = alpha - m
            return alpha, (m, phone_best - m)

        _, (best, phones) = jax.lax.scan(step, alpha, scores)
        # best[t] is the per-frame incremental max; cumulative path score
        # differences don't matter for the heuristic (window-relative).
        return best, phones

    # ------------------------------------------------------------------
    def phone_scores(self, feats) -> np.ndarray:
        """[T, D] feats -> frame-relative per-phone scores [T, n_ci]."""
        scores = self.scorer.score(jnp.asarray(feats))
        _, phones = self._run(scores)
        return np.asarray(phones)

    def heuristic(self, feats, window: int = 5) -> np.ndarray:
        """Per-frame lookahead score: max in-loop score over the next
        `window` frames (phone_loop_search_score capability), scaled by
        pl_weight."""
        scores = self.scorer.score(jnp.asarray(feats))
        best, _ = self._run(scores)
        b = np.asarray(best)
        T = b.shape[0]
        out = np.empty(T, np.float32)
        acc = 0.0
        # windowed sum of incremental bests approximates the best loop path
        # score over [t, t+window)
        csum = np.concatenate([[0.0], np.cumsum(b)])
        for t in range(T):
            e = min(T, t + window)
            out[t] = csum[e] - csum[t]
        return self.pl_weight * out

    def lookahead_mask(self, feats, window: int = 5,
                       pl_beam: float = 1e-10) -> np.ndarray:
        """[T, n_ci] bool: phone ci is plausible around frame t (its
        windowed-max score within pl_beam of the frame best)."""
        ph = self.phone_scores(feats)                            # [T, n_ci]
        T = ph.shape[0]
        wmax = np.copy(ph)
        for dt in range(1, window):
            wmax[: T - dt] = np.maximum(wmax[: T - dt], ph[dt:])
        thresh = wmax.max(axis=1, keepdims=True) + math.log(pl_beam)
        return wmax >= thresh

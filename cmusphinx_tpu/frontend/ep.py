"""GMM frame classifier + state-machine endpointer.

Capability parity with sphinx3's libep (reference:
sphinx3/src/libs3decoder/libep/{classify.c,s3_endpointer.c:51-80} — a
GMM-based frame classifier into silence/owner-speech/secondary-speech/noise
feeding a begin/end state machine; `main_ep` tool).  Complements the
energy-based VAD in frontend.vad (cont_ad capability).

Batched: classification of ALL frames is one batched Gaussian-mixture
log-likelihood evaluation (same matmul+LSE formulation as ops.gmm) — the
per-frame scalar loop of classify.c becomes a single [T, D] @ [D, C*K]
program.  The classifier can be fit from labeled frames with a few EM
steps (jit'd), or constructed from an existing model's SIL/speech senones.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

CLASS_SIL, CLASS_SPEECH, CLASS_NOISE = 0, 1, 2


class FrameClassifier:
    """Diagonal-GMM per-class frame classifier (classify.c capability)."""

    def __init__(self, means: np.ndarray, var: np.ndarray,
                 lnw: np.ndarray, priors: Optional[np.ndarray] = None):
        """means/var [C, K, D]; lnw [C, K]; priors [C]."""
        C, K, D = means.shape
        self.n_class, self.n_comp, self.dim = C, K, D
        prec = 0.5 / np.maximum(var, 1e-6)
        lrd = (-0.5 * np.log(2.0 * np.pi * np.maximum(var, 1e-6))).sum(-1)
        const = lrd + lnw - (prec * means * means).sum(-1)       # [C, K]
        self._lin = jnp.asarray((2.0 * prec * means).reshape(C * K, D).T,
                                jnp.float32)
        self._quad = jnp.asarray(prec.reshape(C * K, D).T, jnp.float32)
        self._const = jnp.asarray(const.reshape(C * K), jnp.float32)
        self._logprior = jnp.asarray(
            np.log(priors if priors is not None else np.full(C, 1.0 / C)),
            jnp.float32)
        self.means, self.var, self.lnw = means, var, lnw
        self._ll = jax.jit(self._ll_impl)

    def _ll_impl(self, x):
        ll = (self._const[None]
              + jnp.dot(x, self._lin, precision=jax.lax.Precision.HIGHEST)
              - jnp.dot(x * x, self._quad,
                        precision=jax.lax.Precision.HIGHEST))
        ll = ll.reshape(x.shape[0], self.n_class, self.n_comp)
        return jax.nn.logsumexp(ll, axis=-1) + self._logprior[None]

    def log_likelihoods(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T, C] class log posteriors (unnormalized)."""
        return np.asarray(self._ll(jnp.asarray(feats, jnp.float32)))

    def classify(self, feats: np.ndarray, voting_window: int = 5
                 ) -> np.ndarray:
        """[T, D] -> [T] class ids, with majority smoothing over a window
        (classify.c's voting capability)."""
        ll = self.log_likelihoods(feats)
        raw = np.argmax(ll, axis=1)
        if voting_window <= 1:
            return raw
        T = raw.shape[0]
        out = np.empty_like(raw)
        h = voting_window // 2
        for t in range(T):
            seg = raw[max(0, t - h) : min(T, t + h + 1)]
            out[t] = np.bincount(seg, minlength=self.n_class).argmax()
        return out

    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, feats: np.ndarray, labels: np.ndarray, n_class: int,
            n_comp: int = 4, n_iter: int = 10, seed: int = 0
            ) -> "FrameClassifier":
        """Per-class GMM fit with EM (all classes trained in one batched
        device program)."""
        rng = np.random.default_rng(seed)
        feats = np.asarray(feats, np.float32)
        D = feats.shape[1]
        means = np.zeros((n_class, n_comp, D), np.float32)
        var = np.ones((n_class, n_comp, D), np.float32)
        lnw = np.full((n_class, n_comp), -np.log(n_comp), np.float32)
        priors = np.zeros(n_class)
        for c in range(n_class):
            xc = feats[labels == c]
            priors[c] = max(len(xc), 1)
            if len(xc) == 0:
                continue
            sel = rng.choice(len(xc), size=n_comp, replace=len(xc) < n_comp)
            means[c] = xc[sel]
            var[c] = xc.var(0, keepdims=True) + 1e-3
        priors /= priors.sum()

        @jax.jit
        def em_step(m, v, w, x, mask):
            # x [N, D], mask [N, C] membership
            prec = 0.5 / jnp.maximum(v, 1e-6)
            lrd = (-0.5 * jnp.log(2 * jnp.pi * jnp.maximum(v, 1e-6))).sum(-1)
            diff = x[:, None, None, :] - m[None]                  # [N,C,K,D]
            ll = lrd[None] + w[None] - (prec[None] * diff * diff).sum(-1)
            r = jax.nn.softmax(ll, axis=-1) * mask[:, :, None]    # [N,C,K]
            n = r.sum(0) + 1e-6                                   # [C,K]
            mu = jnp.einsum("nck,nd->ckd", r, x) / n[..., None]
            x2 = jnp.einsum("nck,nd->ckd", r, x * x) / n[..., None]
            vv = jnp.maximum(x2 - mu * mu, 1e-4)
            ww = jnp.log(n / n.sum(-1, keepdims=True))
            return mu, vv, ww

        mask = np.zeros((len(feats), n_class), np.float32)
        mask[np.arange(len(feats)), labels] = 1.0
        m, v, w = jnp.asarray(means), jnp.asarray(var), jnp.asarray(lnw)
        xm = jnp.asarray(feats)
        km = jnp.asarray(mask)
        for _ in range(n_iter):
            m, v, w = em_step(m, v, w, xm, km)
        return cls(np.asarray(m), np.asarray(v), np.asarray(w), priors)


@dataclass
class Utterance:
    start_frame: int
    end_frame: int  # inclusive


class Endpointer:
    """Begin/end state machine over frame classes (s3_endpointer.c
    capability): an utterance begins after `begin_window` of mostly-speech
    frames and ends after `end_window` of non-speech, padded by
    `pad_before`/`pad_after` frames."""

    def __init__(self, begin_window: int = 8, begin_threshold: int = 5,
                 end_window: int = 40, pad_before: int = 15,
                 pad_after: int = 10):
        self.begin_window = begin_window
        self.begin_threshold = begin_threshold
        self.end_window = end_window
        self.pad_before = pad_before
        self.pad_after = pad_after

    def segment(self, classes: np.ndarray) -> List[Utterance]:
        """[T] frame class ids -> utterance spans."""
        speech = (np.asarray(classes) == CLASS_SPEECH).astype(np.int32)
        T = speech.shape[0]
        utts: List[Utterance] = []
        in_speech = False
        start = 0
        sil_run = 0
        # rolling count of speech frames in the begin window
        csum = np.concatenate([[0], np.cumsum(speech)])
        t = 0
        while t < T:
            if not in_speech:
                e = min(T, t + self.begin_window)
                if csum[e] - csum[t] >= self.begin_threshold and speech[t]:
                    in_speech = True
                    start = max(0, t - self.pad_before)
                    sil_run = 0
                t += 1
            else:
                if speech[t]:
                    sil_run = 0
                else:
                    sil_run += 1
                    if sil_run >= self.end_window:
                        end = min(T - 1, t - sil_run + self.pad_after)
                        utts.append(Utterance(start, end))
                        in_speech = False
                t += 1
        if in_speech:
            utts.append(Utterance(start, T - 1))
        return utts

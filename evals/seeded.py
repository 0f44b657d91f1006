"""Seeded Sphinx-format models and planted utterances at real widths.

Writes model directories through the repository's own writers, so that
everything downstream loads them through the normal readers
(`api.Decoder(hmm=..., lm=..., dict=...)`):

- a semi-continuous acoustic model at hub4wsj_sc_8k width: 1s_c_d_dd
  features split into 3 streams by svspec 0-12/13-25/26-38, 256 densities
  per stream, 5,150 tied senones over 39 CI phones + SIL with a triphone
  mdef, mixture weights as an 8-bit sendump (so `Decoder` picks
  PsParityScorer, as for the shipped models);
- a continuous acoustic model sharing its mdef and transition matrices:
  5,150 senones x 32 Gaussians x 39 dims with `mixture_weights` (so
  `Decoder` picks ContinuousScorer), some variances at the floor and large
  means in the c0 dimensions, the ~1e6-nat cancellation case of -gmmprec;
- an 11-word digit lexicon with a full trigram, and a generated 5,000-word
  lexicon with a trigram of ~10 bigrams and ~10 trigrams per word;
- planted utterances: feature sequences sampled from a model along known
  word sequences, with mixtures sharp enough that the decoder recovers every
  planted transcript, and a seeded waveform for the frontend.

All data comes from one seed.  `Width` sets the model sizes; the tests use a
reduced one.

    python evals/seeded.py OUT_DIR [--seed N]     # write the full-width set
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from cmusphinx_tpu.models.dict import Dictionary  # noqa: E402
from cmusphinx_tpu.models.gauden import read_gauden  # noqa: E402
from cmusphinx_tpu.models.mdef import BAD_SENID, Mdef  # noqa: E402
from cmusphinx_tpu.models.ngram import NgramModel  # noqa: E402
from cmusphinx_tpu.models.sendump import (read_mixture_weights,  # noqa: E402
                                          read_sendump, write_sendump)
from cmusphinx_tpu.train import model_io  # noqa: E402
from cmusphinx_tpu.train.trainer import HmmParams  # noqa: E402

# The CMU phone set (39 phones) plus silence.
PHONES = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N NG "
          "OW OY P R S SH T TH UH UW V W Y Z ZH").split()
SIL = "SIL"
N_STATE = 3
VARFLOOR = 1e-4          # Decoder's -varfloor default
C0_DIMS = (0, 13, 26)    # c0 and its deltas in 1s_c_d_dd
SVSPEC = "0-12/13-25/26-38"

# hub4wsj_sc_8k's front end (its feat.params), with svspec for the
# semi-continuous model.
FEAT_PARAMS = ("-nfilt 20\n-lowerf 1\n-upperf 4000\n-wlen 0.025\n"
               "-transform dct\n-round_filters no\n-remove_dc yes\n"
               "-feat 1s_c_d_dd\n-agc none\n-cmn current\n-varnorm no\n")

DIGITS = {
    "ZERO": "Z IH R OW", "OH": "OW", "ONE": "W AH N", "TWO": "T UW",
    "THREE": "TH R IY", "FOUR": "F AO R", "FIVE": "F AY V",
    "SIX": "S IH K S", "SEVEN": "S EH V AH N", "EIGHT": "EY T",
    "NINE": "N AY N",
}


@dataclass(frozen=True)
class Width:
    n_sen: int = 5150       # tied senones (hub4wsj_sc_8k)
    n_density: int = 256    # semi-continuous densities per stream
    n_gauss: int = 32       # continuous Gaussians per senone
    n_words: int = 5000     # generated lexicon


FULL = Width()
TINY = Width(n_sen=400, n_density=32, n_gauss=4, n_words=200)   # CPU tests


@dataclass
class Seeded:
    """Paths of one written model set."""
    root: str
    sc: str          # semi-continuous model directory
    cont: str        # continuous model directory
    digits_dic: str
    digits_lm: str
    words_dic: str
    words_lm: str

    def lexicon(self, name: str) -> Tuple[str, str]:
        """'digits' or 'words' -> (dict path, LM path)."""
        return ((self.digits_dic, self.digits_lm) if name == "digits"
                else (self.words_dic, self.words_lm))


# ----------------------------------------------------------------------
# Lexicons and LMs.

def _generate_words(rng, n: int) -> Dict[str, List[str]]:
    """n distinct pronunciations of 2-8 phones (mean ~5)."""
    out: Dict[str, List[str]] = {}
    seen = {tuple(p.split()) for p in DIGITS.values()}
    while len(out) < n:
        ln = int(np.clip(rng.poisson(4.0) + 2, 2, 8))
        pron = tuple(PHONES[i] for i in rng.integers(0, len(PHONES), ln))
        if pron in seen:
            continue
        seen.add(pron)
        out[f"W{len(out):04d}"] = list(pron)
    return out


def _trigram_lm(rng, words: Sequence[str], n_succ: int, n_tri: int
                ) -> NgramModel:
    """Backoff trigram with Zipf unigrams, `n_succ` bigram successors per
    history (every word when n_succ >= vocabulary) and `n_tri` trigrams per
    word."""
    V = len(words)
    zipf = 1.0 / np.arange(1, V + 2)
    zipf = zipf / zipf.sum()
    order = rng.permutation(V + 1)              # + </s>
    ug = {1: [(-99.0, ("<s>",), -0.3)]}
    vocab = list(words) + ["</s>"]
    for i, w in enumerate(vocab):
        ug[1].append((math.log10(zipf[order[i]]), (w,),
                      float(rng.uniform(-0.8, -0.2))))
    bgs, succ = [], {}
    for h in ["<s>"] + list(words):
        k = min(n_succ, len(vocab))
        nxt = rng.choice(len(vocab), k, replace=False)
        p = rng.dirichlet(np.ones(k)) * 0.8
        succ[h] = [vocab[j] for j in nxt]
        for j, pj in zip(nxt, p):
            bgs.append((math.log10(pj), (h, vocab[j]),
                        float(rng.uniform(-0.6, -0.2))))
    tgs = []
    hists = [(h, w) for h, ws in succ.items() for w in ws if w != "</s>"]
    for _ in range(n_tri * V):
        h1, h2 = hists[int(rng.integers(len(hists)))]
        w3 = vocab[int(rng.integers(len(vocab)))]
        tgs.append((math.log10(rng.uniform(0.02, 0.3)), (h1, h2, w3), 0.0))
    tgs = list({t[1]: t for t in tgs}.values())
    return NgramModel.from_grams({1: ug[1], 2: bgs, 3: tgs})


def _write_dict(path: str, prons: Dict[str, List[str]]) -> None:
    with open(path, "w") as fh:
        for w, p in prons.items():
            fh.write(f"{w} {' '.join(p)}\n")


# ----------------------------------------------------------------------
# Acoustic models.

def _triphones(lexicons: Sequence[Dict[str, List[str]]]):
    """Every (base, lc, rc, wpos) the lexicons can ask for: word-internal
    contexts, and all left/right contexts at word boundaries."""
    ctx = PHONES + [SIL]
    tri = set()
    for lex in lexicons:
        for pron in lex.values():
            n = len(pron)
            if n == 1:
                tri.update((pron[0], l, r, "s") for l in ctx for r in ctx)
                continue
            tri.update((pron[0], l, pron[1], "b") for l in ctx)
            tri.update((pron[-1], pron[-2], r, "e") for r in ctx)
            tri.update((pron[i], pron[i - 1], pron[i + 1], "i")
                       for i in range(1, n - 1))
    return sorted(tri)


def _mdef(rng, width: Width, lexicons) -> Mdef:
    """Triphone mdef with state tying: each (base, state) owns a pool of
    senones and a triphone state takes the pool entry its (lc, rc) hashes to."""
    ci = sorted(PHONES + [SIL])
    cid = {p: i for i, p in enumerate(ci)}
    n_ci = len(ci)
    n_ci_sen = n_ci * N_STATE
    n_cd = width.n_sen - n_ci_sen
    pools = [(b, j) for b in PHONES for j in range(N_STATE)]
    if n_cd < len(pools):
        raise ValueError(f"n_sen={width.n_sen} leaves fewer CD senones "
                         f"than (phone, state) pools")
    size = np.full(len(pools), n_cd // len(pools))
    size[: n_cd % len(pools)] += 1
    start = n_ci_sen + np.concatenate([[0], np.cumsum(size)[:-1]])
    pool_of = {key: i for i, key in enumerate(pools)}
    tie = rng.integers(0, 1 << 30, (len(pools), n_ci, n_ci))
    tri = _triphones(lexicons)
    m = Mdef()
    m.n_ciphone, m.n_phone = n_ci, n_ci + len(tri)
    m.n_emit_state, m.n_ci_sen, m.n_sen = N_STATE, n_ci_sen, width.n_sen
    m.n_tmat = n_ci
    m.ciname, m.ciphone_id, m.sil = ci, cid, cid[SIL]
    m.ci_filler = np.asarray([p == SIL for p in ci])
    sseq = np.zeros((m.n_phone, N_STATE), np.uint16)
    sseq[:n_ci] = np.arange(n_ci_sen).reshape(n_ci, N_STATE)
    ctx = np.full((m.n_phone, 4), -1, np.int32)
    ctx[:n_ci, 0] = np.arange(n_ci)
    for i, (b, l, r, wp) in enumerate(tri):
        for j in range(N_STATE):
            p = pool_of[(b, j)]
            sseq[n_ci + i, j] = start[p] + tie[p, cid[l], cid[r]] % size[p]
        ctx[n_ci + i] = (cid[b], cid[l], cid[r], "ibesu".index(wp))
    m.sseq, m.phone_ctx = sseq, ctx
    m.n_sseq = m.n_phone
    m.phone_ssid = np.arange(m.n_phone, dtype=np.int32)
    m.phone_tmat = np.where(np.arange(m.n_phone) < n_ci,
                            np.arange(m.n_phone), ctx[:, 0]).astype(np.int32)
    return m


def _tmat(rng, n_tmat: int) -> np.ndarray:
    """Bakis transition matrices [n_tmat, 3, 4] (self, next, skip)."""
    tp = np.zeros((n_tmat, N_STATE, N_STATE + 1), np.float32)
    for i in range(N_STATE):
        stay = rng.uniform(0.5, 0.7, n_tmat)
        skip = rng.uniform(0.02, 0.08, n_tmat) if i < N_STATE - 1 else 0.0
        tp[:, i, i] = stay
        tp[:, i, i + 1] = 1.0 - stay - skip
        if i < N_STATE - 1:
            tp[:, i, i + 2] = skip
    return tp


def _semi_model(rng, width: Width):
    """Codebook [1, 3, K, 13] and ln mixture weights [3, K, S].  Each senone
    has a primary density per stream (a code with pairwise distance >= 2
    over the 3 streams) holding 98% of its weight."""
    K, S, F = width.n_density, width.n_sen, 3
    means = rng.normal(0.0, 3.0, (1, F, K, 13)).astype(np.float32)
    var = rng.uniform(0.2, 0.6, (1, F, K, 13)).astype(np.float32)
    pairs = rng.choice(K * K, S, replace=False)
    a, b = pairs // K, pairs % K
    prim = np.stack([a, b, (a + b) % K])                    # [3, S]
    w = np.empty((F, K, S))
    for f in range(F):
        tail = rng.dirichlet(np.ones(K - 1), S).T * 0.02    # [K-1, S]
        for s in range(S):
            w[f, :, s] = np.insert(tail[:, s], prim[f, s], 0.98)
    return means, var, np.log(w).astype(np.float32)


def _cont_model(rng, width: Width) -> Tuple[np.ndarray, ...]:
    """means/var [S, K, 39], ln weights [S, K]."""
    S, K, D = width.n_sen, width.n_gauss, 39
    scale = np.full(D, 3.0)
    scale[list(C0_DIMS)] = 4.0
    centre = rng.normal(0.0, 1.0, (S, 1, D)) * scale
    means = (centre + rng.normal(0.0, 0.7, (S, K, D))).astype(np.float32)
    var = rng.uniform(0.2, 0.8, (S, K, D)).astype(np.float32)
    floor = rng.random((S, K, D)) < 0.03
    floor[:, :, 0] |= rng.random((S, K)) < 0.3
    var[floor] = VARFLOOR
    lnw = np.log(rng.dirichlet(np.full(K, 2.0), S)).astype(np.float32)
    return means, var, lnw


def write_models(root: str, seed: int = 0, width: Width = FULL) -> Seeded:
    """Write both acoustic models, both lexicons and both LMs under `root`."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    out = Seeded(root=root, sc=os.path.join(root, "sc"),
                 cont=os.path.join(root, "cont"),
                 digits_dic=os.path.join(root, "digits.dic"),
                 digits_lm=os.path.join(root, "digits.lm"),
                 words_dic=os.path.join(root, "words.dic"),
                 words_lm=os.path.join(root, "words.lm"))
    digits = {w: p.split() for w, p in DIGITS.items()}
    words = _generate_words(rng, width.n_words)
    _write_dict(out.digits_dic, digits)
    _write_dict(out.words_dic, words)
    _trigram_lm(rng, list(digits), len(digits) + 1, len(digits) + 1
                ).write_arpa(out.digits_lm)
    _trigram_lm(rng, list(words), 10, 10).write_arpa(out.words_lm)

    mdef = _mdef(rng, width, [digits, words])
    tp = _tmat(rng, mdef.n_tmat)
    sc_means, sc_var, sc_lnw = _semi_model(rng, width)
    cont = HmmParams(*_cont_model(rng, width), tp)
    for d in (out.sc, out.cont):
        os.makedirs(d, exist_ok=True)
        mdef.write_text(os.path.join(d, "mdef"))
        model_io.write_tmat(os.path.join(d, "transition_matrices"), cont)
        with open(os.path.join(d, "noisedict"), "w") as fh:
            fh.write("<s> SIL\n</s> SIL\n<sil> SIL\n")
    with open(os.path.join(out.sc, "feat.params"), "w") as fh:
        fh.write(FEAT_PARAMS + f"-svspec {SVSPEC}\n")
    with open(os.path.join(out.cont, "feat.params"), "w") as fh:
        fh.write(FEAT_PARAMS)
    model_io.write_gauden_streams(os.path.join(out.sc, "means"),
                                  os.path.join(out.sc, "variances"),
                                  sc_means, sc_var)
    write_sendump(os.path.join(out.sc, "sendump"), sc_lnw, n_bits=8)
    model_io.write_gauden(os.path.join(out.cont, "means"),
                          os.path.join(out.cont, "variances"), cont)
    model_io.write_mixture_weights(
        os.path.join(out.cont, "mixture_weights"), cont)
    return out


# ----------------------------------------------------------------------
# Planted utterances.

def senone_path(mdef: Mdef, d: Dictionary, words: Sequence[str]
                ) -> List[np.ndarray]:
    """Senone sequences of every phone of <sil> words <sil>, with the
    cross-word triphones the decoder uses (lc of the first word and rc of
    the last are silence)."""
    sil = mdef.sil
    prons = [[int(p) for p in d.pron[d.wordid(w)]] for w in words]
    seqs = [mdef.sseq[mdef.phone_ssid[sil]]]
    for i, pron in enumerate(prons):
        lc_word = prons[i - 1][-1] if i > 0 else sil
        rc_word = prons[i + 1][0] if i + 1 < len(prons) else sil
        n = len(pron)
        for j, b in enumerate(pron):
            lc = pron[j - 1] if j > 0 else lc_word
            rc = pron[j + 1] if j + 1 < n else rc_word
            wpos = 3 if n == 1 else 1 if j == 0 else 2 if j == n - 1 else 0
            pid = mdef.phone_id(b, lc, rc, wpos)
            seqs.append(mdef.sseq[mdef.phone_ssid[pid]])
    seqs.append(mdef.sseq[mdef.phone_ssid[sil]])
    return [s[s != BAD_SENID].astype(np.int64) for s in seqs]


class Planter:
    """Samples feature sequences from one of the seeded acoustic models
    along word sequences drawn from one lexicon's LM."""

    def __init__(self, seeded: Seeded, model: str, lexicon: str):
        hmm = seeded.sc if model == "sc" else seeded.cont
        dic, lm = seeded.lexicon(lexicon)
        self.mdef = Mdef.read(os.path.join(hmm, "mdef"))
        self.dict = Dictionary.read(dic, self.mdef,
                                    filler_path=os.path.join(hmm, "noisedict"))
        self.lm = NgramModel.read(lm)
        self.g = read_gauden(os.path.join(hmm, "means"),
                             os.path.join(hmm, "variances"),
                             varfloor=VARFLOOR)
        self.model = model
        if model == "sc":
            self.w = np.exp(read_sendump(os.path.join(hmm, "sendump"))
                            .astype(np.float64))       # [F, K, S]
            self.w /= self.w.sum(1, keepdims=True)
        else:
            self.w = np.exp(read_mixture_weights(
                os.path.join(hmm, "mixture_weights"))[0].T.astype(np.float64))
        self.vocab = [w for w in self.lm.words if w not in ("<s>", "</s>")]

    def sentence(self, rng, n_words: int) -> List[str]:
        """A walk over the LM's bigram successors."""
        out, h = [], self.lm.word_id("<s>")
        for _ in range(n_words):
            lo, hi = int(self.lm.bg_ptr[h]), int(self.lm.bg_ptr[h + 1])
            nxt = [self.lm.words[int(x)] for x in self.lm.bg_wid[lo:hi]]
            nxt = [w for w in nxt if w not in ("<s>", "</s>")]
            w = (nxt[int(rng.integers(len(nxt)))] if nxt and
                 rng.random() < 0.8 else
                 self.vocab[int(rng.integers(len(self.vocab)))])
            out.append(w)
            h = self.lm.word_id(w)
        return out

    def features(self, rng, senones: np.ndarray) -> np.ndarray:
        """One frame per entry of `senones`, sampled from its GMM."""
        g, T = self.g, len(senones)
        if self.model == "sc":
            parts = []
            for f in range(g.n_feat):
                p = self.w[f][:, senones].T                 # [T, K]
                k = (p.cumsum(1) < rng.random((T, 1))).sum(1)
                k = np.minimum(k, p.shape[1] - 1)
                ln = g.veclen[f]
                m, v = g.means[0, f, k, :ln], g.var[0, f, k, :ln]
                parts.append(m + np.sqrt(v) * rng.standard_normal(m.shape))
            return np.concatenate(parts, 1).astype(np.float32)
        p = self.w[senones]                                  # [T, K]
        k = np.minimum((p.cumsum(1) < rng.random((T, 1))).sum(1),
                       p.shape[1] - 1)
        m, v = g.means[senones, 0, k], g.var[senones, 0, k]
        return (m + np.sqrt(v) * rng.standard_normal(m.shape)
                ).astype(np.float32)

    def utterance(self, rng, seconds: float) -> Tuple[List[str], np.ndarray]:
        """Words and features of about `seconds` of speech (100 frames/s):
        each HMM state lasts 2-4 frames, silence 21-39 frames at each end."""
        budget = int(seconds * 100) - 60
        words: List[str] = []
        for w in self.sentence(rng, 64):
            budget -= 9 * len(self.dict.pron[self.dict.wordid(w)])
            if words and budget < 0:
                break
            words.append(w)
        seqs = senone_path(self.mdef, self.dict, words)
        sen = []
        for i, seq in enumerate(seqs):
            lo, hi = (7, 14) if i in (0, len(seqs) - 1) else (2, 5)
            for s in seq:
                sen.extend([int(s)] * int(rng.integers(lo, hi)))
        return words, self.features(rng, np.asarray(sen))

    def batch(self, rng, n: int, min_s: float, max_s: float):
        """n utterances of uniform length in [min_s, max_s] seconds."""
        return [self.utterance(rng, float(rng.uniform(min_s, max_s)))
                for _ in range(n)]


def waveform(seed: int, seconds: float, samprate: int = 16000) -> np.ndarray:
    """A seeded voiced-speech-like int16 signal: a gliding harmonic source
    under a moving formant envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * samprate)) / samprate
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / samprate
    formant = 700.0 + 400.0 * np.sin(2 * np.pi * 1.3 * t)
    x = sum(np.exp(-((h * f0 - formant) / 300.0) ** 2) * np.sin(h * phase)
            for h in range(1, 30))
    x = 3000.0 * x / np.abs(x).max() + rng.normal(0.0, 30.0, t.size)
    return np.clip(x, -32768, 32767).astype(np.int16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    s = write_models(args.out, args.seed)
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())

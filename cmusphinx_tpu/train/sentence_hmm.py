"""Sentence HMM construction for training and forced alignment.

Capability parity with SphinxTrain's next_utt_states.c (transcript ->
sentence HMM; reference: SphinxTrain/src/programs/bw/next_utt_states.c,
mk_sseq/state_seq libcommon) and mk_flat / mk_mdef_gen flat-start topology
(SphinxTrain/src/programs/{mk_flat,mk_mdef_gen}).

A sentence HMM is a linear chain of phone HMMs for the transcript's words,
with *optional* silence between words and at the ends (bypass edges), each
phone a Bakis topology taken from its transition matrix.  The graph is
emitted as dense arrays for the device forward-backward kernel:

- state_sen [S]: senone id of each emitting state
- edges (esrc [E], edst [E], tmat [E], ti [E], tj [E]): every transition,
  with its (transition-matrix, row, col) coordinates so edge probabilities
  re-materialize from the current tmat estimates every EM iteration
- entry mask [S], exit state list + their (tmat, row) exit coordinates
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FlatModel:
    """Flat-start CI model inventory (mk_flat capability): per-phone HMMs
    with untied senones, shared topology."""
    phones: List[str]
    n_state: int
    phone_id: Dict[str, int]
    n_sen: int            # n_phone * n_state
    n_tmat: int           # one per phone

    @classmethod
    def create(cls, phones: Sequence[str], n_state: int = 3) -> "FlatModel":
        phones = list(dict.fromkeys(phones))
        return cls(phones=phones, n_state=n_state,
                   phone_id={p: i for i, p in enumerate(phones)},
                   n_sen=len(phones) * n_state, n_tmat=len(phones))

    def senone(self, phone: int, state: int) -> int:
        return phone * self.n_state + state

    def init_tmat(self) -> np.ndarray:
        """Uniform Bakis start (self/next/skip equal mass; mk_flat)."""
        n = self.n_state
        tp = np.zeros((self.n_tmat, n, n + 1), np.float64)
        for i in range(n):
            tp[:, i, i] = 1.0
            tp[:, i, i + 1] = 1.0
            if i + 2 <= n:
                tp[:, i, i + 2] = 1.0
        tp /= tp.sum(-1, keepdims=True)
        return tp


@dataclass
class SentHmm:
    """One utterance's sentence HMM as dense arrays."""
    state_sen: np.ndarray    # [S]
    state_phone: np.ndarray  # [S] phone id of each state (for alignment)
    state_word: np.ndarray   # [S] transcript word index (-1 silence)
    esrc: np.ndarray         # [E]
    edst: np.ndarray
    etmat: np.ndarray        # [E] transition matrix id
    eti: np.ndarray          # [E] row
    etj: np.ndarray          # [E] col (n_state = exit used internally)
    entry: np.ndarray        # [S] bool: valid initial states
    entry_lp: np.ndarray     # [S] log prob of starting there (bypass chains)
    fsrc: np.ndarray         # [F] final states (must take their exit arc)
    ftm: np.ndarray          # [F] exit transition matrix id
    fti: np.ndarray          # [F] exit row
    n_state_hmm: int         # states per phone


def build_sentence_hmm(words: Sequence[str], pron: Dict[str, List[str]],
                       model: FlatModel, sil: str = "SIL",
                       optional_sil: bool = True) -> SentHmm:
    """Transcript -> sentence HMM with optional inter-word silence."""
    n = model.n_state
    state_sen: List[int] = []
    state_phone: List[int] = []
    state_word: List[int] = []
    esrc: List[int] = []
    edst: List[int] = []
    etm: List[int] = []
    eti: List[int] = []
    etj: List[int] = []

    def add_phone(p: str, word_idx: int) -> Tuple[int, int]:
        pid = model.phone_id[p]
        base = len(state_sen)
        for s in range(n):
            state_sen.append(model.senone(pid, s))
            state_phone.append(pid)
            state_word.append(word_idx)
        # Internal transitions (self / next / skip).
        for i in range(n):
            for j in (i, i + 1, i + 2):
                if j < n:
                    esrc.append(base + i)
                    edst.append(base + j)
                    etm.append(pid)
                    eti.append(i)
                    etj.append(j)
        return base, base + n - 1

    # exit coordinates of a phone's states that can leave (last two states).
    def exits(pid: int, base: int) -> List[Tuple[int, int, int]]:
        out = [(base + n - 1, pid, n - 1)]
        if n >= 2:
            out.append((base + n - 2, pid, n - 2))
        return out

    # Sequence of (phone, word index, optional?) — optional silence between
    # words and at both ends gets bypass connectivity.
    phone_seq: List[Tuple[str, int, bool]] = []
    has_sil = optional_sil and sil in model.phone_id
    if has_sil:
        phone_seq.append((sil, -1, True))
    for wi, w in enumerate(words):
        for p in pron[w]:
            phone_seq.append((p, wi, False))
        if has_sil:
            phone_seq.append((sil, -1, True))

    # `sources` = where the next phone can be entered from: exit points
    # (state, tmat, row) and/or the START pseudo-source.  An optional phone
    # leaves its predecessors' sources in place (bypass).
    START = ("START",)
    sources: List = [START]
    entry_list: List[int] = []
    for (p, wi, opt) in phone_seq:
        base, last = add_phone(p, wi)
        pid = model.phone_id[p]
        for src in sources:
            if src is START:
                entry_list.append(base)
            else:
                st, tm, row = src
                esrc.append(st)
                edst.append(base)
                etm.append(tm)
                eti.append(row)
                etj.append(n)  # exit column of the source phone
        new_sources = exits(pid, base)
        sources = (sources + new_sources) if opt else list(new_sources)

    S = len(state_sen)
    entry = np.zeros(S, bool)
    entry_lp = np.full(S, -np.inf, np.float32)
    for st in entry_list:
        entry[st] = True
        entry_lp[st] = 0.0
    finals = [src for src in sources if src is not START]
    return SentHmm(
        state_sen=np.asarray(state_sen, np.int32),
        state_phone=np.asarray(state_phone, np.int32),
        state_word=np.asarray(state_word, np.int32),
        esrc=np.asarray(esrc, np.int32), edst=np.asarray(edst, np.int32),
        etmat=np.asarray(etm, np.int32), eti=np.asarray(eti, np.int32),
        etj=np.asarray(etj, np.int32),
        entry=entry, entry_lp=entry_lp,
        fsrc=np.asarray([f[0] for f in finals], np.int32),
        ftm=np.asarray([f[1] for f in finals], np.int32),
        fti=np.asarray([f[2] for f in finals], np.int32),
        n_state_hmm=n)

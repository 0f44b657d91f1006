"""N-gram language models: ARPA and DMP trigram formats, CSR scoring tables.

Capability parity with sphinxbase lm (reference:
sphinxbase/src/libsphinxbase/lm/ngram_model.c word/weight API,
ngram_model_arpa.c text reader/writer, ngram_model_dmp.c:79-430 binary
"Darpa Trigram LM" reader, lm3g_templates.c:46-260 scoring semantics,
lm3g_model.h:107-121 trigram segment scheme).

Storage is device-friendly CSR (SURVEY.md §7 "Trigram LM on device"): sorted
successor arrays + row pointers, probabilities as float32 natural log:

- ug_prob/ug_bo [V]
- bg_ptr [V+1], bg_wid [NB] (sorted per row), bg_prob [NB], bg_bo [NB]
- tg_ptr [NB+1], tg_wid [NT] (sorted per row), tg_prob [NT]

Scoring (lm3g semantics):
- bg(w2, w3)      = prob2 if (w2,w3) exists else bo1(w2) + ug(w3)
- tg(w1, w2, w3)  = prob3 if exists else bo2(w1,w2) + bg(w2,w3)
  where bo2 = 0 if bigram (w1,w2) itself is absent.

`score_all_*` return dense [V] arrays — the form the dense lextree decoder
consumes (one gather per word-exit history instead of per-word binary
search).  Language weight / word insertion penalty application is the
decoder's job (ngram_model_apply_weights semantics), keeping the tables
pure probabilities.
"""

from __future__ import annotations

import gzip
import math
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

LOG10 = math.log(10.0)
DARPA_HDR = b"Darpa Trigram LM"


def _open_maybe_gz(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class NgramModel:
    """Trigram (or lower order) backoff LM with CSR tables."""

    def __init__(self):
        self.n = 1
        self.words: List[str] = []
        self.wid: Dict[str, int] = {}
        self.ug_prob = np.zeros(0, np.float32)   # natural log
        self.ug_bo = np.zeros(0, np.float32)
        self.bg_ptr = np.zeros(1, np.int64)
        self.bg_wid = np.zeros(0, np.int32)
        self.bg_prob = np.zeros(0, np.float32)
        self.bg_bo = np.zeros(0, np.float32)
        self.tg_ptr = np.zeros(1, np.int64)
        self.tg_wid = np.zeros(0, np.int32)
        self.tg_prob = np.zeros(0, np.float32)

    # ------------------------------------------------------------------
    @property
    def n_words(self) -> int:
        return len(self.words)

    def word_id(self, w: str) -> int:
        """Case-normalizing lookup (ngram_model word hashing folds case)."""
        if w in self.wid:
            return self.wid[w]
        if w.lower() in self.wid:
            return self.wid[w.lower()]
        if w.upper() in self.wid:
            return self.wid[w.upper()]
        return -1

    def counts(self) -> Tuple[int, ...]:
        return tuple(c for c in (len(self.ug_prob), len(self.bg_wid),
                                 len(self.tg_wid))[: self.n])

    # ------------------------------------------------------------------
    # Scalar scoring (host; natural log, unweighted).
    def ug_score(self, w: int) -> float:
        return float(self.ug_prob[w])

    def _find_bg(self, w1: int, w2: int) -> int:
        lo, hi = int(self.bg_ptr[w1]), int(self.bg_ptr[w1 + 1])
        i = np.searchsorted(self.bg_wid[lo:hi], w2)
        if lo + i < hi and self.bg_wid[lo + i] == w2:
            return lo + int(i)
        return -1

    def bg_score(self, w1: int, w2: int) -> float:
        if w1 < 0:
            return self.ug_score(w2)
        b = self._find_bg(w1, w2)
        if b >= 0:
            return float(self.bg_prob[b])
        return float(self.ug_bo[w1]) + self.ug_score(w2)

    def tg_score(self, w1: int, w2: int, w3: int) -> float:
        if self.n < 3 or w1 < 0:
            return self.bg_score(w2, w3)
        b = self._find_bg(w1, w2)
        if b < 0:
            return self.bg_score(w2, w3)
        lo, hi = int(self.tg_ptr[b]), int(self.tg_ptr[b + 1])
        i = np.searchsorted(self.tg_wid[lo:hi], w3)
        if lo + i < hi and self.tg_wid[lo + i] == w3:
            return float(self.tg_prob[lo + i])
        return float(self.bg_bo[b]) + self.bg_score(w2, w3)

    def score(self, w3: int, w2: int = -1, w1: int = -1) -> float:
        """Most-specific available n-gram score (ngram_ng_score order)."""
        if w2 < 0:
            return self.ug_score(w3)
        if w1 < 0 or self.n < 3:
            return self.bg_score(w2, w3)
        return self.tg_score(w1, w2, w3)

    # ------------------------------------------------------------------
    # Dense scoring (decoder hot path): [V] arrays.
    def score_all_bg(self, w2: int) -> np.ndarray:
        """bg(w2, *) for all words."""
        out = self.ug_bo[w2] + self.ug_prob.copy()
        lo, hi = int(self.bg_ptr[w2]), int(self.bg_ptr[w2 + 1])
        out[self.bg_wid[lo:hi]] = self.bg_prob[lo:hi]
        return out

    def score_all_tg(self, w1: int, w2: int) -> np.ndarray:
        """tg(w1, w2, *) for all words."""
        if self.n < 3 or w1 < 0:
            return self.score_all_bg(w2)
        b = self._find_bg(w1, w2)
        if b < 0:
            return self.score_all_bg(w2)
        out = self.bg_bo[b] + self.score_all_bg(w2)
        lo, hi = int(self.tg_ptr[b]), int(self.tg_ptr[b + 1])
        out[self.tg_wid[lo:hi]] = self.tg_prob[lo:hi]
        return out

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> "NgramModel":
        with _open_maybe_gz(path, "rb") as fh:
            head = fh.read(20)
        if DARPA_HDR in head:
            return cls.read_dmp(path)
        return cls.read_arpa(path)

    # --- ARPA ----------------------------------------------------------
    @classmethod
    def read_arpa(cls, path: str) -> "NgramModel":
        grams: Dict[int, List[Tuple]] = {1: [], 2: [], 3: []}
        counts: Dict[int, int] = {}
        order = 0
        with _open_maybe_gz(path, "rb") as fh:
            in_data = False
            for raw in fh:
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                if line.startswith("\\data\\"):
                    in_data = True
                    continue
                mm = re.match(r"^ngram (\d+)\s*=\s*(\d+)", line)
                if mm and in_data:
                    counts[int(mm.group(1))] = int(mm.group(2))
                    continue
                mm = re.match(r"^\\(\d+)-grams:", line)
                if mm:
                    order = int(mm.group(1))
                    continue
                if line.startswith("\\end\\"):
                    break
                if order:
                    parts = line.split()
                    try:
                        prob = float(parts[0])
                    except (ValueError, IndexError):
                        continue
                    ws = parts[1 : 1 + order]
                    bo = float(parts[1 + order]) if len(parts) > 1 + order else 0.0
                    grams[order].append((prob, tuple(ws), bo))
        return cls.from_grams(grams)

    @classmethod
    def from_grams(cls, grams: Dict[int, List[Tuple]]) -> "NgramModel":
        """Build from ARPA-style entries: grams[order] is a list of
        (log10 prob, word tuple, log10 backoff); unigrams define the
        vocabulary."""
        m = cls()
        m.n = max(k for k, v in grams.items() if v) if any(grams.values()) else 1
        # Unigrams define the vocabulary.
        for prob, (w,), bo in grams[1]:
            m.wid.setdefault(w, len(m.words))
            if m.wid[w] == len(m.words):
                m.words.append(w)
        V = len(m.words)
        m.ug_prob = np.full(V, -99.0 * LOG10, np.float32)
        m.ug_bo = np.zeros(V, np.float32)
        for prob, (w,), bo in grams[1]:
            i = m.wid[w]
            m.ug_prob[i] = prob * LOG10
            m.ug_bo[i] = bo * LOG10
        m._build_csr(grams.get(2, []), grams.get(3, []))
        return m

    def _build_csr(self, bgs, tgs) -> None:
        V = len(self.words)
        # Bigrams sorted by (w1, w2).
        brows: List[Tuple[int, int, float, float]] = []
        for prob, ws, bo in bgs:
            w1, w2 = self.wid.get(ws[0], -1), self.wid.get(ws[1], -1)
            if w1 < 0 or w2 < 0:
                continue
            brows.append((w1, w2, prob * LOG10, bo * LOG10))
        brows.sort()
        self.bg_ptr = np.zeros(V + 1, np.int64)
        self.bg_wid = np.asarray([b[1] for b in brows], np.int32)
        self.bg_prob = np.asarray([b[2] for b in brows], np.float32)
        self.bg_bo = np.asarray([b[3] for b in brows], np.float32)
        np.add.at(self.bg_ptr, [b[0] + 1 for b in brows], 1)
        self.bg_ptr = np.cumsum(self.bg_ptr)
        # Index bigrams for trigram attachment.
        bindex = {(b[0], b[1]): i for i, b in enumerate(brows)}
        trows: List[Tuple[int, int, float]] = []
        for prob, ws, bo in tgs:
            w1 = self.wid.get(ws[0], -1)
            w2 = self.wid.get(ws[1], -1)
            w3 = self.wid.get(ws[2], -1)
            if w1 < 0 or w2 < 0 or w3 < 0:
                continue
            b = bindex.get((w1, w2))
            if b is None:
                continue  # ARPA guarantees prefix bigram exists
            trows.append((b, w3, prob * LOG10))
        trows.sort()
        NB = len(brows)
        self.tg_ptr = np.zeros(NB + 1, np.int64)
        self.tg_wid = np.asarray([t[1] for t in trows], np.int32)
        self.tg_prob = np.asarray([t[2] for t in trows], np.float32)
        np.add.at(self.tg_ptr, [t[0] + 1 for t in trows], 1)
        self.tg_ptr = np.cumsum(self.tg_ptr)

    def write_arpa(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("\\data\\\n")
            for i, c in enumerate(self.counts()):
                fh.write(f"ngram {i + 1}={c}\n")
            fh.write("\n\\1-grams:\n")
            for w in range(self.n_words):
                bo = f"\t{self.ug_bo[w] / LOG10:.4f}" if self.n > 1 else ""
                fh.write(f"{self.ug_prob[w] / LOG10:.4f}\t{self.words[w]}{bo}\n")
            if self.n > 1:
                fh.write("\n\\2-grams:\n")
                for w1 in range(self.n_words):
                    for b in range(int(self.bg_ptr[w1]), int(self.bg_ptr[w1 + 1])):
                        w2 = int(self.bg_wid[b])
                        bo = f"\t{self.bg_bo[b] / LOG10:.4f}" if self.n > 2 else ""
                        fh.write(f"{self.bg_prob[b] / LOG10:.4f}\t"
                                 f"{self.words[w1]} {self.words[w2]}{bo}\n")
            if self.n > 2:
                fh.write("\n\\3-grams:\n")
                for w1 in range(self.n_words):
                    for b in range(int(self.bg_ptr[w1]), int(self.bg_ptr[w1 + 1])):
                        w2 = int(self.bg_wid[b])
                        for t in range(int(self.tg_ptr[b]), int(self.tg_ptr[b + 1])):
                            fh.write(f"{self.tg_prob[t] / LOG10:.4f}\t"
                                     f"{self.words[w1]} {self.words[w2]} "
                                     f"{self.words[int(self.tg_wid[t])]}\n")
            fh.write("\n\\end\\\n")

    # --- DMP -----------------------------------------------------------
    @classmethod
    def read_dmp(cls, path: str) -> "NgramModel":
        with _open_maybe_gz(path, "rb") as fh:
            data = fh.read()
        pos = 0

        def rd(fmt):
            nonlocal pos
            vals = struct.unpack_from(order + fmt, data, pos)
            pos += struct.calcsize(fmt)
            return vals if len(vals) > 1 else vals[0]

        order = "<"
        k = struct.unpack_from("<i", data, 0)[0]
        if k != len(DARPA_HDR) + 1:
            order = ">"
            k = struct.unpack_from(">i", data, 0)[0]
            if k != len(DARPA_HDR) + 1:
                raise ValueError(f"{path}: not a DMP file")
        pos = 4
        hdr = data[pos : pos + k]
        pos += k
        if not hdr.startswith(DARPA_HDR):
            raise ValueError(f"{path}: bad DMP header {hdr!r}")
        k = rd("i")
        pos += k  # stored filename
        vn = rd("i")
        if vn <= 0:
            rd("i")  # timestamp
            while True:
                k = rd("i")
                if k == 0:
                    break
                pos += k  # format description lines
            n_unigram = rd("i")
        else:
            n_unigram = vn
        n_bigram = rd("i")
        n_trigram = rd("i")

        m = cls()
        m.n = 3 if n_trigram > 0 else (2 if n_bigram > 0 else 1)

        # Unigrams: (n+1) x {int32 mapid, float32 prob, float32 bo, int32 bigrams}
        ug = np.frombuffer(data, np.dtype([("mapid", order + "i4"),
                                           ("prob", order + "f4"),
                                           ("bo", order + "f4"),
                                           ("bigrams", order + "i4")]),
                           n_unigram + 1, pos)
        pos += 16 * (n_unigram + 1)
        m.ug_prob = (ug["prob"][:n_unigram] * LOG10).astype(np.float32)
        m.ug_bo = (ug["bo"][:n_unigram] * LOG10).astype(np.float32)
        m.bg_ptr = ug["bigrams"].astype(np.int64)  # [V+1]

        # Bigrams: (n+1) x {u16 wid, u16 prob2, u16 bo2, u16 trigrams}
        bg = np.frombuffer(data, np.dtype([("wid", order + "u2"),
                                           ("prob2", order + "u2"),
                                           ("bo2", order + "u2"),
                                           ("tg", order + "u2")]),
                           n_bigram + 1 if n_bigram else 0, pos)
        pos += 8 * (n_bigram + 1 if n_bigram else 0)
        # Trigrams: n x {u16 wid, u16 prob3}
        tg = np.frombuffer(data, np.dtype([("wid", order + "u2"),
                                           ("prob3", order + "u2")]),
                           n_trigram, pos)
        pos += 4 * n_trigram

        n_prob2 = rd("i")
        prob2 = np.frombuffer(data, order + "f4", n_prob2, pos) * LOG10
        pos += 4 * n_prob2
        if m.n > 2:
            n_bo2 = rd("i")
            bo_wt2 = np.frombuffer(data, order + "f4", n_bo2, pos) * LOG10
            pos += 4 * n_bo2
            n_prob3 = rd("i")
            prob3 = np.frombuffer(data, order + "f4", n_prob3, pos) * LOG10
            pos += 4 * n_prob3
        if n_trigram > 0:
            k = rd("i")
            tseg_base = np.frombuffer(data, order + "i4", k, pos).astype(np.int64)
            pos += 4 * k
        # Word strings.
        k = rd("i")
        strs = data[pos : pos + k].split(b"\0")
        m.words = [s.decode("utf-8", errors="replace") for s in strs[:n_unigram]]
        m.wid = {w: i for i, w in enumerate(m.words)}

        if n_bigram:
            m.bg_wid = bg["wid"][:n_bigram].astype(np.int32)
            m.bg_prob = prob2[bg["prob2"][:n_bigram]].astype(np.float32)
            if m.n > 2:
                m.bg_bo = bo_wt2[bg["bo2"][:n_bigram]].astype(np.float32)
            else:
                m.bg_bo = np.zeros(n_bigram, np.float32)
        if n_trigram:
            m.tg_wid = tg["wid"].astype(np.int32)
            m.tg_prob = prob3[tg["prob3"]].astype(np.float32)
            # Trigram pointers via the segment scheme (lm3g_model.h:114-121):
            # first trigram of bigram b = tseg_base[b >> 9] + bg[b].tg.
            bidx = np.arange(n_bigram + 1)
            m.tg_ptr = (tseg_base[bidx >> 9] + bg["tg"].astype(np.int64))
        else:
            m.tg_ptr = np.zeros((n_bigram + 1) if n_bigram else 1, np.int64)
        return m

    def write_dmp(self, path: str) -> None:
        """Write the binary DMP format (lm3g2dmp / sphinx_lm_convert parity)."""
        V, NB, NT = self.n_words, len(self.bg_wid), len(self.tg_wid)
        if V >= 65535 or self.n > 3:
            raise ValueError("DMP supports trigram LMs with < 65535 words")

        def quantize(vals):
            uniq, inv = np.unique(np.asarray(vals, np.float32), return_inverse=True)
            if len(uniq) > 65535:
                raise ValueError("too many distinct probabilities for DMP")
            return uniq, inv.astype(np.uint16)

        p2_tab, p2_idx = quantize(self.bg_prob / LOG10)
        b2_tab, b2_idx = quantize(self.bg_bo / LOG10)
        p3_tab, p3_idx = quantize(self.tg_prob / LOG10)

        with open(path, "wb") as fh:
            hdr = DARPA_HDR + b"\0"
            fh.write(struct.pack("<i", len(hdr)))
            fh.write(hdr)
            name = b"lm\0"
            fh.write(struct.pack("<i", len(name)))
            fh.write(name)
            fh.write(struct.pack("<i", -1))      # version
            fh.write(struct.pack("<i", 0))       # timestamp
            fh.write(struct.pack("<i", 0))       # no format description
            fh.write(struct.pack("<i", V))
            fh.write(struct.pack("<i", NB))
            fh.write(struct.pack("<i", NT))
            # Unigrams (+trailer).
            for w in range(V + 1):
                if w < V:
                    fh.write(struct.pack("<iffi", w, self.ug_prob[w] / LOG10,
                                         self.ug_bo[w] / LOG10, int(self.bg_ptr[w])))
                else:
                    fh.write(struct.pack("<iffi", w, -99.0, 0.0, NB))
            # Bigrams (+trailer) with trigram segment scheme.
            tseg_n = ((NB + 1) >> 9) + 1
            tseg = np.zeros(tseg_n, np.int64)
            rel = np.zeros(NB + 1, np.int64)
            for b in range(NB + 1):
                seg = b >> 9
                if b & 511 == 0:
                    tseg[seg] = self.tg_ptr[b] if b <= NB else NT
                rel[b] = self.tg_ptr[b] - tseg[seg]
                if rel[b] > 65535:
                    raise ValueError("trigram segment overflow")
            for b in range(NB + 1):
                if b < NB:
                    fh.write(struct.pack("<HHHH", int(self.bg_wid[b]),
                                         int(p2_idx[b]), int(b2_idx[b]), int(rel[b])))
                else:
                    fh.write(struct.pack("<HHHH", 0, 0, 0, int(rel[b])))
            for t in range(NT):
                fh.write(struct.pack("<HH", int(self.tg_wid[t]), int(p3_idx[t])))
            fh.write(struct.pack("<i", len(p2_tab)))
            fh.write(p2_tab.astype("<f4").tobytes())
            if self.n > 2:
                fh.write(struct.pack("<i", len(b2_tab)))
                fh.write(b2_tab.astype("<f4").tobytes())
                fh.write(struct.pack("<i", len(p3_tab)))
                fh.write(p3_tab.astype("<f4").tobytes())
            if NT:
                fh.write(struct.pack("<i", tseg_n))
                fh.write(tseg.astype("<i4").tobytes())
            wstr = b"".join(w.encode() + b"\0" for w in self.words)
            fh.write(struct.pack("<i", len(wstr)))
            fh.write(wstr)

    # ------------------------------------------------------------------
    def perplexity(self, sentences: List[List[str]],
                   use_unk: bool = False) -> Tuple[float, int, int]:
        """Corpus perplexity (evallm / sphinx_lm_eval capability).

        Returns (ppl, n_scored_words, n_oov). Sentences are word lists
        WITHOUT <s>/</s>; they are added here.
        """
        total = 0.0
        n_scored = 0
        n_oov = 0
        unk = self.word_id("<UNK>")
        for sent in sentences:
            ws = ["<s>"] + list(sent) + ["</s>"]
            ids = [self.word_id(w) for w in ws]
            for i in range(1, len(ids)):
                w3 = ids[i]
                if w3 < 0:
                    if use_unk and unk >= 0:
                        w3 = unk
                    else:
                        n_oov += 1
                        continue
                w2 = ids[i - 1] if ids[i - 1] >= 0 else -1
                w1 = ids[i - 2] if i >= 2 and ids[i - 2] >= 0 else -1
                total += self.score(w3, w2, w1)
                n_scored += 1
        ppl = math.exp(-total / max(n_scored, 1))
        return ppl, n_scored, n_oov

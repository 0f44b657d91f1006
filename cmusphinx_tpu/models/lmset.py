"""Class-based language models and runtime LM sets.

Capability parity with sphinxbase ngram_model_set / class LMs (reference:
sphinxbase/src/libsphinxbase/lm/ngram_model_set.c -lmctl parsing + named-LM
switching; ngram_model.c:469 ngram_model_add_class; sphinx3 liblm/lmclass.c
probdef reader) — class tags like `[a_class]` in the LM expand over member
words with in-class probabilities.

Expansion is done eagerly into a concrete `NgramModel` (the device decoder
wants flat CSR tables in device memory; classes are small, so the expansion is
cheap) rather than per-query indirection as in the reference.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ngram import LOG10, NgramModel


def read_probdef(path: str) -> Dict[str, List[Tuple[str, float]]]:
    """LMCLASS probdef file: classes with members (+ optional in-class
    probabilities; uniform over unlisted mass otherwise)."""
    classes: Dict[str, List[Tuple[str, Optional[float]]]] = {}
    cur: Optional[str] = None
    for raw in open(path, errors="replace"):
        line = raw.split("#")[0].strip()
        if not line:
            continue
        m = re.match(r"^LMCLASS\s+(\S+)", line)
        if m:
            cur = m.group(1)
            classes[cur] = []
            continue
        m = re.match(r"^END\s+(\S+)", line)
        if m:
            cur = None
            continue
        if cur is not None:
            parts = line.split()
            w = parts[0]
            p = float(parts[1]) if len(parts) > 1 else None
            classes[cur].append((w, p))
    out: Dict[str, List[Tuple[str, float]]] = {}
    for cname, members in classes.items():
        fixed = sum(p for _, p in members if p is not None)
        n_free = sum(1 for _, p in members if p is None)
        free = max(1.0 - fixed, 0.0) / max(n_free, 1)
        out[cname] = [(w, p if p is not None else free) for w, p in members]
    return out


def expand_classes(m: NgramModel,
                   classes: Dict[str, List[Tuple[str, float]]]) -> NgramModel:
    """Expand class tags into member words (ngram_model_add_class
    capability, eager form): P(member | h) = P(class | h) * P(member|class).
    """
    tag_of = {}
    inlog = {}
    for cname, members in classes.items():
        if m.word_id(cname) < 0:
            continue
        for w, p in members:
            tag_of[w] = cname
            inlog[(cname, w)] = math.log10(max(p, 1e-12))

    def expand_word(w: str) -> List[Tuple[str, float]]:
        """LM word -> [(surface word, extra log10 prob)]"""
        if w in classes and m.word_id(w) >= 0:
            return [(mw, inlog[(w, mw)]) for mw, _ in classes[w]]
        return [(w, 0.0)]

    out = NgramModel()
    out.n = m.n
    # Vocabulary: non-tag base words + members.
    vocab: List[str] = []
    for w in m.words:
        if w in classes:
            vocab.extend(mw for mw, _ in classes[w])
        else:
            vocab.append(w)
    vocab = list(dict.fromkeys(vocab))
    out.words = vocab
    out.wid = {w: i for i, w in enumerate(vocab)}
    V = len(vocab)
    out.ug_prob = np.full(V, -99.0 * LOG10, np.float32)
    out.ug_bo = np.zeros(V, np.float32)
    for w1 in range(m.n_words):
        for sw, extra in expand_word(m.words[w1]):
            i = out.wid[sw]
            out.ug_prob[i] = m.ug_prob[w1] + extra * LOG10
            out.ug_bo[i] = m.ug_bo[w1]
    bgs, tgs = [], []
    for w1 in range(m.n_words):
        for b in range(int(m.bg_ptr[w1]), int(m.bg_ptr[w1 + 1])):
            w2 = int(m.bg_wid[b])
            bo = float(m.bg_bo[b]) / LOG10 if len(m.bg_bo) else 0.0
            for s1, _ in expand_word(m.words[w1]):
                for s2, e2 in expand_word(m.words[w2]):
                    bgs.append((float(m.bg_prob[b]) / LOG10 + e2,
                                (s1, s2), bo))
            for t in range(int(m.tg_ptr[b]), int(m.tg_ptr[b + 1])):
                w3 = int(m.tg_wid[t])
                for s1, _ in expand_word(m.words[w1]):
                    for s2, _ in expand_word(m.words[w2]):
                        for s3, e3 in expand_word(m.words[w3]):
                            tgs.append((float(m.tg_prob[t]) / LOG10 + e3,
                                        (s1, s2, s3), 0.0))
    out._build_csr(bgs, tgs)
    return out


# ----------------------------------------------------------------------
@dataclass
class NgramModelSet:
    """Named runtime-switchable LM collection (-lmctl capability)."""
    models: Dict[str, NgramModel] = field(default_factory=dict)
    current: Optional[str] = None

    @classmethod
    def read_lmctl(cls, path: str, basedir: str = "") -> "NgramModelSet":
        """lmctl format: optional `{ probdef ... }` header, then per line
        `lmfile lmname [{ class ... }]` (ngram_model_set_read)."""
        import os
        text = open(path, errors="replace").read()
        toks = re.findall(r"\{|\}|[^\s{}]+", text)
        pos = 0
        probdefs: Dict[str, List[Tuple[str, float]]] = {}

        def resolve(p: str) -> str:
            return p if os.path.isabs(p) or not basedir else \
                os.path.join(basedir, p)

        if pos < len(toks) and toks[pos] == "{":
            pos += 1
            while pos < len(toks) and toks[pos] != "}":
                probdefs.update(read_probdef(resolve(toks[pos])))
                pos += 1
            pos += 1
        out = cls()
        while pos < len(toks):
            lmfile = toks[pos]
            pos += 1
            name = toks[pos]
            pos += 1
            klasses: List[str] = []
            if pos < len(toks) and toks[pos] == "{":
                pos += 1
                while pos < len(toks) and toks[pos] != "}":
                    klasses.append(toks[pos])
                    pos += 1
                pos += 1
            m = NgramModel.read(resolve(lmfile))
            if klasses:
                m = expand_classes(m, {k: probdefs[k] for k in klasses})
            out.add(name, m)
        return out

    def add(self, name: str, m: NgramModel) -> None:
        self.models[name] = m
        if self.current is None:
            self.current = name

    def select(self, name: str) -> NgramModel:
        if name not in self.models:
            raise KeyError(f"no LM named {name!r}")
        self.current = name
        return self.models[name]

    def lm(self) -> NgramModel:
        return self.models[self.current]

    def names(self) -> List[str]:
        return list(self.models)

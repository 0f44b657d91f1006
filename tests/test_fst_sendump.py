"""Tests for ATT FSM exporters and the sendump writer."""

import math
import os

import numpy as np
import pytest


def test_sendump_roundtrip_8bit(tmp_path):
    from cmusphinx_tpu.models.sendump import read_sendump, write_sendump

    rng = np.random.default_rng(0)
    w = rng.dirichlet(np.ones(8), size=(2, 50)).transpose(0, 2, 1)  # [F,K,S]
    lnw = np.log(w).astype(np.float32)
    p = str(tmp_path / "sendump")
    write_sendump(p, lnw, n_bits=8)
    back = read_sendump(p)
    assert back.shape == lnw.shape
    # Quantization step is 1024*ln(1.0001) ~ 0.102 nats; clamp at 159 steps.
    clamped = np.maximum(lnw, -159 * 1024 * math.log(1.0001) * 1.0001)
    assert np.abs(back - np.maximum(lnw, clamped)).max() < 0.11


def test_sendump_roundtrip_4bit(tmp_path):
    from cmusphinx_tpu.models.sendump import read_sendump, write_sendump

    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.ones(4), size=(1, 33)).transpose(0, 2, 1)  # odd S
    lnw = np.log(w).astype(np.float32)
    p = str(tmp_path / "sendump4")
    write_sendump(p, lnw, n_bits=4)
    back, meta = read_sendump(p, return_raw=True)
    assert meta["n_bits"] == 4
    assert back.shape == lnw.shape
    # 16-entry codebook: coarse but monotone-ish.
    scale = 1024 * math.log(1.0001)
    assert np.abs(-back.astype(np.float32) * scale - lnw).max() < 1.5


def test_shipped_sendump_reexport(seeded_tiny, tmp_path):
    """Round-trip a model's sendump (the seeded semi-continuous one)
    through write+read."""
    from cmusphinx_tpu.models.sendump import read_sendump, write_sendump

    lnw = read_sendump(os.path.join(seeded_tiny.sc, "sendump"))
    p = str(tmp_path / "sendump")
    write_sendump(p, lnw, n_bits=8)
    np.testing.assert_allclose(read_sendump(p), lnw, atol=0.11)


def test_fsg_fst_export(tmp_path):
    from cmusphinx_tpu.models.fsg import FsgModel
    from cmusphinx_tpu.models.fst import read_fst, write_fsg_fst

    src = tmp_path / "goforward.fsg"
    src.write_text(
        "FSG_BEGIN goforward\nNUM_STATES 5\nSTART_STATE 0\n"
        "FINAL_STATE 4\nTRANSITION 0 1 1.0 go\nTRANSITION 1 2 0.5 forward\n"
        "TRANSITION 1 2 0.5 back\nTRANSITION 2 3 1.0 ten\n"
        "TRANSITION 3 4 0.7 meters\nTRANSITION 3 4 0.3\nFSG_END\n")
    fsg = FsgModel.read(str(src))
    p = str(tmp_path / "g.fst.txt")
    write_fsg_fst(fsg, p, symfile=str(tmp_path / "g.syms"))
    arcs, finals = read_fst(p)
    assert len(arcs) == len(fsg.links)
    assert fsg.final_state in finals
    labels = {a[2] for a in arcs}
    assert "forward" in labels or "FORWARD" in labels


def test_dict_fst_export(seeded_tiny, tmp_path):
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.fst import read_fst, write_dict_fst
    from cmusphinx_tpu.models.mdef import Mdef

    mdef = Mdef.read(os.path.join(seeded_tiny.sc, "mdef"))
    d = Dictionary.read(seeded_tiny.digits_dic, mdef)
    p = str(tmp_path / "d.fst.txt")
    write_dict_fst(d, p, isymfile=str(tmp_path / "d.isyms"),
                   osymfile=str(tmp_path / "d.osyms"))
    arcs, finals = read_fst(p)
    assert 0 in finals
    # Arc count equals total pronunciation phones.
    total_phones = sum(len(pr) for pr in d.pron if pr)
    assert len(arcs) == total_phones
    # Every pronunciation path starts at 0 and outputs the word once.
    outs = [a[3] for a in arcs if a[0] == 0 and a[3] != "<eps>"]
    assert len(outs) >= d.n_word - 4  # fillers w/ empty pron excluded


def test_lm_fst_export_scores_match(seeded_tiny, tmp_path):
    """FST path weights equal LM scores for in-vocabulary trigram paths."""
    from cmusphinx_tpu.models.fst import read_fst, write_lm_fst
    from cmusphinx_tpu.models.ngram import NgramModel

    lm = NgramModel.read(seeded_tiny.digits_lm)
    p = str(tmp_path / "lm.fst.txt")
    write_lm_fst(lm, p, symfile=str(tmp_path / "lm.syms"))
    arcs, finals = read_fst(p)
    assert finals
    # Build adjacency for scoring a sentence through the FST (greedy: at
    # each state follow the matching word arc if present else one epsilon).
    adj = {}
    for src, dst, il, ol, w in arcs:
        adj.setdefault(src, {}).setdefault(il, (dst, w))
    start = arcs[0][0]

    def fst_score(words):
        s, tot = start, 0.0
        for w in words:
            hops = 0
            while w not in adj.get(s, {}):
                if "<eps>" not in adj.get(s, {}):
                    raise AssertionError(f"stuck at {s} for {w}")
                dst, wt = adj[s]["<eps>"]
                tot += wt
                s = dst
                hops += 1
                assert hops < 4
            dst, wt = adj[s][w]
            tot += wt
            s = dst
        return -tot, s

    # Score a trigram-covered path and compare to the LM.
    wids = [lm.word_id(w) for w in ("one", "two", "three")]
    assert all(w >= 0 for w in wids)
    got, _ = fst_score([lm.words[w] for w in wids])
    want = (lm.bg_score(lm.word_id("<s>"), wids[0])
            + lm.tg_score(lm.word_id("<s>"), wids[0], wids[1])
            + lm.tg_score(wids[0], wids[1], wids[2]))
    assert abs(got - want) < 1e-3


def test_am_fst_export(seeded_tiny, tmp_path):
    """AM (HMM-level) FST export: senone-in/phone-out chains per phone
    (sphinx_am_fst capability; reference binary is a stub)."""
    from cmusphinx_tpu.models import Mdef, TransitionMatrices
    from cmusphinx_tpu.models.fst import read_fst, write_am_fst
    mdef = Mdef.read(os.path.join(seeded_tiny.sc, "mdef"))
    tmat = TransitionMatrices.read(
        os.path.join(seeded_tiny.sc, "transition_matrices"))
    p = str(tmp_path / "am.fst")
    write_am_fst(mdef, tmat, p, isymfile=str(tmp_path / "am.isym"),
                 osymfile=str(tmp_path / "am.osym"))
    arcs, finals = read_fst(p)
    assert finals  # state 0 final
    # Every CI phone appears exactly once as an output label.
    olabels = [a[3] for a in arcs if a[3] != "<eps>"]
    assert sorted(olabels) == sorted(mdef.ciname)
    # Senone input labels are valid ids.
    for a in arcs:
        if a[2] != "<eps>":
            sid = int(a[2][1:])
            assert 0 <= sid < mdef.n_sen
    # Each phone contributes a left-to-right chain with self loops:
    # arc count ~ n_ci * (2 * n_state + skips + exits).
    assert len(arcs) >= mdef.n_ciphone * 2 * mdef.n_emit_state
    # Weights are -log probs: all finite, non-negative-ish.
    assert all(a[4] > -1e-6 for a in arcs)
    syms = open(str(tmp_path / "am.osym")).read().split()
    assert "<eps>" in syms

"""Seeded models (evals/seeded.py) through the normal readers, the decoder
on planted utterances, and each scorer against its float64 reference
(evals/reference64.py) — the CPU side of chip_smoke.py at a reduced width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference64
from seeded import DIGITS, PHONES, SIL, TINY, Planter, waveform


def test_seeded_models_round_trip_through_readers(seeded_tiny, tmp_path):
    from cmusphinx_tpu.models import Mdef, TransitionMatrices
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.models.sendump import (read_mixture_weights,
                                              read_sendump)

    s = seeded_tiny
    mdef = Mdef.read(os.path.join(s.sc, "mdef"))
    assert mdef.n_ciphone == len(PHONES) + 1 and mdef.ciname[mdef.sil] == SIL
    assert mdef.n_sen == TINY.n_sen and mdef.n_phone > mdef.n_ciphone
    assert mdef.sseq.max() < mdef.n_sen
    # Every boundary triphone the digits need resolves to itself.
    one = [mdef.ciphone_id[p] for p in DIGITS["ONE"].split()]
    pid = mdef.phone_id(one[0], mdef.ciphone_id["S"], one[1], 1)
    assert pid >= mdef.n_ciphone and tuple(mdef.phone_ctx[pid]) == (
        one[0], mdef.ciphone_id["S"], one[1], 1)

    g = read_gauden(os.path.join(s.sc, "means"),
                    os.path.join(s.sc, "variances"))
    assert (g.n_mgau, g.n_feat, g.n_density, g.veclen) == (
        1, 3, TINY.n_density, [13, 13, 13])
    raw, meta = read_sendump(os.path.join(s.sc, "sendump"), return_raw=True)
    assert raw.shape == (3, TINY.n_density, TINY.n_sen)
    assert meta["n_bits"] == 8 and (raw.min(1) == 0).all()  # primary density

    gc = read_gauden(os.path.join(s.cont, "means"),
                     os.path.join(s.cont, "variances"))
    assert (gc.n_mgau, gc.n_feat, gc.n_density, gc.maxlen) == (
        TINY.n_sen, 1, TINY.n_gauss, 39)
    assert (gc.var <= 1.0001e-4).any()                      # floored
    w = read_mixture_weights(os.path.join(s.cont, "mixture_weights"))
    assert w.shape == (1, TINY.n_gauss, TINY.n_sen)
    np.testing.assert_allclose(np.exp(w).sum(1), 1.0, rtol=1e-5)

    for d in (s.sc, s.cont):
        tm = TransitionMatrices.read(os.path.join(d, "transition_matrices"))
        assert tm.n_tmat == mdef.n_ciphone and tm.check_bakis()

    words = Dictionary.read(s.words_dic, mdef)
    assert words.n_word == TINY.n_words + 3               # + <s> </s> <sil>
    for path in (s.digits_lm, s.words_lm):
        lm = NgramModel.read(path)
        assert lm.n == 3 and min(lm.counts()) > 0
        lm.write_arpa(str(tmp_path / "again.lm"))
        back = NgramModel.read(str(tmp_path / "again.lm"))
        assert back.words == lm.words
        for a in ("ug_prob", "bg_wid", "bg_prob", "tg_wid", "tg_prob"):
            np.testing.assert_allclose(getattr(back, a), getattr(lm, a),
                                       atol=1e-3)


def test_decoder_builds_on_both_models(seeded_tiny):
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.ops.gmm import ContinuousScorer, PsParityScorer

    s = seeded_tiny
    sc = Decoder(hmm=s.sc, lm=s.digits_lm, dict=s.digits_dic)
    assert isinstance(sc.scorer, PsParityScorer)
    assert sc.scorer.n_sen == TINY.n_sen and sc.fp.n_streams == 3
    assert [len(x) for x in sc.fp.stream_slices()] == [13, 13, 13]
    cont = Decoder(hmm=s.cont, lm=s.digits_lm, dict=s.digits_dic,
                   gmmprec="high")
    assert isinstance(cont.scorer, ContinuousScorer)
    assert cont.scorer.precision == "high"
    with pytest.raises(ValueError, match="gmmprec"):
        Decoder(hmm=s.sc, lm=s.digits_lm, dict=s.digits_dic, gmmprec="tf32")


DECODES = {
    "a": ("sc", "digits", {}, "mpx/onehot"),
    "b": ("sc", "words", dict(lexmode="tree", rcmode="composite",
                              lcmode="composite"), "tree_batched"),
    "c": ("cont", "words", dict(lexmode="flat", rcmode="composite",
                                lcmode="composite"), "static_batched"),
}


@pytest.mark.parametrize("config", sorted(DECODES))
def test_planted_transcripts_decode(seeded_tiny, config):
    from cmusphinx_tpu.api import Decoder

    model, lex, kw, core = DECODES[config]
    s = seeded_tiny
    dic, lm = s.lexicon(lex)
    d = Decoder(hmm=s.sc if model == "sc" else s.cont, lm=lm, dict=dic, **kw)
    utts = Planter(s, model, lex).batch(np.random.default_rng(4), 4, 1.0, 2.0)
    hyps = d.search.decode_batch([f for _, f in utts])
    assert [h.words for h in hyps] == [w for w, _ in utts]
    assert d.search.scan_core() == core


def test_dp_sharded_decode_matches_one_device(seeded_tiny):
    """Decode (b) with the batch split over an 8-device `dp` mesh gives the
    one-device hypotheses (chip_smoke.py --multi on four GPUs)."""
    from jax.sharding import Mesh
    from cmusphinx_tpu.api import Decoder

    s = seeded_tiny
    model, lex, kw, _ = DECODES["b"]
    d = Decoder(hmm=s.sc, lm=s.words_lm, dict=s.words_dic, **kw)
    utts = Planter(s, model, lex).batch(np.random.default_rng(5), 6, 1.0, 2.0)
    feats = [f for _, f in utts]
    one = d.search.decode_batch(feats)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    dp = d.search.decode_batch(feats, mesh=mesh)       # 6 padded to 8
    assert [h.words for h in dp] == [h.words for h in one]
    assert [h.words for h in dp] == [w for w, _ in utts]
    np.testing.assert_allclose([h.score for h in dp],
                               [h.score for h in one], rtol=1e-5)


def test_frontend_mfcc_matches_float64(seeded_tiny):
    from cmusphinx_tpu.api import Decoder

    d = Decoder(hmm=seeded_tiny.sc, lm=seeded_tiny.digits_lm,
                dict=seeded_tiny.digits_dic)
    wav = waveform(0, 1.0)
    cep = np.asarray(d.fe.process(wav.astype(np.float32)))
    ref = reference64.mfcc(d.fe, wav)
    assert cep.shape == ref.shape == (d.fe.n_frames(len(wav)), 13)
    assert np.abs(cep - ref).max() < 1e-3


SCORERS = ["parity", "semi", "cont-highest", "cont-high", "cont-bf16"]


@pytest.mark.parametrize("which", SCORERS)
def test_scorer_matches_float64_reference(seeded_tiny, which):
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.models.sendump import read_sendump
    from cmusphinx_tpu.ops.gmm import ContinuousScorer, SemiContinuousScorer

    s = seeded_tiny
    rng = np.random.default_rng(6)
    if which.startswith("cont"):
        pc = Planter(s, "cont", "words")
        x = pc.utterance(rng, 1.0)[1]
        lnw = np.log(pc.w).astype(np.float32)
        prec = which.split("-")[1]
        want, mag = reference64.cont_scores(x, pc.g, lnw)
        got = np.asarray(ContinuousScorer(pc.g, lnw, precision=prec)
                         .score(jnp.asarray(x)))
        assert (np.abs(got - want) <= reference64.REL_BOUND[prec] * mag).all()
        return
    d = Decoder(hmm=s.sc, lm=s.digits_lm, dict=s.digits_dic)
    pl = Planter(s, "sc", "words")
    x = pl.utterance(rng, 1.0)[1]
    slices = d.fp.stream_slices()
    if which == "parity":
        raw, _ = read_sendump(os.path.join(s.sc, "sendump"), return_raw=True)
        want = reference64.parity_scores(x, pl.g, raw, slices)
        got = np.asarray(d.scorer.score(jnp.asarray(x)))
        # at most one quantization step per stream (truncation boundaries)
        assert np.abs(got - want).max() <= 3 * d.scorer.scale
        return
    lnw = read_sendump(os.path.join(s.sc, "sendump"))
    want = reference64.semi_scores(x, pl.g, lnw, slices)
    got = np.asarray(SemiContinuousScorer(pl.g, lnw, slices)
                     .score(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_planted_senone_path_uses_cross_word_triphones(seeded_tiny):
    from seeded import senone_path

    pl = Planter(seeded_tiny, "sc", "digits")
    seqs = senone_path(pl.mdef, pl.dict, ["ONE", "TWO"])
    sil = pl.mdef.sseq[pl.mdef.phone_ssid[pl.mdef.sil]]
    assert len(seqs) == 2 + 3 + 2            # SIL, W AH N, T UW, SIL
    np.testing.assert_array_equal(seqs[0], sil)
    ci = pl.mdef.ciphone_id
    n_end = pl.mdef.phone_id(ci["N"], ci["AH"], ci["T"], 2)
    np.testing.assert_array_equal(
        seqs[3], pl.mdef.sseq[pl.mdef.phone_ssid[n_end]])
    assert all(len(q) == 3 for q in seqs)

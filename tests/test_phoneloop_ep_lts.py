"""Tests for phone-loop lookahead, GMM endpointer, and LTS fallback."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def tidigits(reference_root):
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.ops.gmm import SemiContinuousScorer
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.utils.config import Config

    H = str(reference_root / "pocketsphinx/model/hmm/en/tidigits")
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w = read_sendump(H + "/sendump")
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = SemiContinuousScorer(g, w, fp.stream_slices())
    return mdef, tmat, scorer, fp


def test_phone_loop_scores_and_mask(tidigits, reference_root):
    from cmusphinx_tpu.decode.phone_loop import PhoneLoopSearch
    from cmusphinx_tpu.utils.bio import read_mfc

    mdef, tmat, scorer, fp = tidigits
    mfc = read_mfc(str(reference_root / "pocketsphinx/test/data/tidigits/"
                       "man.ah.111a.mfc"))
    feats = fp.compute(mfc)
    pl = PhoneLoopSearch(mdef, tmat, scorer)
    ph = pl.phone_scores(feats)
    assert ph.shape == (feats.shape[0], mdef.n_ciphone)
    assert np.isfinite(ph).all()
    # Frame-relative: per-frame max is 0 after renormalization.
    np.testing.assert_allclose(ph.max(axis=1), 0.0, atol=1e-4)

    mask = pl.lookahead_mask(feats, window=3, pl_beam=5e-2)
    assert mask.shape == ph.shape
    # The mask keeps at least the best phone everywhere but prunes some.
    assert mask.any(axis=1).all()
    assert not mask.all()

    h = pl.heuristic(feats, window=5)
    assert h.shape == (feats.shape[0],)
    assert np.isfinite(h).all()


def test_endpointer_classify_and_segment():
    from cmusphinx_tpu.frontend.ep import (
        CLASS_SIL, CLASS_SPEECH, Endpointer, FrameClassifier)

    rng = np.random.default_rng(0)
    D = 4
    # Synthetic: silence frames near 0, speech frames near +4.
    sil = rng.normal(size=(400, D)).astype(np.float32)
    sp = (rng.normal(size=(400, D)) + 4.0).astype(np.float32)
    feats = np.concatenate([sil, sp])
    labels = np.concatenate([np.zeros(400, np.int64),
                             np.full(400, CLASS_SPEECH, np.int64)])
    clf = FrameClassifier.fit(feats, labels, n_class=2, n_comp=2, n_iter=5)
    acc = (clf.classify(feats, voting_window=1) == labels).mean()
    assert acc > 0.95

    # Stream: 100 sil, 120 speech, 80 sil, 60 speech, 100 sil.
    stream = np.concatenate([
        rng.normal(size=(100, D)),
        rng.normal(size=(120, D)) + 4.0,
        rng.normal(size=(80, D)),
        rng.normal(size=(60, D)) + 4.0,
        rng.normal(size=(100, D)),
    ]).astype(np.float32)
    classes = clf.classify(stream)
    utts = Endpointer(end_window=30, pad_before=5, pad_after=5).segment(classes)
    assert len(utts) == 2
    assert abs(utts[0].start_frame - 95) < 15
    assert abs(utts[0].end_frame - 225) < 15
    assert abs(utts[1].start_frame - 295) < 15


def test_lts_learns_simple_rules():
    from cmusphinx_tpu.models.lts import LtsModel

    # A tiny regular language: letters map 1:1 to phones.
    import itertools
    letters = {"b": "B", "a": "AE", "t": "T", "s": "S", "o": "OW", "m": "M"}
    words = []
    for n in (2, 3, 4):
        for combo in itertools.product("batsom", repeat=n):
            w = "".join(combo)
            words.append((w.upper(), [letters[c] for c in combo]))
    words = words[:400]
    m = LtsModel.train(words, k=2, em_iters=2)
    assert m.predict("BAT") == ["B", "AE", "T"]
    assert m.predict("TOMS") == ["T", "OW", "M", "S"]
    # Round-trip save/load.
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "lts.txt")
        m.save(p)
        m2 = LtsModel.load(p)
        assert m2.predict("BAT") == ["B", "AE", "T"]


def test_lts_on_cmudict_sample(reference_root):
    from cmusphinx_tpu.models.lts import read_cmudict, LtsModel

    entries = read_cmudict(str(reference_root / "cmudict/cmudict.0.7a"),
                           max_words=4000)
    assert len(entries) > 3000
    m = LtsModel.train(entries[:3500], k=3, em_iters=2)
    # Held-out phone accuracy: predictions should be clearly better than
    # chance (the reference's tree rules achieve high accuracy with a
    # hand-built table; the learned decision list must be usable).
    ok = tot = 0
    exact = 0
    for w, ph in entries[3500:3700]:
        pred = m.predict(w)
        if pred == ph:
            exact += 1
        n = min(len(pred), len(ph))
        ok += sum(1 for a, b in zip(pred[:n], ph[:n]) if a == b)
        tot += max(len(pred), len(ph))
    assert tot > 0 and ok / tot > 0.45

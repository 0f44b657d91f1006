"""HTK MMF converter tests (htk2s3conv capability)."""

import numpy as np
import pytest

from cmusphinx_tpu.models.htk import HtkModelSet, convert_htk

MMF = """~o <VecSize> 4 <MFCC_D_A_0> <StreamInfo> 1 4
~v "varFloor1"
<Variance> 4
 1.0 1.0 1.0 1.0
~s "shared2"
<NumMixes> 2
<Mixture> 1 0.6
<Mean> 4
 1.0 0.0 0.0 0.0
<Variance> 4
 0.5 0.5 0.5 0.5
<Mixture> 2 0.4
<Mean> 4
 -1.0 0.0 0.0 0.0
<Variance> 4
 0.5 0.5 0.5 0.5
~h "sil"
<BeginHMM>
<NumStates> 5
<State> 2
<Mean> 4
 0.0 0.0 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<State> 3
~s "shared2"
<State> 4
<Mean> 4
 0.0 1.0 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<TransP> 5
 0.0 1.0 0.0 0.0 0.0
 0.0 0.6 0.4 0.0 0.0
 0.0 0.0 0.6 0.4 0.0
 0.0 0.0 0.0 0.6 0.4
 0.0 0.0 0.0 0.0 0.0
<EndHMM>
~h "ax"
<BeginHMM>
<NumStates> 5
<State> 2
<Mean> 4
 2.0 0.0 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<State> 3
<Mean> 4
 2.0 2.0 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<State> 4
~s "shared2"
<TransP> 5
 0.0 1.0 0.0 0.0 0.0
 0.0 0.5 0.5 0.0 0.0
 0.0 0.0 0.5 0.5 0.0
 0.0 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0 0.0
<EndHMM>
~h "sil-ax+sil"
<BeginHMM>
<NumStates> 5
<State> 2
<Mean> 4
 2.5 0.0 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<State> 3
<Mean> 4
 2.5 2.5 0.0 0.0
<Variance> 4
 1.0 1.0 1.0 1.0
<State> 4
~s "shared2"
<TransP> 5
 0.0 1.0 0.0 0.0 0.0
 0.0 0.5 0.5 0.0 0.0
 0.0 0.0 0.5 0.5 0.0
 0.0 0.0 0.0 0.5 0.5
 0.0 0.0 0.0 0.0 0.0
<EndHMM>
"""


def test_htk_parse(tmp_path):
    p = str(tmp_path / "model.mmf")
    open(p, "w").write(MMF)
    ms = HtkModelSet.read(p)
    assert set(ms.hmms) == {"sil", "ax", "sil-ax+sil"}
    assert ms.vecsize == 4
    h = ms.hmms["ax"]
    assert len(h.states) == 3
    # shared state: same object semantics (same parameters)
    np.testing.assert_allclose(h.states[2].weights, [0.6, 0.4])


def test_htk_convert_and_load(tmp_path):
    from cmusphinx_tpu.models import Mdef, TransitionMatrices
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.sendump import read_mixture_weights
    from cmusphinx_tpu.ops.gmm import ContinuousScorer

    p = str(tmp_path / "model.mmf")
    open(p, "w").write(MMF)
    out = str(tmp_path / "s3model")
    m = convert_htk(p, out)
    # sil renamed to SIL; triphone registered.
    assert "SIL" in m.ciname
    ax = m.ciphone_id["ax"]
    sil = m.ciphone_id["SIL"]
    tri = m.phone_id(ax, sil, sil, 0)
    assert tri >= m.n_ciphone  # found the sil-ax+sil triphone
    # Round trip through the framework's own readers.
    m2 = Mdef.read(out + "/mdef")
    assert m2.n_sen == m.n_sen and m2.n_ciphone == 2
    g = read_gauden(out + "/means", out + "/variances")
    lnw = read_mixture_weights(out + "/mixture_weights")
    tmat = TransitionMatrices.read(out + "/transition_matrices")
    assert tmat.check_bakis()
    assert g.n_mgau == m.n_sen and g.n_density == 2
    # Continuous scorer runs on the converted model.
    sc = ContinuousScorer(g, lnw[0].T)
    scores = np.asarray(sc.score(np.zeros((3, 4), np.float32)))
    assert scores.shape == (3, m.n_sen)
    assert np.isfinite(scores).all()
    # State 0 of sil (mean zero) must beat ax's state 0 (mean 2.0) on a
    # zero observation.
    sil_sen = int(m2.sseq[m2.phone_ssid[sil], 0])
    ax_sen = int(m2.sseq[m2.phone_ssid[ax], 0])
    assert scores[0, sil_sen] > scores[0, ax_sen]


def test_mmf_roundtrip_real_model(reference_root, tmp_path):
    """Round-trip a REAL shipped continuous model through HTK MMF text:
    s3 -> write_mmf -> HtkModelSet.read -> convert -> s3, then compare
    every phone-state's Gaussians/weights and transitions (round-2/3
    reviews flagged that the converter was only exercised on synthetic
    fixtures)."""
    import numpy as np
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.htk import HtkModelSet, write_mmf
    from cmusphinx_tpu.models.mdef import Mdef
    from cmusphinx_tpu.models.sendump import read_mixture_weights
    from cmusphinx_tpu.models.tmat import TransitionMatrices

    H = str(reference_root
            / "sphinx3/model/hmm/tidigits/wd_dependent_phone"
              ".cd_continuous_8gau")
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    lnw = read_mixture_weights(H + "/mixture_weights")   # [nf, K, S] ln
    mixw = np.exp(lnw[0].T)                              # [S, K] linear
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    tprobs = np.where(tmat.log_tp > -1e29, np.exp(tmat.log_tp), 0.0)

    mmf = tmp_path / "model.mmf"
    write_mmf(str(mmf), mdef, g, mixw, tprobs)
    ms = HtkModelSet.read(str(mmf))
    assert len(ms.hmms) == mdef.n_phone
    assert ms.vecsize == 39

    out = tmp_path / "s3"
    m2 = ms.convert(str(out))
    g2 = read_gauden(str(out / "means"), str(out / "variances"))
    lnw2 = read_mixture_weights(str(out / "mixture_weights"))
    mixw2 = np.exp(lnw2[0].T)
    tm2 = TransitionMatrices.read(str(out / "transition_matrices"))

    # Compare per phone-state via each mdef's own senone mapping (senone
    # NUMBERING may legitimately permute through the round trip).
    name2 = {}
    for p in range(m2.n_phone):
        b, lc, rc, _ = m2.phone_ctx[p]
        base = m2.ciname[b]
        nm = (f"{m2.ciname[lc]}-{base}+{m2.ciname[rc]}"
              if (lc >= 0 or rc >= 0) else base)
        name2[nm] = p
    S = mdef.n_emit_state
    checked = 0
    for p in range(mdef.n_phone):
        b, lc, rc, _ = mdef.phone_ctx[p]
        base = mdef.ciname[b]
        nm = (f"{mdef.ciname[lc]}-{base}+{mdef.ciname[rc]}"
              if (lc >= 0 or rc >= 0) else base)
        p2 = name2[nm]
        sen1 = mdef.sseq[mdef.phone_ssid[p]][:S]
        sen2 = m2.sseq[m2.phone_ssid[p2]][:S]
        for s in range(S):
            a, b_ = int(sen1[s]), int(sen2[s])
            np.testing.assert_allclose(
                g.means[a, 0], g2.means[b_, 0], rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(
                g.var[a, 0], g2.var[b_, 0], rtol=2e-6, atol=2e-6)
            np.testing.assert_allclose(
                mixw[a], mixw2[b_], rtol=1e-5, atol=1e-7)
            checked += 1
        np.testing.assert_allclose(
            np.where(tmat.log_tp[mdef.phone_tmat[p]] > -1e29,
                     np.exp(tmat.log_tp[mdef.phone_tmat[p]]), 0.0),
            np.where(tm2.log_tp[m2.phone_tmat[p2]] > -1e29,
                     np.exp(tm2.log_tp[m2.phone_tmat[p2]]), 0.0),
            rtol=1e-5, atol=1e-6)
    assert checked == mdef.n_phone * S

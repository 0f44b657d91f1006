"""Approximate-GMM ops: frame downsampling + CIGMMS masked forms.

Reference: sphinx3 approx_cont_mgau.c:108-276.  The WER/speed verdicts
live in EVALS.md (evals/run_approx_gmm.py); these tests pin the exact
semantics of the dense formulations.
"""

import numpy as np
import pytest

from cmusphinx_tpu.ops.approx import CigmmsScorer, DownsampledScorer


class _FnScorer:
    """Scores derived from the features so slicing semantics flow through:
    score(t) = [x, 2x, x+1] for x = feats[t, 0]."""
    n_sen = 3

    def score(self, feats):
        import jax.numpy as jnp
        x = feats[:, 0]
        return jnp.stack([x, 2.0 * x, x + 1.0], axis=1)


class _ToyScorer:
    def __init__(self, scores):
        self._s = np.asarray(scores, np.float32)
        self.n_sen = self._s.shape[1]

    def score(self, feats):
        import jax.numpy as jnp
        return jnp.asarray(self._s[: feats.shape[0]])


def test_downsample_repeats_previous_frame():
    import jax.numpy as jnp
    T = 7
    feats = jnp.asarray(np.arange(T, dtype=np.float32)[:, None])
    sc = DownsampledScorer(_FnScorer(), 2)
    out = np.asarray(sc.score(feats))
    assert out.shape == (T, 3)
    for t in range(T):
        x = float((t // 2) * 2)   # skipped frames reuse the previous one
        np.testing.assert_array_equal(out[t], [x, 2 * x, x + 1])


def test_downsample_ratio_one_is_identity():
    import jax.numpy as jnp
    feats = jnp.asarray(np.arange(5, dtype=np.float32)[:, None])
    sc = DownsampledScorer(_FnScorer(), 1)
    np.testing.assert_array_equal(np.asarray(sc.score(feats)),
                                  np.asarray(_FnScorer().score(feats)))


def test_cigmms_bypass():
    import jax.numpy as jnp
    # 2 CI senones + 2 CD senones; cd2ci maps CD->CI parents.
    #            ci0   ci1   cd0(p=ci0) cd1(p=ci1)
    s = np.array([[0.0, -10.0, 5.0,      7.0]], np.float32)
    cd2ci = np.array([0, 1, 0, 1], np.int32)
    sc = CigmmsScorer(_ToyScorer(s), cd2ci, n_ci_sen=2, ci_pbeam=4.0)
    out = np.asarray(sc.score(jnp.zeros((1, 2))))
    # best CI = 0.0; ci1 is 10 below -> cd1 bypassed to its parent score.
    np.testing.assert_allclose(out[0], [0.0, -10.0, 5.0, -10.0])
    # wide beam: nothing bypassed
    sc2 = CigmmsScorer(_ToyScorer(s), cd2ci, n_ci_sen=2, ci_pbeam=50.0)
    np.testing.assert_allclose(np.asarray(sc2.score(jnp.zeros((1, 2))))[0],
                               s[0])


def test_gs_selector_shortlist_semantics():
    """The gs selector floors only non-shortlisted Gaussians; with all
    clusters kept it matches the dense scorer exactly."""
    import jax.numpy as jnp
    from cmusphinx_tpu.models.gauden import GaussianParams
    from cmusphinx_tpu.ops.approx import GsSelectorScorer
    from cmusphinx_tpu.ops.gmm import ContinuousScorer
    rng = np.random.RandomState(0)
    S, K, D = 12, 4, 6
    means = rng.randn(S, 1, K, D).astype(np.float32)
    var = (0.5 + rng.rand(S, 1, K, D)).astype(np.float32)
    prec = 1.0 / (2.0 * var)
    lrd = -0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi)).astype(
        np.float32)
    gp = GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                        veclen=[D], n_mgau=S, n_feat=1, n_density=K)
    lw = np.log(np.full((S, K), 1.0 / K, np.float32))
    dense = ContinuousScorer(gp, lw)
    x = jnp.asarray(rng.randn(20, D).astype(np.float32))
    gs_all = GsSelectorScorer(dense, gp, n_clusters=8, top_c=8)
    np.testing.assert_allclose(np.asarray(gs_all.score(x)),
                               np.asarray(dense.score(x)),
                               rtol=1e-5, atol=1e-4)
    gs1 = GsSelectorScorer(dense, gp, n_clusters=8, top_c=1)
    out = np.asarray(gs1.score(x))
    ref = np.asarray(dense.score(x))
    assert np.all(out <= ref + 1e-4)   # flooring only removes mass


def test_kdtree_selector_semantics():
    """BBI kd-tree shortlists (kdtree.c capability): with a huge box
    radius every Gaussian's box intersects every bucket and the scorer
    matches dense exactly; with a tight radius flooring only removes
    mass; maxbbi bounds every bucket's shortlist."""
    import jax.numpy as jnp
    from cmusphinx_tpu.models.gauden import GaussianParams
    from cmusphinx_tpu.ops.approx import KdTreeSelectorScorer
    from cmusphinx_tpu.ops.gmm import ContinuousScorer
    rng = np.random.RandomState(1)
    S, K, D = 10, 4, 5
    means = (4.0 * rng.randn(S, 1, K, D)).astype(np.float32)
    var = (0.5 + rng.rand(S, 1, K, D)).astype(np.float32)
    prec = 1.0 / (2.0 * var)
    lrd = -0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi)).astype(
        np.float32)
    gp = GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                        veclen=[D], n_mgau=S, n_feat=1, n_density=K)
    lw = np.log(np.full((S, K), 1.0 / K, np.float32))
    dense = ContinuousScorer(gp, lw)
    x = jnp.asarray(rng.randn(30, D).astype(np.float32))

    kd_all = KdTreeSelectorScorer(dense, gp, depth=3, radius=1e6)
    np.testing.assert_allclose(np.asarray(kd_all.score(x)),
                               np.asarray(dense.score(x)),
                               rtol=1e-5, atol=1e-4)
    kd = KdTreeSelectorScorer(dense, gp, depth=3, radius=1.5)
    out = np.asarray(kd.score(x))
    ref = np.asarray(dense.score(x))
    assert np.all(out <= ref + 1e-4)
    assert np.any(np.asarray(kd._leaf_keep).sum(axis=(1, 2))
                  < S * K)  # tight boxes actually prune
    kd_cap = KdTreeSelectorScorer(dense, gp, depth=3, radius=1e6, maxbbi=7)
    assert np.all(np.asarray(kd_cap._leaf_keep).sum(axis=(1, 2)) <= 7)


def test_interpolated_scorer():
    """Decode-time CD/CI interpolation (interp.c interp_all): CD scores
    become logadd(cd+log(lam), ci+log(1-lam)); CI rows unchanged; lam=1
    is the identity."""
    import jax.numpy as jnp
    from cmusphinx_tpu.ops.gmm import InterpolatedScorer
    #           ci0  ci1  cd0(->ci0)  cd1(->ci1)
    s = np.array([[0.0, -2.0, -1.0, -4.0],
                  [-1.0, 0.0, -3.0, -0.5]], np.float32)
    cd2ci = np.array([0, 1, 0, 1], np.int32)
    sc = InterpolatedScorer(_ToyScorer(s), cd2ci, n_ci_sen=2, lam=0.7)
    out = np.asarray(sc.score(jnp.zeros((2, 3))))
    np.testing.assert_allclose(out[:, :2], s[:, :2], atol=1e-6)
    want = np.logaddexp(s[:, 2:] + np.log(0.7),
                        s[:, [0, 1]] + np.log(0.3))
    np.testing.assert_allclose(out[:, 2:], want, atol=1e-5)
    # lam ~ 1: identity (within the clipping epsilon)
    sc1 = InterpolatedScorer(_ToyScorer(s), cd2ci, n_ci_sen=2, lam=1.0)
    np.testing.assert_allclose(np.asarray(sc1.score(jnp.zeros((2, 3)))),
                               s, atol=1e-4)
    # per-senone lambda vector accepted
    lam = np.array([0.5, 0.5, 0.9, 0.1], np.float32)
    scv = InterpolatedScorer(_ToyScorer(s), cd2ci, n_ci_sen=2, lam=lam)
    outv = np.asarray(scv.score(jnp.zeros((2, 3))))
    wantv = np.logaddexp(s[:, 2:] + np.log(lam[2:]),
                         s[:, [0, 1]] + np.log(1 - lam[2:]))
    np.testing.assert_allclose(outv[:, 2:], wantv, atol=1e-5)


def test_decoder_lambda_flag(tmp_path, reference_root):
    """-lambda wires InterpolatedScorer into the Decoder; a near-1 lambda
    leaves the tidigits hypothesis intact."""
    from cmusphinx_tpu.api import Decoder
    from cmusphinx_tpu.ops.gmm import InterpolatedScorer
    R = reference_root / "pocketsphinx"
    import cmusphinx_tpu.models.mdef as _m
    mdef = _m.Mdef.read(str(R / "model/hmm/en/tidigits/mdef"))
    lam = np.full(mdef.n_sen, 0.999, np.float32)
    lpath = tmp_path / "lambda.npy"
    np.save(lpath, lam)
    d = Decoder(hmm=str(R / "model/hmm/en/tidigits"),
                lm=str(R / "model/lm/en/tidigits.DMP"),
                dict=str(R / "model/lm/en/tidigits.dic"),
                **{"lambda": str(lpath)})
    assert isinstance(d.scorer, InterpolatedScorer)
    h = d.decode_cep_file(str(R / "test/data/tidigits/man.ah.111a.mfc"))
    assert h.text == "ONE ONE ONE"

"""The continuous scorer's dense formulation and its -gmmprec modes
against the float64 reference (evals/reference64.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

import reference64
from cmusphinx_tpu.models.gauden import GaussianParams
from cmusphinx_tpu.ops.gmm import GEMM_PRECISIONS, ContinuousScorer


def _random_gauden(rng, S, K, D):
    means = rng.randn(S, 1, K, D).astype(np.float32)
    var = (0.3 + rng.rand(S, 1, K, D)).astype(np.float32)
    prec = (1.0 / (2.0 * var)).astype(np.float32)
    lrd = (-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
           ).astype(np.float32)
    return GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                          veclen=[D], n_mgau=S, n_feat=1, n_density=K)


def _case(seed, S, K, D, T):
    rng = np.random.RandomState(seed)
    g = _random_gauden(rng, S, K, D)
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    return g, lnw, rng.randn(T, D).astype(np.float32)


@pytest.mark.parametrize("S,K,D,T", [(37, 8, 13, 50), (128, 4, 16, 32)])
def test_dense_matches_float64(S, K, D, T):
    g, lnw, x = _case(0, S, K, D, T)
    got = np.asarray(ContinuousScorer(g, lnw).score(jnp.asarray(x)))
    want, mag = reference64.cont_scores(x, g, lnw)
    assert got.shape == (T, S)
    assert (np.abs(got - want) <= reference64.REL_BOUND["highest"] * mag
            + 1e-5).all()


def test_topn_keeps_the_best_components():
    """topn=2 (the reference's shortlist) equals a float64 log-sum-exp over
    each senone's two best weighted densities."""
    g, lnw, x = _case(1, 20, 6, 13, 15)
    got = np.asarray(ContinuousScorer(g, lnw, topn=2).score(jnp.asarray(x)))
    m = g.means[:, 0].astype(np.float64)
    v = g.var[:, 0].astype(np.float64)
    d = (lnw[None] - 0.5 * (np.log(v).sum(-1) + 13 * np.log(2 * np.pi))[None]
         - (((x[:, None, None, :] - m[None]) ** 2) / (2 * v[None])).sum(-1))
    top = np.sort(d, -1)[..., -2:]
    want = np.logaddexp(top[..., 0], top[..., 1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_bf16_serving_mode_close():
    """-gmmprec bf16: parameters in bfloat16, one bf16 product with f32
    accumulation — within the bf16 rounding budget (~0.5 nats at these
    density magnitudes) of f32, and inside the mode's bound."""
    g, lnw, x = _case(2, 64, 8, 13, 40)
    f32 = np.asarray(ContinuousScorer(g, lnw).score(jnp.asarray(x)))
    b16 = np.asarray(ContinuousScorer(g, lnw, precision="bf16")
                     .score(jnp.asarray(x)))
    assert np.max(np.abs(b16 - f32)) < 0.5
    want, mag = reference64.cont_scores(x, g, lnw)
    assert (np.abs(b16 - want) <= reference64.REL_BOUND["bf16"] * mag).all()


def test_gmmprec_high_close_to_highest():
    g, lnw, x = _case(3, 32, 4, 13, 20)
    f32 = np.asarray(ContinuousScorer(g, lnw).score(jnp.asarray(x)))
    hi = np.asarray(ContinuousScorer(g, lnw, precision="high")
                    .score(jnp.asarray(x)))
    assert np.max(np.abs(hi - f32)) < 0.05


def test_gmmprec_rejects_unknown():
    g, lnw, _ = _case(4, 8, 2, 5, 1)
    with pytest.raises(ValueError):
        ContinuousScorer(g, lnw, precision="int8")
    assert set(GEMM_PRECISIONS) == {"highest", "high", "bf16"}

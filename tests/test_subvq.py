"""Sub-vector-quantized Gaussian selection: reference-format interop,
gausubvq builder, approximate scorer sanity."""

import numpy as np
import pytest

from cmusphinx_tpu.models.gauden import GaussianParams
from cmusphinx_tpu.ops.subvq import (SubVQ, SubVQScorer, build_subvq,
                                     read_subvq, write_subvq)


def _gauden(rng, S, K, D, n_proto: int = 0):
    if n_proto:
        # VQ-compressible: means cluster around a few prototypes (as real
        # acoustic models do) so the sub-vector codebooks recover structure.
        proto = rng.randn(n_proto, D).astype(np.float32) * 2
        means = (proto[rng.randint(0, n_proto, S * K)]
                 + 0.1 * rng.randn(S * K, D)).reshape(S, 1, K, D)
        means = means.astype(np.float32)
    else:
        means = rng.randn(S, 1, K, D).astype(np.float32) * 2
    var = (0.3 + rng.rand(S, 1, K, D)).astype(np.float32)
    prec = (1.0 / (2.0 * var)).astype(np.float32)
    lrd = (-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
           ).astype(np.float32)
    return GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                          veclen=[D], n_mgau=S, n_feat=1, n_density=K)


def test_read_reference_subvq(reference_root):
    p = (reference_root / "sphinx3/model/hmm/"
         "hub4_cd_continuous_8gau_1s_c_d_dd/test.subvq")
    svq = read_subvq(str(p))
    assert svq.n_sv == 1 and svq.vqsize == 16
    assert svq.map.shape == (6144, 8, 1)
    assert svq.dims[0].tolist() == list(range(39))
    # -1 marks absent Gaussians (codebooks with < n_density components).
    assert np.all(svq.map >= -1) and np.all(svq.map < 16)
    assert (svq.map >= 0).mean() > 0.9
    assert np.all(svq.var[0] > 0)


def test_build_roundtrip_and_scorer(tmp_path):
    rng = np.random.RandomState(0)
    S, K, D = 40, 4, 12
    g = _gauden(rng, S, K, D, n_proto=12)
    svq = build_subvq(g, n_sv=3, vqsize=16, n_iter=10)
    assert svq.map.shape == (S, K, 3)
    p = tmp_path / "model.subvq"
    write_subvq(str(p), svq)
    svq2 = read_subvq(str(p))
    assert svq2.n_sv == 3 and svq2.vqsize == 16
    np.testing.assert_array_equal(svq2.map, svq.map)
    for s in range(3):
        np.testing.assert_allclose(svq2.means[s], svq.means[s],
                                   rtol=2e-4, atol=2e-4)

    # Approximate scorer tracks the exact scorer (rank correlation).
    from cmusphinx_tpu.ops.gmm import ContinuousScorer
    import jax.numpy as jnp
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    exact = ContinuousScorer(g, lnw)
    approx = SubVQScorer(svq, lnw)
    x = jnp.asarray(rng.randn(8, D).astype(np.float32))
    a = np.asarray(exact.score(x))
    b = np.asarray(approx.score(x))
    # Approx scores correlate strongly with exact scores (per frame).
    for t in range(8):
        r = np.corrcoef(a[t], b[t])[0, 1]
        assert r > 0.7, r
    # Shortlist always contains the exact-best Gaussian of the best senone.
    sl = np.asarray(approx.shortlist(x, beam=50.0))
    assert sl.any(axis=(1, 2)).all()

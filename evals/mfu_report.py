"""MFU / roofline report for the hot stages.

Measures each stage's wall time on the device and divides it into the
analytic FLOP/byte counts from cmusphinx_tpu/utils/mfu.py; prints the
"stage | ms | GFLOP | MFU" table against the device's published peaks
(no utilization on the CPU).

    python evals/mfu_report.py [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


def timeit(f, reps=10):
    import jax
    jax.block_until_ready(f())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import GaussianParams, read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.ops.gmm import ContinuousScorer, PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config
    from cmusphinx_tpu.utils import mfu

    R = "/root/reference/pocketsphinx"
    H = R + "/model/hmm/en/tidigits"
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read(R + "/model/lm/en/tidigits.dic", mdef)
    lm = NgramModel.read(R + "/model/lm/en/tidigits.DMP")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl")
           if l.strip()]
    ceps = [read_mfc(R + f"/test/data/tidigits/{u}.mfc") for u in ctl]
    feats = [np.asarray(fp.compute(c)) for c in ceps]
    audio_s = sum(len(c) for c in ceps) * 0.01
    stages = []

    # --- 1. semi-continuous senone scoring (tidigits corpus, batched) ---
    X = jnp.asarray(np.concatenate(feats, 0))
    T = int(X.shape[0])
    sc = jax.jit(scorer.score)
    dt = timeit(lambda: sc(X))
    veclens = [len(sl) for sl in fp.stream_slices()]
    fl = mfu.psparity_flops(T, g.n_feat, g.n_density, veclens,
                            scorer.n_sen, 4)
    by = 4.0 * (T * X.shape[1] + T * scorer.n_sen) \
        + g.n_feat * g.n_density * (max(veclens) * 8.0) \
        + 1.0 * 4 * scorer.n_sen * g.n_density
    stages.append(mfu.Stage("senone scoring (s2 parity 8-bit, T=%d)" % T,
                            dt, fl, by))

    # --- 2. continuous GMM GEMM at hub4 scale, per -gmmprec mode ---
    rng = np.random.RandomState(0)
    S_, K_, D_ = 5150, 32, 39
    means = rng.randn(S_, 1, K_, D_).astype(np.float32)
    var = (0.5 + rng.rand(S_, 1, K_, D_)).astype(np.float32)
    gp = GaussianParams(means=means, var=var, prec=1.0 / (2 * var),
                        lrd=-0.5 * np.log(var).sum(-1).astype(np.float32),
                        veclen=[D_], n_mgau=S_, n_feat=1, n_density=K_)
    lnw = np.log(np.full((S_, K_), 1.0 / K_, np.float32))
    Xc = jnp.asarray(rng.randn(5395, D_).astype(np.float32))
    Tc = int(Xc.shape[0])
    fl = mfu.continuous_gmm_flops(Tc, S_, K_, D_)
    for precision in ("highest", "high", "bf16"):
        f = jax.jit(ContinuousScorer(gp, lnw, precision=precision).score)
        dt = timeit(lambda: f(Xc))
        by = mfu.continuous_gmm_bytes(Tc, S_, K_, D_)
        if precision == "bf16":  # params are half-width
            by -= 2.0 * D_ * S_ * K_ * 2
        stages.append(mfu.Stage(
            "cont GMM %s (S=5150 K=32)" % precision, dt, fl, by))

    # --- 3. tidigits headline decode (fused cep->decode) ---
    search = NgramSearch(lm, d, mdef, tmat, scorer)
    search.decode_batch_cep(ceps, fp)
    dt = timeit(lambda: search.decode_batch_cep(ceps, fp), reps=5)
    gr = search.graph
    # model FLOPs = senone scoring; the one-hot matmul lookups of the scan
    # are search bookkeeping, counted separately.
    Tpad = sum(-(-len(c) // search.FRAME_BUCKET) * search.FRAME_BUCKET
               for c in [max(ceps, key=len)]) * 0 + \
        -(-max(len(c) for c in ceps) // search.FRAME_BUCKET) * \
        search.FRAME_BUCKET
    B = len(ceps)
    fl = mfu.psparity_flops(B * Tpad, g.n_feat, g.n_density, veclens,
                            scorer.n_sen, 4)
    by = mfu.viterbi_scan_bytes(Tpad, gr.n_chan, gr.n_emit_state, B)
    stages.append(mfu.Stage(
        "tidigits e2e decode (%.1fs audio, %.0fx RT)"
        % (audio_s, audio_s / dt), dt, fl, by,
        note="model FLOPs = senone GEMMs"))

    dev = jax.devices()[0]
    peaks = mfu.device_peaks(dev)
    print()
    print(mfu.report(stages, peaks))
    print()
    print(f"device: {dev.device_kind}"
          + (f"; peaks from {peaks.source}" if peaks else ""))
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

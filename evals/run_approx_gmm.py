#!/usr/bin/env python
"""Approximate-GMM verdict bench: measure each reference fast-GMM trick
on the device against the dense baseline, on the repo-trained CD-tied
continuous tidigits model (evals/cd_tidigits.py).

Reference layer: sphinx3 approx_cont_mgau.c:108-276 (ds_ratio frame
downsampling, CIGMMS CI-driven CD bypass, subvq shortlists).  The claim
to test: on the device the dense evaluation is a pair of GEMMs, so shortlist
bookkeeping mostly costs accuracy without buying speed — except frame
downsampling, which removes whole frames of GEMM work.

Writes one verdict row per trick: scorer ms, decode WER, keep/reject.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np

from run_tidigits_fsg import wer
import cd_tidigits


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--model", default="/tmp/tidigits_cd_model")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.ops.approx import CigmmsScorer, DownsampledScorer
    from cmusphinx_tpu.ops.gmm import ContinuousScorer

    cd_tidigits.train_and_export(args.model)
    p = cd_tidigits.load_decoder_parts(args.model)
    mdef, g, lnw = p["mdef"], p["gauden"], p["lnw"]
    S, K = lnw.shape[0], g.n_density
    print(f"model: {S} senones x {K} Gaussians, "
          f"{mdef.n_ci_sen} CI senones", flush=True)

    dense = ContinuousScorer(g, lnw)
    variants = [
        ("dense (baseline)", dense),
        ("ds_ratio=2", DownsampledScorer(dense, 2)),
        ("ds_ratio=3", DownsampledScorer(dense, 3)),
        ("cigmms beam=7", CigmmsScorer(dense, mdef.cd2cisen,
                                       mdef.n_ci_sen, 7.0)),
        ("cigmms beam=3", CigmmsScorer(dense, mdef.cd2cisen,
                                       mdef.n_ci_sen, 3.0)),
    ]
    try:
        from cmusphinx_tpu.ops.approx import GsSelectorScorer
        variants.append(("gs selector (64c, top2)",
                         GsSelectorScorer(dense, g, 64, 2)))
    except Exception as e:
        print(f"(gs variant skipped: {e})")
    try:
        from cmusphinx_tpu.ops.approx import KdTreeSelectorScorer
        variants.append(("kdtree BBI (depth 6, r=3.0)",
                         KdTreeSelectorScorer(dense, g, depth=6,
                                              radius=3.0)))
    except Exception as e:
        print(f"(kdtree variant skipped: {e})")
    try:
        from cmusphinx_tpu.ops.subvq import SubVQScorer, build_subvq
        svq = build_subvq(g, n_sv=3, vqsize=64, n_iter=10, n_restarts=1)
        variants.append(("subvq approx (3x64)", SubVQScorer(svq, lnw)))
    except Exception as e:  # subvq builder is optional here
        print(f"(subvq variant skipped: {e})")

    feats, utts, lsn = p["feats"], p["utts"], p["lsn"]
    X = jnp.asarray(np.concatenate(feats, 0))
    audio = sum(f.shape[0] for f in feats) * 0.01

    def bench(f):
        jax.block_until_ready(f(X))
        ts = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            jax.block_until_ready(f(X))
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3

    print(f"\n| variant | scorer ms (T={X.shape[0]}) | WER | decode xRT | "
          f"verdict |")
    print("|---|---|---|---|---|")
    base_wer = None
    rows = []
    for name, sc in variants:
        ms = bench(sc.score)
        search = NgramSearch(p["lm"], p["d"], mdef, p["tmat"], sc)
        hyps = search.decode_batch(feats)
        t0 = time.time()
        for _ in range(3):
            hyps = search.decode_batch(feats)
        steady = (time.time() - t0) / 3
        errs = tot = 0
        for u, h in zip(utts, hyps):
            e, n = wer(" ".join(lsn[u]).upper(), h.text.upper())
            errs += e
            tot += n
        pct = 100.0 * errs / tot
        if base_wer is None:
            base_wer = pct
            verdict = "—"
        else:
            faster = ms < rows[0][1] * 0.9
            worse = pct > base_wer + 1e-9
            verdict = ("KEEP (speed for accuracy)" if faster and worse else
                       "keep (free)" if faster else
                       "REJECT (no gain" + (", worse WER)" if worse
                                            else ")"))
        rows.append((name, ms, pct))
        print(f"| {name} | {ms:.2f} | {pct:.2f}% ({errs}/{tot}) | "
              f"{audio/steady:.0f}x | {verdict} |", flush=True)
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

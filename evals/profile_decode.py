#!/usr/bin/env python
"""Per-stage timing breakdown of the decode path (VERDICT r2 item 1).

Splits the tidigits bench (and optionally the wsj5k eval path) into stages
and times each in steady state on the real chip:

  feat      host feature pipeline (numpy+XLA, amortized over corpus)
  score     senone scoring alone   (jit scorer.score on the padded batch)
  scan      full device decode     (scoring + Viterbi scan + tape readout)
  viterbi   scan - score           (the search scan itself)
  host      backtrace + (optional) lattice/bestpath Python

Usage:  python evals/profile_decode.py [--cpu] [--wsj] [--repeat N]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def timeit(fn, repeat=5):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(repeat):
        out = fn()
    return (time.perf_counter() - t0) / repeat, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--wsj", action="store_true")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--trace", default="", help="JAX profiler trace dir")
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
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    R = "/root/reference/pocketsphinx"
    if args.wsj:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from run_wsj5k import WSJ, H, build_lm, build_vocab, write_subset_dict
        vocab = build_vocab(5000)
        write_subset_dict(vocab, "/tmp/wsj5k.dic")
        mdef = Mdef.read(H + "/mdef")
        g = read_gauden(H + "/means", H + "/variances")
        w, meta = read_sendump(H + "/sendump", return_raw=True)
        tmat = TransitionMatrices.read(H + "/transition_matrices")
        d = Dictionary.read("/tmp/wsj5k.dic", mdef,
                            filler_path=H + "/noisedict")
        lm = build_lm(vocab, "n800")
        cfg = Config(FE_ARGS, FEAT_ARGS)
        cfg.update_from_file(H + "/feat.params")
        fp = FeatPipeline(cfg)
        scorer = PsParityScorer(g, w, fp.stream_slices(),
                                wrap_uint8=meta["n_bits"] == 4)
        search = NgramSearch(lm, d, mdef, tmat, scorer, rcmode="composite",
                             lw=7.5, wip=0.5, beam=1e-60, wbeam=1e-40)
        ctl = [l.strip() for l in open(f"{WSJ}/test5k.s1.ctl")]
        mfcdir = WSJ
    else:
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
        search = NgramSearch(lm, d, mdef, tmat, scorer)
        ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl")
               if l.strip()]
        mfcdir = R + "/test/data/tidigits"

    gr = search.graph
    print(f"graph[{gr.rc_mode}]: {gr.n_chan} chan, {gr.n_xs} xs "
          f"({gr.n_sing} sing), n_rcvar={gr.n_rcvar}, E={search.E}, "
          f"W={search.vocab.n_word}, n_sen={scorer.n_sen}")

    t0 = time.perf_counter()
    feats = [np.asarray(fp.compute(read_mfc(f"{mfcdir}/{u}.mfc")))
             for u in ctl]
    t_feat = time.perf_counter() - t0
    Ts = [f.shape[0] for f in feats]
    audio_s = sum(Ts) * 0.01
    D = feats[0].shape[1]
    FB = search.FRAME_BUCKET
    Tmax = -(-max(Ts) // FB) * FB
    B = len(feats)
    fpad = np.zeros((B, Tmax, D), np.float32)
    for i, f in enumerate(feats):
        fpad[i, : Ts[i]] = f
    valid = np.arange(Tmax)[None, :] < np.asarray(Ts)[:, None]
    dfeats, dvalid = jnp.asarray(fpad), jnp.asarray(valid)
    print(f"B={B} utts, Tmax={Tmax}, audio={audio_s:.1f}s, "
          f"feat host time {t_feat:.3f}s (one-shot)")

    # --- stage: scoring alone ---
    score_fn = jax.jit(jax.vmap(search.scorer.score))
    t_score, _ = timeit(
        lambda: jax.block_until_ready(score_fn(dfeats)), args.repeat)

    # --- stage: full device decode ---
    dec_fn = jax.jit(jax.vmap(search.device_decode))
    t_scan, tapes = timeit(
        lambda: jax.block_until_ready(dec_fn(dfeats, dvalid)), args.repeat)

    # --- stage: host transfer + backtrace ---
    def host_side():
        htapes = jax.device_get(tapes)
        hyps = []
        for i in range(B):
            tape = tuple(np.asarray(a[i]) for a in htapes)
            hyps.append(search._backtrace(*tape, Ts[i]))
        return hyps
    t_host, hyps = timeit(host_side, args.repeat)

    # --- stage: lattice + bestpath per utt ---
    def lat_side():
        htapes = jax.device_get(tapes)
        outs = []
        for i in range(B):
            tape = tuple(np.asarray(a[i]) for a in htapes)
            search._last = tape + (Ts[i],)
            lat = search.get_lattice()
            outs.append(lat.bestpath(lw=float(search.config["bestpathlw"]),
                                     start_lmwid=search.start_lmwid))
        return outs
    try:
        t_lat, _ = timeit(lat_side, max(1, args.repeat // 2))
    except Exception as e:  # noqa: BLE001
        t_lat = float("nan")
        print("lattice stage failed:", e)

    if args.trace:
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(dec_fn(dfeats, dvalid))
        print("trace written to", args.trace)

    t_vit = t_scan - t_score
    print(f"\n--- steady-state per-corpus ({audio_s:.1f}s audio) ---")
    for name, t in [("score (senone GEMM+topN+logadd)", t_score),
                    ("scan  (score+viterbi+tape)", t_scan),
                    ("viterbi (scan - score)", t_vit),
                    ("host  (D2H + backtrace)", t_host),
                    ("lattice+bestpath (host)", t_lat)]:
        print(f"{name:34s} {t*1e3:9.1f} ms   {audio_s/t:8.1f}x RT")
    total = t_scan + t_host
    print(f"{'TOTAL (scan + host)':34s} {total*1e3:9.1f} ms   "
          f"{audio_s/total:8.1f}x RT")
    n_steps = Tmax
    print(f"per-frame-step: {t_vit/n_steps*1e6:.0f} us "
          f"(viterbi, Tmax={n_steps} steps)")


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    main()

#!/usr/bin/env python
"""TIDIGITS N-gram batch decode — mirrors the reference regression
pocketsphinx/test/regression/test-tidigits-simple.sh (shipped tidigits model +
tidigits.DMP LM over the shipped .mfc cepstra), reporting sentence accuracy
and WER against tidigits.lsn and agreement with the committed golden
test-tidigits-simple.match."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from run_tidigits_fsg import wer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

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
    scorer = PsParityScorer(g, w, fp.stream_slices(), wrap_uint8=meta["n_bits"] == 4)
    search = NgramSearch(lm, d, mdef, tmat, scorer)
    print(f"graph: {search.graph.n_chan} channels / {search.graph.n_word} words",
          flush=True)

    lsn = {}
    for line in open(R + "/test/data/tidigits/tidigits.lsn"):
        parts = line.split()
        lsn[parts[-1].strip("()")] = " ".join(parts[:-1])
    golden = {}
    for line in open(R + "/test/data/tidigits/test-tidigits-simple.match"):
        parts = line.split()
        golden[parts[-2].strip("()")] = " ".join(parts[:-2])
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl") if l.strip()]
    if args.limit:
        ctl = ctl[: args.limit]

    n_sent_ok = n_match_golden = 0
    n_err = n_ref = 0
    g_err = 0
    total_frames = 0
    t0 = time.time()
    for utt in ctl:
        cep = read_mfc(R + f"/test/data/tidigits/{utt}.mfc")
        feats = np.asarray(fp.compute(cep))
        hyp = search.decode(feats)
        ref = lsn.get(utt, "")
        ok = hyp.text == ref
        n_sent_ok += ok
        n_match_golden += hyp.text == golden.get(utt, "")
        e, n = wer(ref, hyp.text)
        n_err += e
        n_ref += n
        ge, _ = wer(ref, golden.get(utt, ""))
        g_err += ge
        total_frames += len(feats)
        mark = "OK" if ok else ("=golden" if hyp.text == golden.get(utt, "") else "WRONG")
        print(f"{utt}: {hyp.text!r} want {ref!r} {mark}", flush=True)
    dt = time.time() - t0
    audio_s = total_frames * 0.01
    print(f"\nsentence correct: {n_sent_ok}/{len(ctl)}; golden agreement "
          f"{n_match_golden}/{len(ctl)}")
    print(f"WER: {100.0 * n_err / max(n_ref, 1):.2f}% ({n_err}/{n_ref}); "
          f"reference golden WER: {100.0 * g_err / max(n_ref, 1):.2f}% ({g_err}/{n_ref})")
    print(f"decode: {dt:.1f}s for {audio_s:.1f}s audio -> {audio_s / dt:.1f}x RT")


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    main()

#!/usr/bin/env python
"""TIDIGITS FSG batch decode — mirrors the reference regression
pocketsphinx/test/regression/test-tidigits-fsg.sh (shipped tidigits model +
tidigits.fsg grammar over the shipped .mfc cepstra), reporting sentence
accuracy and WER against tidigits.lsn.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def wer(ref, hyp):
    """Levenshtein word error count (word_align.pl capability)."""
    r, h = ref.split(), hyp.split()
    d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (r[i - 1] != h[j - 1]))
    return int(d[len(r), len(h)]), len(r)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from cmusphinx_tpu.decode import FsgSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.fsg import FsgModel
    from cmusphinx_tpu.models.gauden import read_gauden
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
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(), wrap_uint8=meta["n_bits"] == 4)
    fsg = FsgModel.read(R + "/model/lm/en/tidigits.fsg")
    search = FsgSearch(fsg, d, mdef, tmat, scorer)
    print(f"graph: {search.graph.n_chan} channels, {search.n_link} links",
          flush=True)

    lsn = {}
    for line in open(R + "/test/data/tidigits/tidigits.lsn"):
        parts = line.split()
        lsn[parts[-1].strip("()")] = " ".join(parts[:-1])
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl") if l.strip()]
    if args.limit:
        ctl = ctl[: args.limit]

    n_sent_ok = 0
    n_err = n_ref = 0
    total_frames = 0
    t0 = time.time()
    for utt in ctl:
        cep = read_mfc(R + f"/test/data/tidigits/{utt}.mfc")
        feats = np.asarray(fp.compute(cep))
        hyp = search.decode(feats)
        ref = lsn.get(utt, "")
        ok = hyp.text == ref
        n_sent_ok += ok
        e, n = wer(ref, hyp.text)
        n_err += e
        n_ref += n
        total_frames += len(feats)
        print(f"{utt}: {hyp.text!r} want {ref!r} {'OK' if ok else 'WRONG'}",
              flush=True)
    dt = time.time() - t0
    audio_s = total_frames * 0.01
    print(f"\nsentence correct: {n_sent_ok}/{len(ctl)}")
    print(f"WER: {100.0 * n_err / max(n_ref, 1):.2f}% ({n_err}/{n_ref})")
    print(f"decode: {dt:.1f}s for {audio_s:.1f}s audio -> {audio_s / dt:.1f}x RT")


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    main()

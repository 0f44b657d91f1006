#!/usr/bin/env python
"""goforward.raw N-gram decode — mirrors the reference smoke test
(pocketsphinx test/unit decode of goforward.raw with the hub4wsj_sc_8k model
and turtle LM; expected hypothesis "go forward ten meters")."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS, Frontend
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.config import Config

    R = "/root/reference/pocketsphinx"
    H = R + "/model/hmm/en_US/hub4wsj_sc_8k"
    t0 = time.time()
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read(R + "/model/lm/en/turtle.dic", mdef,
                        filler_path=H + "/noisedict")
    lm = NgramModel.read(R + "/model/lm/en/turtle.DMP")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fe = Frontend(cfg)
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(), wrap_uint8=meta["n_bits"] == 4)
    search = NgramSearch(lm, d, mdef, tmat, scorer)
    print(f"load: {time.time() - t0:.1f}s; graph {search.graph.n_chan} channels "
          f"/ {search.graph.n_word} words", flush=True)

    raw = np.frombuffer(open(R + "/test/data/goforward.raw", "rb").read(),
                        np.int16).astype(np.float32)
    cep = np.asarray(fe.process(raw))
    feats = np.asarray(fp.compute(cep))
    t0 = time.time()
    hyp = search.decode(feats)
    dt = time.time() - t0
    print(f"hyp: {hyp.text!r} (score {hyp.score:.1f})")
    print(f"segs: {[(s.word, s.start_frame, s.end_frame) for s in hyp.segments]}")
    print(f"decode: {dt:.2f}s for {len(feats) * 0.01:.2f}s audio "
          f"(incl. compile)")
    ok = hyp.text == "go forward ten meters"
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

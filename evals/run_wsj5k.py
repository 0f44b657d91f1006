#!/usr/bin/env python
"""WSJ 5k-vocabulary batch decode — the large-vocabulary scale eval.

Decodes the shipped WSJ test set (reference:
pocketsphinx/test/data/wsj/test5k.s1.{ctl,lsn}, 7 utterances with committed
.mfc cepstra) with the hub4wsj_sc_8k semi-continuous model (5150 senones), a
5,000-word dictionary drawn from cmu07a.dic, and a trigram LM built with the
repo's own cmuclmtk-parity toolkit (the reference's wsj0vp.5000.DMP LM is not
in the checkout).  Reference config: pocketsphinx/regression/wsj1_test5k.sh
(-lw 7.5 -wip 0.5 -beam 1e-60 -wbeam 1e-40).

LM conditions (--lm):
  n800  trigram estimated from the test5k.n800 transcripts — 7 DIFFERENT
        sentences from the same WSJ domain (no test-sentence leakage), with
        a count-1 unigram floor over the full 5k vocabulary.  Default.
  tri   trigram from all 14 shipped WSJ transcripts including the test
        sentences — an optimistic ceiling (LM has seen the answers).
  ug    uniform unigram over the 5k vocabulary — no LM help at all; pure
        5k-way acoustic search stress test.

Reports WER vs test5k.s1.lsn, steady-state xRT, and the graph/memory story.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from run_tidigits_fsg import wer

WSJ = "/root/reference/pocketsphinx/test/data/wsj"
R = "/root/reference/pocketsphinx"
H = R + "/model/hmm/en_US/hub4wsj_sc_8k"
DIC = R + "/model/lm/en_US/cmu07a.dic"


def read_lsn(path):
    out = {}
    for line in open(path):
        line = line.strip()
        if not line:
            continue
        text, _, uid = line.rpartition("(")
        out[uid.strip(") ")] = [w for w in text.split()
                                if w not in ("<s>", "</s>", "<sil>")]
    return out


def build_vocab(n_words=5000):
    """Transcript words + padding from cmu07a.dic, n_words total."""
    words = set()
    for lsn in ("test5k.s1.lsn", "test5k.n800.lsn"):
        for sent in read_lsn(f"{WSJ}/{lsn}").values():
            words.update(w.lower() for w in sent)
    order, seen = [], set()
    for line in open(DIC, errors="replace"):
        p = line.split()
        if p and "(" not in p[0] and p[0] not in seen:
            order.append(p[0])
            seen.add(p[0])
    vocab = sorted(words & seen)
    assert len(words - seen) == 0, f"missing from dict: {words - seen}"
    for w in order:
        if len(vocab) >= n_words:
            break
        if w not in words:
            vocab.append(w)
    return vocab


def write_subset_dict(vocab, path):
    keep = set(vocab)
    with open(path, "w") as out:
        for line in open(DIC, errors="replace"):
            p = line.split()
            if p and p[0].split("(")[0] in keep:
                out.write(line)


def build_lm(vocab, kind):
    from cmusphinx_tpu.lm.estimate import count_ngrams, estimate_lm
    if kind == "tri":
        sents = [[w.lower() for w in s]
                 for lsn in ("test5k.s1.lsn", "test5k.n800.lsn")
                 for s in read_lsn(f"{WSJ}/{lsn}").values()]
    elif kind == "n800":
        sents = [[w.lower() for w in s]
                 for s in read_lsn(f"{WSJ}/test5k.n800.lsn").values()]
    else:  # ug
        sents = []
    counts, words = count_ngrams(sents, vocab, n=3)
    wid = {w: i for i, w in enumerate(words)}
    for w in vocab:  # unigram floor: every vocab word reachable
        counts[0].setdefault((wid[w],), 0)
        counts[0][(wid[w],)] += 1
    return estimate_lm(counts, words, discount="witten_bell")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--lm", default="n800", choices=["n800", "tri", "ug"])
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("--rcmode", default="composite")
    ap.add_argument("--lexmode", default="flat", choices=["flat", "tree"])
    ap.add_argument("--nlextree", type=int, default=1)
    ap.add_argument("--maxwpf", type=int, default=32)
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed steady-state decode repetitions")
    ap.add_argument("--bestpath", action="store_true",
                    help="rescore over the word lattice (ps -bestpath)")
    ap.add_argument("--lw", type=float, default=7.5)
    ap.add_argument("--bestpathlw", type=float, default=8.5,
                    help="lattice rescoring language weight.  The reference "
                         "script uses 11.5 (wsj1_test5k.sh) — tuned for the "
                         "real wsj0vp.5000.DMP trigram, which is absent from "
                         "the checkout; with the data-poor n800 LM the "
                         "measured optimum is 7.5-8.5 (see EVALS.md sweep: "
                         "heavier weights amplify LM-data poverty and "
                         "degrade WER)")
    ap.add_argument("--wbeam", type=float, default=1e-40)
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
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    t0 = time.time()
    vocab = build_vocab(args.vocab)
    write_subset_dict(vocab, "/tmp/wsj5k.dic")
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read("/tmp/wsj5k.dic", mdef, filler_path=H + "/noisedict")
    lm = build_lm(vocab, args.lm)
    print(f"vocab {len(vocab)} words; dict {d.n_word} entries; "
          f"LM[{args.lm}] {lm.n_words} words, {len(lm.bg_wid)} bigrams, "
          f"{len(lm.tg_wid)} trigrams  ({time.time()-t0:.1f}s)", flush=True)

    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    t0 = time.time()
    search = NgramSearch(lm, d, mdef, tmat, scorer, rcmode=args.rcmode,
                         lexmode=args.lexmode, nlextree=args.nlextree,
                         lw=args.lw, wip=0.5, beam=1e-60, wbeam=args.wbeam,
                         maxwpf=args.maxwpf, bestpathlw=args.bestpathlw,
                         latbeam=1e-40)
    gr = search.graph
    print(f"graph[{gr.rc_mode}]: {gr.n_chan} channels, {gr.n_xs} xs rows "
          f"({gr.n_sing} singleton + {gr.n_xs - gr.n_sing} composite, "
          f"U={gr.comp_mem.shape[-1]}), {gr.n_rcvar} rc variants, "
          f"lcmap {gr.lcmap.shape}  ({time.time()-t0:.1f}s)", flush=True)
    const_mb = (gr.n_chan * gr.n_emit_state * (gr.n_emit_state + 1) * 4
                + gr.sing_sen.nbytes + gr.comp_mem.nbytes
                + gr.lcmap.nbytes) / 1e6
    carry_mb = gr.n_chan * gr.n_emit_state * 12 / 1e6
    print(f"device tables ~{const_mb:.0f} MB, scan carry ~{carry_mb:.0f} MB "
          f"(linear in vocab: 60k words ~ {12 * const_mb:.0f} MB tables)")

    refs = read_lsn(f"{WSJ}/test5k.s1.lsn")
    utts = [line.strip() for line in open(f"{WSJ}/test5k.s1.ctl")]
    feats = []
    for u in utts:
        cep = read_mfc(f"{WSJ}/{u}.mfc")
        feats.append(np.asarray(fp.compute(cep)))
    audio_s = sum(f.shape[0] for f in feats) * 0.01

    t0 = time.time()
    hyps = search.decode_batch(feats)
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(args.repeat):
        hyps = search.decode_batch(feats)
    steady = (time.time() - t0) / args.repeat
    if args.bestpath:
        t0 = time.time()
        hyps = search.decode_batch(feats, bestpath=True)
        bp_s = time.time() - t0
        print(f"bestpath pass: {bp_s:.1f}s wall (Viterbi+lattice+rescore)")

    errs = tot = 0
    for u, hyp in zip(utts, hyps):
        ref = " ".join(refs[u])
        e, n = wer(ref, hyp.text.lower())
        errs += e
        tot += n
        print(f"{u}: {hyp.text.lower()!r}")
        print(f"   ref: {ref!r}  ({e}/{n} errs)")
    print(f"\nWER[{args.lm}]: {100.0 * errs / tot:.2f}% ({errs}/{tot})")
    print(f"audio {audio_s:.1f}s; first decode {compile_s:.1f}s (incl. "
          f"compile); steady {steady:.2f}s = {audio_s / steady:.1f}x RT "
          f"({steady / audio_s:.3f} xRT)")
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

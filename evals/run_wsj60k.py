#!/usr/bin/env python
"""WSJ 60k+ vocabulary decode — the HUB4-class large-vocabulary scale proof.

Builds the search graph over the FULL cmu07a.dic (133k entries / 123k base
words — larger than the reference's 60k HUB4 vocabulary), with either the
prefix-shared lexicon tree (default; ngram_search_fwdtree.c:67-149 /
sphinx3 lextree capability, re-expressed dense) or flat per-word chains
(--lexmode flat), and decodes the 7 shipped WSJ utterances.

The LM is a trigram over all 14 shipped WSJ transcripts with a count-1
unigram floor over the full vocabulary (the reference's HUB4 trigram is not
in the checkout) — so the task is a genuine 123k-way open search where
almost all probability mass sits on the floor.  Reports channel counts,
device-table HBM, WER and xRT.  Reference rows: HUB4 60k S3.3 18.8% WER @
3.06 xRT (sphinx4/index.html:375-505, BASELINE.md); histogram pruning
srch_time_switch_tree.c:396.
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
from run_wsj5k import DIC, H, WSJ, read_lsn


def full_vocab(limit=0):
    order, seen = [], set()
    for line in open(DIC, errors="replace"):
        p = line.split()
        if p and "(" not in p[0] and p[0] not in seen:
            order.append(p[0])
            seen.add(p[0])
            if limit and len(order) >= limit:
                break
    return order


def build_floor_lm(vocab, kind="tri"):
    """kind='tri': trigram over all 14 shipped transcripts INCLUDING the
    test sentences (optimistic ceiling); 'n800': the 7 held-out sentences
    only (no test leakage).  Both floored with count-1 unigrams over the
    full vocabulary so every word is reachable."""
    from cmusphinx_tpu.lm.estimate import count_ngrams, estimate_lm
    lsns = (("test5k.s1.lsn", "test5k.n800.lsn") if kind == "tri"
            else ("test5k.n800.lsn",))
    sents = [[w.lower() for w in s]
             for lsn in lsns
             for s in read_lsn(f"{WSJ}/{lsn}").values()]
    counts, words = count_ngrams(sents, vocab, n=3)
    wid = {w: i for i, w in enumerate(words)}
    for w in vocab:
        counts[0].setdefault((wid[w],), 0)
        counts[0][(wid[w],)] += 1
    return estimate_lm(counts, words, discount="witten_bell")


def inflate_lm(m, n_bg: int, n_tg: int, seed: int = 0) -> None:
    """Grow the LM to production size (sphinx4 LargeTrigramModel-class:
    millions of n-grams) by merging in random BALLAST n-grams at a log
    probability (-25 nats) far below every real backoff path — the
    decoder's scores and hypotheses stay those of the real LM while every
    lookup must navigate the full-size tables.  This is a capacity/speed
    proof; the checkout ships no real broadcast-news trigram."""
    rng = np.random.RandomState(seed)
    V = m.n_words
    BAL = np.float32(-25.0)
    bg_w1 = np.repeat(np.arange(V), np.diff(m.bg_ptr)).astype(np.int64)
    pairs = np.concatenate(
        [np.stack([bg_w1, np.asarray(m.bg_wid, np.int64)], 1),
         rng.randint(0, V, (n_bg, 2)).astype(np.int64)])
    probs = np.concatenate([np.asarray(m.bg_prob),
                            np.full(n_bg, BAL, np.float32)])
    bos = np.concatenate([np.asarray(m.bg_bo) if len(m.bg_bo)
                          else np.zeros(len(bg_w1), np.float32),
                          np.zeros(n_bg, np.float32)])
    key = pairs[:, 0] * V + pairs[:, 1]
    _, idx = np.unique(key, return_index=True)   # real entries come first
    idx.sort()
    pairs, probs, bos = pairs[idx], probs[idx], bos[idx]
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs, probs, bos = pairs[order], probs[order], bos[order]
    # map old trigram rows -> new row ids BEFORE overwriting the tables
    old_rows = np.searchsorted(
        pairs[:, 0] * V + pairs[:, 1],
        bg_w1 * V + np.asarray(m.bg_wid, np.int64))
    m.bg_wid = pairs[:, 1].astype(np.int32)
    m.bg_ptr = np.searchsorted(pairs[:, 0],
                               np.arange(V + 1)).astype(np.int64)
    m.bg_prob, m.bg_bo = probs, bos
    nb = len(m.bg_wid)
    # trigrams: remap the real ones, add ballast under random rows
    tg_rows_old = np.repeat(np.arange(len(old_rows)),
                            np.diff(m.tg_ptr)).astype(np.int64)
    tkeys = np.concatenate(
        [np.stack([old_rows[tg_rows_old],
                   np.asarray(m.tg_wid, np.int64)], 1),
         np.stack([rng.randint(0, nb, n_tg).astype(np.int64),
                   rng.randint(0, V, n_tg).astype(np.int64)], 1)])
    tprobs = np.concatenate([np.asarray(m.tg_prob),
                             np.full(n_tg, BAL, np.float32)])
    tk = tkeys[:, 0] * V + tkeys[:, 1]
    _, idx = np.unique(tk, return_index=True)
    idx.sort()
    tkeys, tprobs = tkeys[idx], tprobs[idx]
    order = np.lexsort((tkeys[:, 1], tkeys[:, 0]))
    tkeys, tprobs = tkeys[order], tprobs[order]
    m.tg_wid = tkeys[:, 1].astype(np.int32)
    m.tg_ptr = np.searchsorted(tkeys[:, 0],
                               np.arange(nb + 1)).astype(np.int64)
    m.tg_prob = tprobs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--lexmode", default="tree", choices=["tree", "flat"])
    ap.add_argument("--vocab", type=int, default=0,
                    help="limit vocabulary (0 = full cmu07a)")
    ap.add_argument("--maxwpf", type=int, default=32)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--lm", default="tri", choices=["tri", "n800", "big"])
    ap.add_argument("--nlextree", type=int, default=1)
    ap.add_argument("--bestpath", action="store_true")
    ap.add_argument("--bestpathlw", type=float, default=7.5)
    ap.add_argument("--ballast-bg", type=int, default=2_000_000)
    ap.add_argument("--ballast-tg", type=int, default=3_000_000)
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
    vocab = full_vocab(args.vocab)
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    dic_path = DIC
    if args.vocab:
        from run_wsj5k import write_subset_dict
        write_subset_dict(vocab, "/tmp/wsj60k.dic")
        dic_path = "/tmp/wsj60k.dic"
    d = Dictionary.read(dic_path, mdef, filler_path=H + "/noisedict")
    if args.lm == "big":
        lm = build_floor_lm(vocab, "tri")
        inflate_lm(lm, args.ballast_bg, args.ballast_tg)
    else:
        lm = build_floor_lm(vocab, args.lm)
    print(f"vocab {len(vocab)} base words; dict {d.n_word} entries; "
          f"LM {lm.n_words} words / {len(lm.bg_wid)} bigrams / "
          f"{len(lm.tg_wid)} trigrams  ({time.time()-t0:.0f}s)", flush=True)

    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    t0 = time.time()
    search = NgramSearch(lm, d, mdef, tmat, scorer, rcmode="composite",
                         lcmode="composite", lexmode=args.lexmode,
                         nlextree=args.nlextree,
                         lw=7.5, wip=0.5, beam=1e-60, wbeam=1e-40,
                         maxwpf=args.maxwpf, bestpathlw=args.bestpathlw,
                         latbeam=1e-40)
    gr = search.graph
    S = gr.n_emit_state
    print(f"graph[{gr.lex_mode}]: {gr.n_chan} channels "
          f"({gr.n_chan * 1.0 / search.vocab.n_word:.1f}/word), "
          f"{gr.n_xs} xs rows, built in {time.time()-t0:.0f}s", flush=True)
    const_mb = (gr.n_chan * S * (S + 1) * 4 + gr.sing_sen.nbytes
                + gr.comp_mem.nbytes + gr.lcmap.nbytes
                + gr.rssid.nbytes * 2) / 1e6
    carry_mb = gr.n_chan * S * 16 / 1e6
    print(f"device tables ~{const_mb:.0f} MB, scan carry ~{carry_mb:.0f} MB")

    refs = read_lsn(f"{WSJ}/test5k.s1.lsn")
    utts = [line.strip() for line in open(f"{WSJ}/test5k.s1.ctl")]
    feats = [np.asarray(fp.compute(read_mfc(f"{WSJ}/{u}.mfc")))
             for u in utts]
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
        print(f"bestpath pass: {time.time()-t0-steady:.1f}s extra wall")

    errs = tot = 0
    for u, hyp in zip(utts, hyps):
        ref = " ".join(refs[u])
        e, n = wer(ref, hyp.text.lower())
        errs += e
        tot += n
        print(f"{u}: {hyp.text.lower()!r}")
    print(f"\nWER[{args.lexmode}, {args.lm}, {len(vocab)} words]: "
          f"{100.0 * errs / tot:.2f}% ({errs}/{tot})")
    print(f"audio {audio_s:.1f}s; first decode {compile_s:.1f}s (incl. "
          f"compile); steady {steady:.2f}s = {audio_s / steady:.1f}x RT "
          f"({steady / audio_s:.3f} xRT)")
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

#!/usr/bin/env python
"""Regenerate EVALS.md — the committed evaluation ledger.

One table per task, WER + xRT + config, regenerated end-to-end on the
device wherever the reference tree (shipped models and test audio) is
available.  Covers:

- tidigits N-gram batch decode (the bench.py config) + rcmode comparison
  (fanout vs composite cross-word right contexts)
- goforward + turtle-LM smoke decode
- WSJ 5k x {n800, tri, ug} LM conditions x {Viterbi, +bestpath}
- bestpathlw sweep and lw/wip sweep on WSJ n800
- WSJ n800 error analysis: how much of the WER gap is LM-data poverty
  (the reference's wsj0vp.5000.DMP is absent from the checkout)

Reference harnesses mirrored: pocketsphinx/regression/wsj1_test5k.sh,
test-tidigits-*.sh, sphinx3 src/tests/performance/* ref.log ledgers.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from run_tidigits_fsg import wer
from run_wsj5k import WSJ, H, DIC, build_lm, build_vocab, read_lsn, \
    write_subset_dict

R = "/root/reference/pocketsphinx"


def wer_of(pairs):
    errs = tot = 0
    for ref, hyp in pairs:
        e, n = wer(ref, hyp)
        errs += e
        tot += n
    return errs, tot, (100.0 * errs / tot if tot else 0.0)


def load_tidigits(rcmode="auto"):
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

    H = R + "/model/hmm/en/tidigits"
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    from cmusphinx_tpu.models import TransitionMatrices
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read(R + "/model/lm/en/tidigits.dic", mdef)
    lm = NgramModel.read(R + "/model/lm/en/tidigits.DMP")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    search = NgramSearch(lm, d, mdef, tmat, scorer, rcmode=rcmode)
    lsn = {}
    for line in open(R + "/test/data/tidigits/tidigits.lsn"):
        p = line.split()
        lsn[p[-1].strip("()")] = " ".join(p[:-1])
    ctl = [l.strip() for l in open(R + "/test/data/tidigits/tidigits.ctl")
           if l.strip()]
    feats = [np.asarray(fp.compute(read_mfc(
        R + f"/test/data/tidigits/{u}.mfc"))) for u in ctl]
    return search, feats, ctl, lsn


def sec_tidigits(out):
    out.append("## TIDIGITS (connected digits, shipped model + DMP trigram)")
    out.append("")
    out.append("31 utterances / 67.6 s audio (pocketsphinx regression set), "
               "batch decode, defaults (`lw 6.5, wip 0.65, maxwpf 32`).  "
               "Reference: S3.3 0.661% WER @ 0.16 xRT -> 6.25x RT "
               "(BASELINE.md).")
    out.append("")
    out.append("| rcmode | sent. correct | WER | steady xRT |")
    out.append("|---|---|---|---|")
    oks = {}
    for rcmode in ("fanout", "composite"):
        search, feats, ctl, lsn = load_tidigits(rcmode)
        hyps = search.decode_batch(feats)
        t0 = time.time()
        for _ in range(3):
            hyps = search.decode_batch(feats)
        steady = (time.time() - t0) / 3
        audio = sum(f.shape[0] for f in feats) * 0.01
        n_ok = sum(h.text == lsn[u] for h, u in zip(hyps, ctl))
        oks[rcmode] = n_ok
        e, n, pct = wer_of([(lsn[u], h.text) for h, u in zip(hyps, ctl)])
        out.append(f"| {rcmode} | {n_ok}/31 | {pct:.2f}% ({e}/{n}) | "
                   f"{audio/steady:.0f}x RT |")
        print(out[-1], flush=True)
    out.append("")
    out.append("fanout keeps exact per-right-context exit scores "
               "(pocketsphinx alloc_all_rc semantics) and is the default "
               "below 1k words; composite (sphinx3 composite triphones) "
               "is the scalable approximation the 5k+ path uses — this "
               "table is the measured cost of that approximation "
               f"({oks['fanout']}/31 vs {oks['composite']}/31 sentences "
               "here).  `bench.py` asserts 31/31 with the defaults every "
               "run.")
    out.append("")


def sec_goforward(out):
    from cmusphinx_tpu.api import Decoder
    dec = Decoder(hmm=R + "/model/hmm/en_US/hub4wsj_sc_8k",
                  lm=R + "/model/lm/en/turtle.DMP",
                  dict=R + "/model/lm/en/turtle.dic")
    hyp = dec.decode_raw(R + "/test/data/goforward.raw")
    lat = dec.get_lattice()
    bp = lat.bestpath()
    out.append("## goforward smoke (hub4wsj_sc_8k + turtle LM)")
    out.append("")
    out.append(f"- Viterbi: `{hyp.text}` "
               f"({'OK' if hyp.text == 'go forward ten meters' else 'WRONG'})")
    out.append(f"- bestpath: `{bp.text}` "
               f"({'OK' if bp.text == 'go forward ten meters' else 'WRONG'})")
    out.append("")
    print("goforward:", hyp.text, "/", bp.text, flush=True)


def wsj_setup():
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    vocab = build_vocab(5000)
    write_subset_dict(vocab, "/tmp/wsj5k.dic")
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read("/tmp/wsj5k.dic", mdef, filler_path=H + "/noisedict")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    refs = read_lsn(f"{WSJ}/test5k.s1.lsn")
    utts = [line.strip() for line in open(f"{WSJ}/test5k.s1.ctl")]
    feats = [np.asarray(fp.compute(read_mfc(f"{WSJ}/{u}.mfc")))
             for u in utts]
    return dict(vocab=vocab, mdef=mdef, tmat=tmat, d=d, scorer=scorer,
                refs=refs, utts=utts, feats=feats,
                audio=sum(f.shape[0] for f in feats) * 0.01)


def wsj_search(ctx, lmkind, **kw):
    from cmusphinx_tpu.decode import NgramSearch
    lm = build_lm(ctx["vocab"], lmkind)
    args = dict(rcmode="composite", lw=7.5, wip=0.5, beam=1e-60,
                wbeam=1e-40, maxwpf=32, bestpathlw=8.5, latbeam=1e-40)
    args.update(kw)
    return NgramSearch(lm, ctx["d"], ctx["mdef"], ctx["tmat"],
                       ctx["scorer"], **args)


def wsj_score(ctx, hyps):
    return wer_of([(" ".join(ctx["refs"][u]), h.text.lower())
                   for u, h in zip(ctx["utts"], hyps)])


def sec_wsj(out, ctx):
    out.append("## WSJ 5k (hub4wsj_sc_8k, 5,000-word dict from cmu07a.dic)")
    out.append("")
    out.append("7 shipped test utterances (test5k.s1, 57.7 s audio), "
               "`lw 7.5 wip 0.5 beam 1e-60 wbeam 1e-40 maxwpf 32` "
               "(wsj1_test5k.sh config), composite rc.  The reference LM "
               "(wsj0vp.5000.DMP) is ABSENT from the checkout; LM "
               "conditions below are built with the repo's own toolkit "
               "(see run_wsj5k.py).  Baseline row: S3.3 7.3% WER with the "
               "real WSJ trigram (BASELINE.md) — the `tri` ceiling and "
               "`n800` rows bracket what the shipped data supports.")
    out.append("")
    out.append("| LM | pass | WER | steady xRT | bestpath pass wall |")
    out.append("|---|---|---|---|---|")
    results = {}
    for kind in ("n800", "tri", "ug"):
        search = wsj_search(ctx, kind)
        hyps = search.decode_batch(ctx["feats"])
        t0 = time.time()
        for _ in range(2):
            hyps = search.decode_batch(ctx["feats"])
        steady = (time.time() - t0) / 2
        e, n, pct = wsj_score(ctx, hyps)
        out.append(f"| {kind} | Viterbi | {pct:.2f}% ({e}/{n}) | "
                   f"{ctx['audio']/steady:.0f}x RT | — |")
        print(out[-1], flush=True)
        results[kind] = (pct, hyps, search)
        t0 = time.time()
        bp = search._rescore_batch(hyps)
        dt = time.time() - t0
        e2, n2, pct2 = wsj_score(ctx, bp)
        out.append(f"| {kind} | +bestpath (lw 8.5) | {pct2:.2f}% "
                   f"({e2}/{n2}) | — | {dt:.1f} s |")
        print(out[-1], flush=True)
        if kind == "n800":
            assert pct2 <= pct + 1e-9, (
                f"REGRESSION: bestpath degrades n800 WER {pct}->{pct2}")
    out.append("")
    out.append("- `tri` (LM has seen the test sentences) is the "
               "search+acoustic ceiling; the residual WER there is NOT "
               "LM-limited.")
    out.append("- `ug` (uniform unigram) is the no-LM-help floor: pure "
               "5k-way acoustic search.")
    out.append("- bestpath at the measured-optimal weight is asserted "
               "<= the Viterbi WER on n800 by this script.")
    out.append("")
    return results


def sec_bplw_sweep(out, ctx, results):
    out.append("### bestpathlw sweep (n800)")
    out.append("")
    out.append("| bestpathlw | WER | pass wall |")
    out.append("|---|---|---|")
    _, hyps, search = results["n800"]
    e, n, pct = wsj_score(ctx, hyps)
    out.append(f"| (Viterbi only) | {pct:.2f}% | — |")
    for bplw in (7.5, 8.5, 9.5, 10.5, 11.5):
        search.config.update(bestpathlw=bplw)
        t0 = time.time()
        bp = search._rescore_batch(hyps)
        dt = time.time() - t0
        e, n, pct = wsj_score(ctx, bp)
        out.append(f"| {bplw} | {pct:.2f}% ({e}/{n}) | {dt:.2f} s |")
        print(out[-1], flush=True)
    search.config.update(bestpathlw=8.5)
    out.append("")
    out.append("The reference script's 11.5 (wsj1_test5k.sh) presumes the "
               "real WSJ trigram; with the data-poor n800 LM heavier "
               "weights amplify LM error.  Round-3's miscalibrated default "
               "(11.5) plus a finish-word double-count degraded WER; both "
               "are fixed.")
    out.append("")


def sec_lw_sweep(out, ctx):
    out.append("### lw / wip sweep (n800, Viterbi)")
    out.append("")
    out.append("| lw | wip | WER |")
    out.append("|---|---|---|")
    for lw, wip in ((6.5, 0.5), (7.5, 0.2), (7.5, 0.5), (7.5, 0.65),
                    (8.5, 0.5), (9.5, 0.5)):
        search = wsj_search(ctx, "n800", lw=lw, wip=wip)
        hyps = search.decode_batch(ctx["feats"])
        e, n, pct = wsj_score(ctx, hyps)
        out.append(f"| {lw} | {wip} | {pct:.2f}% ({e}/{n}) |")
        print(out[-1], flush=True)
    out.append("")


def sec_error_analysis(out, ctx, results):
    out.append("### n800 error analysis: LM-data poverty, quantified")
    out.append("")
    # Coverage of the TEST reference n-grams by the n800 TRAINING data.
    train = [s for s in read_lsn(f"{WSJ}/test5k.n800.lsn").values()]
    train_uni = set(w.lower() for s in train for w in s)
    train_bi = set()
    for s in train:
        ws = [w.lower() for w in s]
        train_bi.update(zip(ws, ws[1:]))
    ref_words = []
    ref_bis = []
    for u in ctx["utts"]:
        ws = [w.lower() for w in ctx["refs"][u]]
        ref_words.extend(ws)
        ref_bis.extend(zip(ws, ws[1:]))
    cov_u = sum(w in train_uni for w in ref_words) / len(ref_words)
    cov_b = sum(b in train_bi for b in ref_bis) / len(ref_bis)
    pct_n800 = results["n800"][0]
    pct_tri = results["tri"][0]
    out.append(f"- n800 LM training data: 7 sentences ({len(train_uni)} "
               f"distinct words, {len(train_bi)} distinct bigrams) + a "
               f"count-1 unigram floor over the 5k vocabulary.")
    out.append(f"- Test reference coverage by that data: "
               f"{100*cov_u:.0f}% of ref tokens seen as unigrams, "
               f"**{100*cov_b:.0f}% of ref bigrams seen** — almost every "
               f"test bigram scores through the backoff chain at "
               f"floor-level probabilities.")
    out.append(f"- `tri` ceiling {pct_tri:.1f}% vs `n800` {pct_n800:.1f}%: "
               f"the gap between them is the LM-data term; the gap between "
               f"`tri` and the 7.3% reference baseline bounds the "
               f"search+acoustic term.")
    out.append("")
    # Per-utterance hypotheses for the record.
    out.append("Per-utterance n800 hypotheses (Viterbi):")
    out.append("")
    out.append("```")
    for u, h in zip(ctx["utts"], results["n800"][1]):
        out.append(f"{u} ref: {' '.join(ctx['refs'][u]).lower()}")
        out.append(f"{u} hyp: {h.text.lower()}")
    out.append("```")
    out.append("")
    for line in out[-20:]:
        print(line, flush=True)


def sec_wsj_tree(out, ctx):
    """Tree vs flat lexicon at 5k."""
    out.append("## WSJ 5k tree vs flat lexicon")
    out.append("")
    out.append("Same 5k setup as above; the prefix-shared tree carries "
               "the per-history bigram lookahead smear "
               "(ngram_search.py _setup_tree_bgla).")
    out.append("")
    out.append("| lexicon | LM | WER | steady xRT |")
    out.append("|---|---|---|---|")
    for lexmode in ("tree", "flat"):
        for lmkind in ("tri", "n800"):
            search = wsj_search(ctx, lmkind, lexmode=lexmode,
                                lcmode="composite")
            hyps = search.decode_batch(ctx["feats"])
            t0 = time.time()
            hyps = search.decode_batch(ctx["feats"])
            steady = time.time() - t0
            e, n, pct = wsj_score(ctx, hyps)
            out.append(f"| {lexmode} | {lmkind} | {pct:.2f}% ({e}/{n}) | "
                       f"{ctx['audio']/steady:.1f}x RT |")
            print(out[-1], flush=True)
            del search
    out.append("")
    out.append("`-nlextree N` (sphinx3's N parallel tree copies) remains "
               "implemented and tested (tests/test_tree_lexicon.py) but "
               "measured WER-neutral here — the binding approximation "
               "was the lookahead, which the bigram smear now supplies.")
    out.append("")


def sec_wsj60k(out):
    import run_wsj60k as wk
    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices, read_sendump
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.ops.gmm import PsParityScorer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    out.append("## WSJ 123k-word open vocabulary (HUB4-class scale proof)")
    out.append("")
    out.append("Full cmu07a.dic (133k entries / 123k base words — 2x the "
               "reference's 60k HUB4 vocabulary), same 7 WSJ utterances, "
               "same beams as the 5k eval.  LM: trigram over the shipped "
               "transcripts + count-1 unigram floor over the whole "
               "vocabulary (`tri` saw the test sentences = ceiling; "
               "`n800` held out = honest).  Reference row: HUB4 60k "
               "S3.3 18.8% WER @ 0.33x RT (BASELINE.md).")
    out.append("")
    vocab = wk.full_vocab(0)
    mdef = Mdef.read(H + "/mdef")
    g = read_gauden(H + "/means", H + "/variances")
    w, meta = read_sendump(H + "/sendump", return_raw=True)
    tmat = TransitionMatrices.read(H + "/transition_matrices")
    d = Dictionary.read(DIC, mdef, filler_path=H + "/noisedict")
    cfg = Config(FE_ARGS, FEAT_ARGS)
    cfg.update_from_file(H + "/feat.params")
    fp = FeatPipeline(cfg)
    scorer = PsParityScorer(g, w, fp.stream_slices(),
                            wrap_uint8=meta["n_bits"] == 4)
    refs = read_lsn(f"{WSJ}/test5k.s1.lsn")
    utts = [line.strip() for line in open(f"{WSJ}/test5k.s1.ctl")]
    feats = [np.asarray(fp.compute(read_mfc(f"{WSJ}/{u}.mfc")))
             for u in utts]
    audio = sum(f.shape[0] for f in feats) * 0.01
    out.append("| lexicon | LM | channels | WER | +bestpath WER | "
               "steady xRT |")
    out.append("|---|---|---|---|---|---|")
    for lexmode, lmkind in (("tree", "tri"), ("tree", "n800"),
                            ("tree", "big"), ("flat", "tri")):
        if lmkind == "big":
            lm = wk.build_floor_lm(vocab, "tri")
            wk.inflate_lm(lm, 2_000_000, 3_000_000)
        else:
            lm = wk.build_floor_lm(vocab, lmkind)
        search = NgramSearch(lm, d, mdef, tmat, scorer,
                             rcmode="composite", lcmode="composite",
                             lexmode=lexmode, lw=7.5, wip=0.5,
                             beam=1e-60, wbeam=1e-40, maxwpf=32,
                             bestpathlw=7.5, latbeam=1e-40)
        hyps = search.decode_batch(feats)
        t0 = time.time()
        hyps = search.decode_batch(feats)
        steady = time.time() - t0
        e, n, pct = wer_of([(" ".join(refs[u]), h.text.lower())
                            for u, h in zip(utts, hyps)])
        bp = search._rescore_batch(hyps)
        e2, n2, pct2 = wer_of([(" ".join(refs[u]), h.text.lower())
                               for u, h in zip(utts, bp)])
        out.append(f"| {lexmode} | {lmkind} | {search.graph.n_chan} | "
                   f"{pct:.2f}% ({e}/{n}) | {pct2:.2f}% ({e2}/{n2}) | "
                   f"{audio/steady:.1f}x RT |")
        print(out[-1], flush=True)
        del search
    out.append("")
    out.append("- The tree layout (prefix-shared channels, delayed "
               "exact-trigram at exit) carries a per-re-entry-history "
               "BIGRAM lookahead smear on top of the static unigram smear, "
               "cancelled exactly at the exit readout (ngram_search.py "
               "_setup_tree_bgla).  The reference runs 60k words at 0.33x "
               "RT.")
    out.append("- `big` = the tri LM inflated to 2M bigrams + 3.2M "
               "trigrams with ballast entries at -25 nats (the sphinx4 "
               "LargeTrigramModel-class regime): scores and hypotheses "
               "stay those of the real LM while every lookup runs through "
               "the hashed device point-lookup backend.")
    out.append("")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "EVALS.md"))
    ap.add_argument("--skip", default="",
                    help="comma-separated sections to skip "
                         "(tidigits,goforward,wsj,wsj60k)")
    args = ap.parse_args()
    skip = set(args.skip.split(","))

    import jax
    import jax.numpy as jnp

    git_rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(args.out)).stdout.strip()
    out = [
        "# EVALS — evaluation ledger",
        "",
        f"Regenerated by `evals/make_evals.py` at git `{git_rev}` on "
        f"platform `{jax.devices()[0].platform}` "
        f"({jax.devices()[0].device_kind}).",
        "",
        "WER via the same word-alignment as the reference's word_align.pl; "
        "xRT = audio seconds per wall second, steady state.  BASELINE.md "
        "holds the reference numbers these are judged against.",
        "",
    ]
    t00 = time.time()
    if "tidigits" not in skip:
        sec_tidigits(out)
    if "goforward" not in skip:
        sec_goforward(out)
    if "wsj" not in skip:
        ctx = wsj_setup()
        results = sec_wsj(out, ctx)
        sec_bplw_sweep(out, ctx, results)
        sec_lw_sweep(out, ctx)
        sec_error_analysis(out, ctx, results)
        sec_wsj_tree(out, ctx)
    if "wsj60k" not in skip:
        sec_wsj60k(out)
    # Preserve sections maintained by OTHER eval scripts (they state their
    # regenerating script inline) and sections skipped this run: any
    # existing '## ' section whose header was not regenerated above is
    # carried over verbatim.
    own_headers = {h for h in ("## TIDIGITS", "## goforward", "## WSJ 5k",
                               "## WSJ 5k tree", "## WSJ 123k")
                   if any(l.startswith(h) for l in out)}
    if os.path.exists(args.out):
        old = open(args.out).read().split("\n## ")
        for sec in old[1:]:
            header = "## " + sec.split("\n", 1)[0]
            if not any(header.startswith(h) for h in own_headers) \
                    and not sec.startswith("#"):
                out.append("## " + sec.rstrip())
                out.append("")
                # strip a stale footer line if the section swallowed one
                if out[-2].rstrip().endswith("s._"):
                    out[-2] = "\n".join(
                        l for l in out[-2].splitlines()
                        if not l.startswith("_Total regeneration"))
    out.append(f"_Total regeneration wall time: {time.time()-t00:.0f} s._")
    out.append("")
    with open(args.out, "w") as fh:
        fh.write("\n".join(out))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

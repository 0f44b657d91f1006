#!/usr/bin/env python
"""Train-to-decode validation (AN4-tutorial capability on shipped data):
flat-start CI Baum-Welch training on the 31 shipped tidigits utterances
(sphinx3/model/hmm/tidigits/cepstra + word-dependent phone dictionary),
export the model in Sphinx-3 formats, reload it through the standard model
readers, and decode the training set with the trigram decoder."""

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from run_tidigits_fsg import wer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gauss", type=int, default=4)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--lw", type=float, default=6.5)
    ap.add_argument("--wip", type=float, default=0.65)
    ap.add_argument("--silprob", type=float, default=0.005)
    ap.add_argument("--heldout", action="store_true",
                    help="hold out every 4th utterance (both speakers) "
                         "from training and decode them unseen")
    ap.add_argument("--adapt", type=int, default=0,
                    help="with --loso: use the first N held-out-speaker "
                         "utterances for supervised MLLR adaptation and "
                         "decode the rest (80.mllr_adapt capability)")
    ap.add_argument("--loso", action="store_true",
                    help="leave-one-speaker-out generalization gate: train "
                         "on each of the two shipped speakers (man.ah 16 "
                         "utts / woman.ak 15 utts) and decode the OTHER — "
                         "a held-out cross-speaker test instead of "
                         "decoding the training set")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from cmusphinx_tpu.decode import NgramSearch
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.models import Mdef, TransitionMatrices
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.models.sendump import read_mixture_weights
    from cmusphinx_tpu.ops.gmm import ContinuousScorer
    from cmusphinx_tpu.train.model_io import export_model
    from cmusphinx_tpu.train.sentence_hmm import FlatModel
    from cmusphinx_tpu.train.trainer import Trainer
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    R = "/root/reference"
    lsn = {}
    for line in open(R + "/pocketsphinx/test/data/tidigits/tidigits.lsn"):
        p = line.split()
        lsn[p[-1].strip("()")] = [w.lower() for w in p[:-1]]
    pron = {}
    for line in open(R + "/sphinx3/model/hmm/tidigits/dictionary"):
        p = line.split()
        pron[p[0].lower()] = p[1:]
    phones = sorted({ph for ps in pron.values() for ph in ps} | {"SIL"})
    model = FlatModel.create(phones, n_state=3)
    fp = FeatPipeline(Config(FE_ARGS, FEAT_ARGS), feat="1s_c_d_dd")
    feats, trans, utts = [], [], []
    for mfc in sorted(glob.glob(
            R + "/sphinx3/model/hmm/tidigits/cepstra/*/*.mfc")):
        utt = os.path.basename(mfc)[:-4]
        if utt not in lsn:
            continue
        feats.append(np.asarray(fp.compute(read_mfc(mfc))))
        trans.append(lsn[utt])
        utts.append(utt)
    def decode_with(params, te_idx, tag):
        """Export params, reload through the model zoo readers, decode."""
        outdir = tempfile.mkdtemp(prefix="tidigits_ci_")
        export_model(outdir, model, params)
        mdef = Mdef.read(outdir + "/mdef")
        g = read_gauden(outdir + "/means", outdir + "/variances")
        lnw = read_mixture_weights(outdir + "/mixture_weights")
        tmat = TransitionMatrices.read(outdir + "/transition_matrices")
        scorer = ContinuousScorer(g, lnw[0].T)
        d = Dictionary(mdef)
        for w, ps in pron.items():
            d.add_word(w, ps)
        d.filler_start = d.n_word
        for w in ("<s>", "</s>", "<sil>"):
            d.add_word(w, ["SIL"])
        d.filler_end = d.n_word - 1
        lm = NgramModel.read(R + "/pocketsphinx/model/lm/en/tidigits.DMP")
        search = NgramSearch(lm, d, mdef, tmat, scorer, lw=args.lw,
                             wip=args.wip, silprob=args.silprob)
        n_ok = n_err = n_ref = 0
        for i in te_idx:
            hyp = search.decode(feats[i])
            ref = " ".join(lsn[utts[i]]).upper()
            got = hyp.text.upper()
            ok = got == ref
            n_ok += ok
            e, n = wer(ref, got)
            n_err += e
            n_ref += n
            if not ok:
                print(f"  {utts[i]}: {got!r} want {ref!r}")
        print(f"[{tag}] decode: {n_ok}/{len(te_idx)} sentences, "
              f"WER {100.0 * n_err / n_ref:.2f}%")
        return n_ok, n_err, n_ref, len(te_idx)

    def train_on(tr_idx, tag):
        t0 = time.time()
        tr = Trainer(model, pron, [trans[i] for i in tr_idx],
                     [feats[i] for i in tr_idx], K=args.gauss)
        hist = tr.train(max_iter=args.iters, conv_ratio=1e-4)
        print(f"[{tag}] EM: {len(hist)} iterations in "
              f"{time.time() - t0:.1f}s; per-frame ll "
              f"{hist[0]:.3f} -> {hist[-1]:.3f}")
        assert all(b >= a - 1e-3 for a, b in zip(hist, hist[1:])), \
            "likelihood must be non-decreasing"
        return tr

    def train_decode(tr_idx, te_idx, tag):
        return decode_with(train_on(tr_idx, tag).params, te_idx, tag)

    def mllr_adapt(params, adapt_idx, tag):
        """Supervised MLLR adaptation (ps_mllr / mllr_solve capability):
        one Baum-Welch E-step on the adaptation utterances against the
        mismatched model yields per-Gaussian occupancies and observation
        sums; solve the single-class transform and shift the means."""
        import dataclasses

        import jax.numpy as jnp
        from cmusphinx_tpu.models.mllr import solve_mllr
        ta = Trainer(model, pron, [trans[i] for i in adapt_idx],
                     [feats[i] for i in adapt_idx], K=args.gauss)
        _, acc = ta._fb(ta.batch, jnp.asarray(params.means),
                        jnp.asarray(params.prec),
                        jnp.asarray(params.lnw),
                        jnp.asarray(params.log_tp))
        occ = np.asarray(acc["mixw"]).reshape(-1)
        xsum = np.asarray(acc["mean"]).reshape(occ.shape[0], -1)
        S, K, D = params.means.shape
        mt = solve_mllr(params.means.reshape(S * K, D),
                        params.var.reshape(S * K, D), occ, xsum)
        W, b = mt.A[0][0], mt.b[0][0]
        new_means = (params.means.reshape(S * K, D) @ W.T
                     + b[None, :]).reshape(S, K, D).astype(np.float32)
        print(f"[{tag}] MLLR: |mean shift| "
              f"{np.abs(new_means - params.means).mean():.3f} "
              f"(occ mass {occ.sum():.0f})")
        return dataclasses.replace(params, means=new_means)

    print(f"corpus: {len(feats)} utts, {sum(len(f) for f in feats)} "
          f"frames, {model.n_sen} senones, {args.gauss} Gaussians")
    if args.heldout:
        # Stratified held-out-utterance gate: every 4th utterance (both
        # speakers represented) is excluded from training and decoded
        # unseen — generalization to new UTTERANCES of known speakers.
        te_idx = list(range(0, len(utts), 4))
        tr_idx = [i for i in range(len(utts)) if i not in set(te_idx)]
        ok, err, ref, n = train_decode(tr_idx, te_idx, "held-out utts")
        return 0 if err / max(ref, 1) <= 0.25 else 1
    if args.loso:
        # Leave-one-speaker-out: the shipped corpus has exactly two
        # speakers (man.ah / woman.ak), so this is a cross-speaker,
        # cross-gender generalization gate (round-2/3 reviews flagged the
        # train-set decode as a non-test of generalization).
        spk = [u.rsplit(".", 1)[0] for u in utts]
        speakers = sorted(set(spk))
        tot = {"raw": [0, 0, 0, 0], "mllr": [0, 0, 0, 0]}
        for held in speakers:
            tr_idx = [i for i, s in enumerate(spk) if s != held]
            te_all = [i for i, s in enumerate(spk) if s == held]
            adapt_idx, te_idx = te_all[: args.adapt], te_all[args.adapt:]
            tr = train_on(tr_idx, f"train w/o {held}")
            r = decode_with(tr.params, te_idx, f"held-out {held} raw")
            for j in range(4):
                tot["raw"][j] += r[j]
            if args.adapt:
                # Iterate estimate->re-align (the mismatched model cannot
                # align the adaptation data well on the first pass; each
                # round's transform improves the next round's posteriors —
                # standard multi-pass MLLR practice).
                ap = tr.params
                for it in range(3):
                    ap = mllr_adapt(ap, adapt_idx,
                                    f"adapt {held} iter{it}")
                r = decode_with(ap, te_idx, f"held-out {held} +MLLR")
                for j in range(4):
                    tot["mllr"][j] += r[j]
        for k in ("raw", "mllr") if args.adapt else ("raw",):
            ok, err, ref, n = tot[k]
            print(f"LOSO {k}: {ok}/{n} sentences, "
                  f"WER {100.0 * err / max(ref, 1):.2f}%")
        if args.adapt:
            # Gate: adaptation must substantially repair the cross-speaker
            # mismatch (the unadapted cross-gender model is near-useless).
            return 0 if tot["mllr"][1] < tot["raw"][1] else 1
        return 0 if tot["raw"][1] / max(tot["raw"][2], 1) <= 0.5 else 1
    idx = list(range(len(utts)))
    n_ok, n_err, n_ref, n = train_decode(idx, idx, "train-set")
    return 0 if n_ok >= n - 3 else 1


if __name__ == "__main__":
    from cmusphinx_tpu.utils.compile_cache import init_compile_cache
    init_compile_cache()
    sys.exit(main())

"""Shared helper: train + export a CD-tied CONTINUOUS tidigits model.

Used by run_approx_gmm.py so its bench runs on the
same repo-trained acoustic model (CI -> CD-untied -> dtree tying ->
CD-tied -> mixture splitting; SURVEY.md §2.4 pipeline capability)."""

import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

R = "/root/reference"


def corpus():
    from cmusphinx_tpu.frontend.fe import FE_ARGS
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS, FeatPipeline
    from cmusphinx_tpu.utils.bio import read_mfc
    from cmusphinx_tpu.utils.config import Config

    lsn = {}
    for line in open(R + "/pocketsphinx/test/data/tidigits/tidigits.lsn"):
        p = line.split()
        lsn[p[-1].strip("()")] = [w.lower() for w in p[:-1]]
    pron = {}
    for line in open(R + "/sphinx3/model/hmm/tidigits/dictionary"):
        p = line.split()
        pron[p[0].lower()] = p[1:]
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
    return lsn, pron, feats, trans, utts


def train_and_export(outdir: str, gauss: int = 16, nstate: int = 5,
                     senones: int = 560, verbose: bool = True):
    """Train the CD-tied continuous model and export it to `outdir`
    (cached: reuses an existing export)."""
    from cmusphinx_tpu.train.pipeline import (export_cd_model,
                                              train_full_pipeline)
    from cmusphinx_tpu.train.sentence_hmm import FlatModel

    if os.path.exists(os.path.join(outdir, "mdef")):
        return outdir
    lsn, pron, feats, trans, utts = corpus()
    phones = sorted({ph for ps in pron.values() for ph in ps} | {"SIL"})
    model = FlatModel.create(phones, n_state=nstate)
    inv, smap, tied, hist = train_full_pipeline(
        model, pron, trans, feats, gauss=gauss, tying="dtree",
        n_tied_senones=senones, verbose=verbose)
    export_cd_model(outdir, inv, smap, tied)
    return outdir


def load_decoder_parts(outdir: str):
    from cmusphinx_tpu.models import Mdef, TransitionMatrices
    from cmusphinx_tpu.models.dict import Dictionary
    from cmusphinx_tpu.models.gauden import read_gauden
    from cmusphinx_tpu.models.ngram import NgramModel
    from cmusphinx_tpu.models.sendump import read_mixture_weights

    lsn, pron, feats, trans, utts = corpus()
    mdef = Mdef.read(outdir + "/mdef")
    g = read_gauden(outdir + "/means", outdir + "/variances")
    lnw = read_mixture_weights(outdir + "/mixture_weights")
    tmat = TransitionMatrices.read(outdir + "/transition_matrices")
    lnw2 = lnw[0].T   # read_mixture_weights -> LN weights [nf, K, S]
    d = Dictionary(mdef)
    for w, ps in pron.items():
        d.add_word(w, ps)
    d.filler_start = d.n_word
    for w in ("<s>", "</s>", "<sil>"):
        d.add_word(w, ["SIL"])
    d.filler_end = d.n_word - 1
    lm = NgramModel.read(
        R + "/pocketsphinx/model/lm/en/tidigits.DMP")
    return dict(mdef=mdef, gauden=g, lnw=lnw2, tmat=tmat, d=d, lm=lm,
                lsn=lsn, feats=feats, utts=utts)

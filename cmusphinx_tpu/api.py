"""Top-level decoder API.

Capability parity with the pocketsphinx decoder API (reference:
pocketsphinx/src/libpocketsphinx/pocketsphinx.c — ps_init:296 builds
logmath -> acmod -> dict -> search from config with model-dir defaults and
feat.params layering :98-156; utterance loop ps_start_utt:615 /
ps_process_raw:743 / ps_end_utt:805; ps_get_hyp, ps_seg iterators,
ps_nbest, ps_get_lattice, ps_get_prob, ps_add_word, ps_decode_raw) and the
sphinx3 live-decode API (s3_decode.c).

    d = Decoder(hmm=".../en_US/hub4wsj_sc_8k", lm=".../turtle.DMP",
                dict=".../turtle.dic")
    d.start_utt()
    d.process_raw(samples)         # any number of chunks
    d.end_utt()
    print(d.hyp().text)

The acoustic scorer is chosen from the model directory contents the way
acmod_init_am does (acmod.c:78): `sendump` -> semi-continuous (bit-faithful
PsParityScorer by default — reproduces the reference's WER behavior on its
shipped models; set parity=False for the exact float path), per-senone
codebooks -> continuous, per-CI-phone codebooks -> PTM.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .decode.fsg_search import FsgSearch, Hypothesis, Segment
from .decode.ngram_search import NGRAM_ARGS, NgramSearch
from .frontend.fe import FE_ARGS, Frontend
from .frontend.feat import FEAT_ARGS, FeatPipeline
from .models.dict import Dictionary
from .models.fsg import FsgModel
from .models.gauden import read_gauden
from .models.jsgf import JsgfGrammar
from .models.mdef import Mdef
from .models.ngram import NgramModel
from .models.sendump import read_mixture_weights, read_sendump
from .models.tmat import TransitionMatrices
from .ops.gmm import (GEMM_PRECISIONS, ContinuousScorer, PsParityScorer,
                      PTMScorer, SemiContinuousScorer)
from .utils.config import Arg, Config

DECODER_ARGS = [
    Arg("hmm", str, "", "Directory containing acoustic model files"),
    Arg("mdef", str, "", "Model definition input file"),
    Arg("mean", str, "", "Mixture gaussian means input file"),
    Arg("var", str, "", "Mixture gaussian variances input file"),
    Arg("tmat", str, "", "HMM state transition matrix input file"),
    Arg("mixw", str, "", "Senone mixture weights input file"),
    Arg("sendump", str, "", "Senone dump (compressed mixture weights) input file"),
    Arg("featparams", str, "", "File containing feature extraction parameters"),
    Arg("dict", str, "", "Main pronunciation dictionary input file"),
    Arg("fdict", str, "", "Noise word pronunciation dictionary input file"),
    Arg("lm", str, "", "Word trigram language model input file"),
    Arg("lmctl", str, "", "Specify a set of language models"),
    Arg("lmname", str, "", "Which language model in -lmctl to use initially"),
    Arg("fsg", str, "", "Sphinx format finite state grammar file"),
    Arg("jsgf", str, "", "JSGF grammar file"),
    Arg("srgs", str, "", "SRGS XML grammar file (libcfg s3_cfg_srgs)"),
    Arg("cfg", str, "",
        "Plain CFG production file (libcfg s3_cfg_read_simple format)"),
    Arg("cfg_maxexp", int, 2,
        "Max recursive expansions per nonterminal in CFG->FSG conversion"),
    Arg("allphone", str, "",
        "Perform phoneme decoding with phonetic lm (sphinx3 mode 1 / "
        "ps -allphone); value is a phone N-gram LM path or 'uniform'"),
    Arg("toprule", str, "", "Start rule for JSGF (first public rule is default)"),
    Arg("varfloor", float, 0.0001, "Mixture gaussian variance floor"),
    Arg("mllr", str, "", "MLLR transform to apply to acoustic model means"),
    Arg("lambda", str, "",
        "CD/CI senone interpolation weights file (sphinx3 -lambda, "
        "libam/interp.c): .npy or one-float-per-line text of per-senone "
        "lambdas from deleted interpolation"),
    Arg("parity", bool, True,
        "Use the bit-faithful reference senone scorer for sendump models"),
    Arg("topn", int, 4, "Number of top Gaussians to use in scoring"),
    Arg("gmmprec", str, "highest",
        "Continuous-GMM GEMM precision: highest (IEEE f32), high (bf16x3: "
        "each f32 operand split into two bf16 parts, three bf16 products "
        "summed in f32; a few nats at floored-variance magnitudes), or "
        "bf16 (one bf16 product; UNSAFE for floored-variance models - "
        "verify WER per model).  See ops/gmm.py GEMM_PRECISIONS"),
    Arg("samprate", float, 16000.0, "Sampling rate"),
]


class Decoder:
    """Speech decoder over one acoustic model + one search module."""

    def __init__(self, config: Optional[Config] = None, **kwargs):
        cfg = (config.copy() if config else
               Config(DECODER_ARGS, FE_ARGS, FEAT_ARGS, NGRAM_ARGS))
        cfg.register(DECODER_ARGS).register(FE_ARGS).register(FEAT_ARGS)
        cfg.register(NGRAM_ARGS)
        from .decode.fsg_search import FSG_ARGS
        cfg.register(FSG_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        if str(cfg["gmmprec"]) not in GEMM_PRECISIONS:
            raise ValueError(f"-gmmprec must be one of "
                             f"{sorted(GEMM_PRECISIONS)}, got "
                             f"{cfg['gmmprec']!r}")
        hmm = str(cfg["hmm"])

        def model_file(key: str, name: str) -> str:
            v = str(cfg[key])
            if v:
                return v
            p = os.path.join(hmm, name)
            return p if hmm and os.path.exists(p) else ""

        # feat.params layering (ps_init_defaults pocketsphinx.c:98-156).
        fparams = model_file("featparams", "feat.params")
        if fparams:
            cfg.update_from_file(fparams)
            cfg.update(**kwargs)  # explicit args win over feat.params

        mdef_path = model_file("mdef", "mdef")
        if not mdef_path:
            raise ValueError("must specify -hmm or -mdef")
        self.mdef = Mdef.read(mdef_path)
        self.tmat = TransitionMatrices.read(model_file("tmat",
                                                       "transition_matrices"))
        gauden = read_gauden(model_file("mean", "means"),
                             model_file("var", "variances"),
                             varfloor=float(cfg["varfloor"]))

        if str(cfg["mllr"]):
            # ps_mllr / acmod_update_mllr capability: adapt means on load.
            from .models.mllr import MllrTransform
            MllrTransform.read(str(cfg["mllr"])).apply(gauden)

        self.fe = Frontend(cfg)
        self.fp = FeatPipeline(cfg)
        self.scorer = self._init_scorer(cfg, gauden, model_file)
        if str(cfg["lambda"]):
            # Decode-time CD/CI interpolation (sphinx3 interp_all).
            from .ops.gmm import InterpolatedScorer
            lpath = str(cfg["lambda"])
            lam = (np.load(lpath) if lpath.endswith(".npy") else
                   np.loadtxt(lpath, dtype=np.float32, ndmin=1))
            self.scorer = InterpolatedScorer(
                self.scorer, self.mdef.cd2cisen, self.mdef.n_ci_sen, lam)

        fdict = model_file("fdict", "noisedict")
        self.dict = Dictionary.read(str(cfg["dict"]) or None, self.mdef,
                                    filler_path=fdict or None)

        # Search module (ps_reinit search selection :257-280).
        self.search = None
        if str(cfg["allphone"]):
            # Phoneme decoding with an optional phone N-gram LM
            # (srch_allphone capability; shipped fixture
            # sphinx3/model/lm/an4/an4.tg.phone.arpa.DMP loads here).
            from .decode.align import allphone_search
            spec = str(cfg["allphone"])
            plm = None if spec == "uniform" else NgramModel.read(spec)
            self.search = allphone_search(self.mdef, self.tmat, self.scorer,
                                          lm=plm, config=cfg)
        elif str(cfg["fsg"]):
            fsg = FsgModel.read(str(cfg["fsg"]))
            self.search = FsgSearch(fsg, self.dict, self.mdef, self.tmat,
                                    self.scorer, config=cfg)
        elif str(cfg["jsgf"]):
            gram = JsgfGrammar.parse_file(str(cfg["jsgf"]))
            fsg = gram.build_fsg(str(cfg["toprule"]) or None)
            self.search = FsgSearch(fsg, self.dict, self.mdef, self.tmat,
                                    self.scorer, config=cfg)
        elif str(cfg["srgs"]) or str(cfg["cfg"]):
            # CFG/SRGS engine (sphinx3 libcfg capability): grammar ->
            # regular approximation -> FSG -> dense Viterbi.
            from .models.cfg import Cfg
            g = (Cfg.parse_srgs_file(str(cfg["srgs"])) if str(cfg["srgs"])
                 else Cfg.read_simple(str(cfg["cfg"])))
            fsg = g.to_fsg(max_expansion=int(cfg["cfg_maxexp"]))
            self.search = FsgSearch(fsg, self.dict, self.mdef, self.tmat,
                                    self.scorer, config=cfg)
        elif str(cfg["lmctl"]):
            from .models.lmset import NgramModelSet
            self.lmset = NgramModelSet.read_lmctl(str(cfg["lmctl"]))
            if str(cfg["lmname"]):
                self.lmset.select(str(cfg["lmname"]))
            self.search = NgramSearch(self.lmset.lm(), self.dict, self.mdef,
                                      self.tmat, self.scorer, config=cfg)
        elif str(cfg["lm"]):
            lm = NgramModel.read(str(cfg["lm"]))
            self.search = NgramSearch(lm, self.dict, self.mdef, self.tmat,
                                      self.scorer, config=cfg)

        self._raw_chunks: List[np.ndarray] = []
        self._hyp: Optional[Hypothesis] = None
        self._in_utt = False
        self._stream = None

    # ------------------------------------------------------------------
    def _init_scorer(self, cfg, gauden, model_file):
        sendump = model_file("sendump", "sendump")
        mixw_path = model_file("mixw", "mixture_weights")
        slices = self.fp.stream_slices()
        if sendump:
            if bool(cfg["parity"]):
                raw, meta = read_sendump(sendump, return_raw=True)
                return PsParityScorer(gauden, raw, slices,
                                      topn=int(cfg["topn"]),
                                      wrap_uint8=meta["n_bits"] == 4)
            lnw = read_sendump(sendump)
            return SemiContinuousScorer(gauden, lnw, slices,
                                        topn=int(cfg["topn"]))
        if not mixw_path:
            raise ValueError("model has neither sendump nor mixture_weights")
        lnw = read_mixture_weights(mixw_path)
        if gauden.n_mgau == 1:
            return SemiContinuousScorer(gauden, lnw, slices,
                                        topn=int(cfg["topn"]))
        if gauden.n_feat == 1 and gauden.n_mgau == lnw.shape[-1]:
            # One codebook per senone: continuous.
            return ContinuousScorer(gauden, lnw[0].T,
                                    precision=str(cfg["gmmprec"]))
        if gauden.n_mgau == self.mdef.n_ciphone:
            sen2cb = np.asarray(self.mdef.sen2cimap, np.int32)
            return PTMScorer(gauden, lnw[0].T, sen2cb)
        raise ValueError(
            f"cannot infer scorer type: n_mgau={gauden.n_mgau}, "
            f"n_feat={gauden.n_feat}, n_sen={lnw.shape[-1]}")

    # ------------------------------------------------------------------
    # Utterance API (ps_start_utt / ps_process_raw / ps_end_utt).
    def start_utt(self, streaming: bool = False) -> None:
        """Begin an utterance.  With streaming=True the decoder advances
        incrementally on every process_raw/process_cep call — the Viterbi
        carry stays device-resident between chunks (the reference's
        per-frame ps_search_forward loop, pocketsphinx.c:699-719) and
        `hyp()` returns PARTIAL hypotheses mid-utterance (gst plugin
        partial-result capability).  Streaming uses prior-mode CMN
        (cmn_prior.c live semantics) since batch CMN needs the whole
        utterance."""
        if self._in_utt:
            raise RuntimeError("utterance already started")
        self._raw_chunks = []
        self._hyp = None
        self._in_utt = True
        self._stream = None
        if streaming:
            if not isinstance(self.search, NgramSearch):
                raise ValueError("streaming decode requires an N-gram search")
            from .frontend.fe import FrontendStream
            self._stream = self.search.stream_start()
            self._festream = FrontendStream(self.fe)
            self._cep_buf = np.zeros((0, 0), np.float32)
            self._cep_done = 0  # cep frames already emitted as features

    def _stream_feats(self, cep: np.ndarray, endutt: bool) -> None:
        """Emit dynamic-feature frames whose delta context is complete.

        New cepstra are normalized on arrival through the feature
        pipeline's live path (fp.normalize_live: prior-mode CMN with the
        end-of-utterance mean refresh, plus AGC — cmn_prior.c / agc.c
        semantics, shared with compute_live) and appended to a context
        buffer; dynamic features are computed over [done-win, avail+win)
        so every emitted frame has its full delta window — replicate
        padding only ever applies at true utterance boundaries.
        """
        fp = self.fp
        cep = fp.normalize_live(cep, endutt)
        if cep.size:
            self._cep_buf = (cep if self._cep_buf.size == 0
                             else np.concatenate([self._cep_buf, cep]))
        win = max(fp.window, 1)
        total = self._cep_buf.shape[0]
        avail = total if endutt else max(total - win, self._cep_done)
        if avail <= self._cep_done:
            return
        lo = max(self._cep_done - win, 0)
        block = self._cep_buf[lo: total if endutt else avail + win]
        feats = np.asarray(fp._dynamic(np.asarray(block, np.float32)))
        if fp.lda is not None:
            feats = feats @ fp.lda[: fp.out_dim].T
        out = feats[self._cep_done - lo: avail - lo]
        self._cep_done = avail
        if out.shape[0]:
            self.search.stream_push(self._stream, out)

    def process_raw(self, data: np.ndarray) -> None:
        if not self._in_utt:
            raise RuntimeError("call start_utt first")
        data = np.asarray(data, np.float32).ravel()
        if self._stream is None:
            self._raw_chunks.append(data)
            return
        # FrontendStream carries the pre-emphasis prior and the sample
        # remainder across chunks (fe_process_frames streaming semantics),
        # so chunked features match a one-shot fe.process of the same audio.
        cep = np.asarray(self._festream.process(data))
        if cep.shape[0]:
            self._stream_feats(cep, endutt=False)

    def process_cep(self, cep: np.ndarray) -> None:
        if not self._in_utt:
            raise RuntimeError("call start_utt first")
        cep = np.asarray(cep, np.float32)
        if self._stream is None:
            self._raw_chunks.append(("cep", cep))
        else:
            self._stream_feats(cep, endutt=False)

    def abort_utt(self) -> None:
        """Discard any utterance in progress and reset to IDLE.  Used for
        per-utterance failure isolation (the reference's batch driver
        warns and continues after a bad utterance, sphinx3 libAPI/utt.c);
        safe to call in any state."""
        self._in_utt = False
        self._stream = None
        self._raw_chunks = []
        self._hyp = None

    def end_utt(self) -> Hypothesis:
        if not self._in_utt:
            raise RuntimeError("no utterance in progress")
        self._in_utt = False
        if self._stream is not None:
            tail = np.asarray(self._festream.end_utt())
            if tail.shape[0]:
                self._stream_feats(tail, endutt=True)
            elif self._cep_done < self._cep_buf.shape[0]:
                self._stream_feats(
                    np.zeros((0, self._cep_buf.shape[1]), np.float32),
                    endutt=True)
            self._hyp = self.search.stream_end(self._stream)
            self._stream = None
            return self._hyp
        ceps = []
        raws = [c for c in self._raw_chunks if not isinstance(c, tuple)]
        if raws:
            samples = np.concatenate(raws) if len(raws) > 1 else raws[0]
            ceps.append(np.asarray(self.fe.process(samples)))
        ceps.extend(c[1] for c in self._raw_chunks if isinstance(c, tuple))
        if not ceps:
            self._hyp = Hypothesis([], float("-inf"), [])
            return self._hyp
        cep = np.concatenate(ceps) if len(ceps) > 1 else ceps[0]
        feats = np.asarray(self.fp.compute(cep))
        self._hyp = self.search.decode(feats)
        return self._hyp

    # ------------------------------------------------------------------
    def decode_raw(self, path: str) -> Hypothesis:
        """Decode a whole headerless 16-bit PCM file (ps_decode_raw)."""
        data = np.frombuffer(open(path, "rb").read(), np.int16)
        self.start_utt()
        self.process_raw(data.astype(np.float32))
        return self.end_utt()

    def decode_cep_file(self, path: str) -> Hypothesis:
        from .utils.bio import read_mfc
        self.start_utt()
        self.process_cep(read_mfc(path))
        return self.end_utt()

    # Results (ps_get_hyp / ps_seg / ps_nbest / ps_get_lattice / ps_get_prob).
    def hyp(self) -> Optional[Hypothesis]:
        """Current hypothesis: PARTIAL while a streaming utterance is in
        progress (ps_get_hyp mid-utterance), final after end_utt."""
        if self._in_utt and self._stream is not None:
            return self.search.stream_partial(self._stream)
        return self._hyp

    def seg(self) -> List[Segment]:
        return self._hyp.segments if self._hyp else []

    def nbest(self, n: int = 10) -> List[Hypothesis]:
        lat = self.get_lattice()
        return lat.nbest(n, start_lmwid=self.search.start_lmwid)

    def get_lattice(self):
        return self.search.get_lattice()

    def get_prob(self) -> float:
        """Posterior probability of the best hypothesis (ps_get_prob)."""
        lat = self.search.get_lattice()
        post = lat.posterior(ascale=1.0 / float(self.config["ascale"]))
        best = self._hyp
        if not best or not best.segments:
            return 0.0
        p = 0.0
        for seg in best.segments:
            for n in lat.nodes:
                if (n.word == seg.word and n.sf == seg.start_frame
                        and n.ef == seg.end_frame):
                    p += float(post[n.id])
                    break
        return float(np.exp(p / max(len(best.segments), 1)))

    def add_word(self, word: str, phones: List[str]) -> int:
        """Runtime word addition (ps_add_word).  Takes effect at the next
        search (re)initialization."""
        return self.dict.add_word(word, phones)

    def set_lm(self, name: str) -> None:
        """Switch to a named LM from -lmctl (ps_set_search / ngram_model_set
        select capability); rebuilds the search module."""
        lm = self.lmset.select(name)
        self.search = NgramSearch(lm, self.dict, self.mdef, self.tmat,
                                  self.scorer, config=self.config)

    # ------------------------------------------------------------------
    def align(self, feats_or_raw: np.ndarray, words: List[str],
              raw: bool = False):
        """Forced alignment (state_align / sphinx3_align capability):
        returns (word segments, phone segments, state ids, score)."""
        from .decode.align import AlignSearch
        if raw:
            cep = np.asarray(self.fe.process(
                np.asarray(feats_or_raw, np.float32)))
            feats = np.asarray(self.fp.compute(cep))
        else:
            feats = np.asarray(feats_or_raw)
        return AlignSearch(self.dict, self.mdef, self.tmat,
                           self.scorer).align(feats, words)

"""N-gram (trigram) large-vocabulary decoder: dense Viterbi over mpx channels.

Capability parity with the pocketsphinx two-pass N-gram search (reference:
pocketsphinx/src/libpocketsphinx/ngram_search_fwdtree.c token-passing pass 1,
ngram_search_fwdflat.c flat-lexicon pass 2, ngram_search.c:360-440 backpointer
table) and the sphinx3 time-switch-tree decoder
(sphinx3/src/libs3decoder/libsearch/srch_time_switch_tree.c) — redesigned as
ONE dense pass for an accelerator (SURVEY.md §7 step 6):

- Channels (one HMM each, lexgraph.py) are evaluated densely: one batched
  `hmm_step` updates ALL channels' [C, S] scores per frame.  Left cross-word
  context is *multiplexed*: the senone-sequence id is an int payload riding
  the Viterbi argmax (the reference's mpx hmm ssid switching, hmm.h:155-177),
  so word-begin channels need no per-context fan-out.  Right cross-word
  context is exact fan-out for small vocabularies and sphinx3-style
  composite triphones for large ones (rc_mode, lexgraph.py).
- The backpointer table is a fixed-size device tape in the scan carry:
  E slots per frame (top-E word exits, the analog of -maxwpf absolute
  pruning), each recording (word, score, prev-slot, LM history pair) plus
  per-right-context-variant exit scores — the dense analog of the per-bp
  `bscore_stack` (ngram_search.h:109-126).
- Cross-word LM application follows ngram_search word_transition semantics:
  per frame, entry score of word w = max over this frame's exit slots e of
  exit[e, rssid(e, firstphone(w))] + lw*P(w | h1[e], h2[e]) + log(wip);
  fillers instead add silpen/fillpen = log(pip)+log(sil/fillprob)
  (ngram_search.c:118-124) and are transparent to the LM history (real_wid
  semantics).  Each word takes a single best entry per frame (the
  reference's single-best cross-word approximation).  Trigram scores come
  from a dense [V+1,V+1,V] table for tiny vocabularies or per-slot dense
  rows built by scattering DMP successor lists (DeviceNgram.score_rows) —
  the device analog of the reference's tginfo caches
  (lm/lm3g_templates.c:46-260).
- Trigram history is exact per backpointer; like the reference we keep a
  single history per (word, frame) — its rc score stack shares the best
  path's history (ngram_search_save_bp semantics).
"""

from __future__ import annotations

import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.dict import Dictionary
from ..models.dict2pid import Dict2Pid
from ..models.mdef import Mdef
from ..models.ngram import NgramModel
from ..models.ngram_device import DeviceNgram
from ..models.tmat import TransitionMatrices
from ..ops.hmm import (NEG_INF, hmm_bands, hmm_enter, hmm_enter_bm,
                       hmm_enter_sm, hmm_step, hmm_step_bm, hmm_step_sm)
from ..utils.config import Arg, Config
from .fsg_search import Hypothesis, Segment
from .lexgraph import WordGraph, build_word_graph

NGRAM_ARGS = [
    Arg("lw", float, 6.5, "Language model probability weight"),
    Arg("wip", float, 0.65, "Word insertion penalty"),
    Arg("pip", float, 1.0, "Phone insertion penalty"),
    Arg("silprob", float, 0.005, "Silence word transition probability"),
    Arg("fillprob", float, 1e-8, "Filler word transition probability"),
    Arg("beam", float, 1e-48, "Beam width applied to every frame in Viterbi search"),
    Arg("wbeam", float, 7e-29, "Beam width applied to word exits"),
    Arg("maxwpf", int, 32, "Maximum distinct word exits recorded per frame"),
    Arg("pl_window", int, 0,
        "Phone-loop lookahead window in frames (0 = off).  When set, a "
        "CI-phone loop evaluated over the next pl_window frames tightens "
        "the channel beam (phone_loop_search capability consulted by the "
        "main search, ngram_search_fwdtree.c:1390-1420)"),
    Arg("pl_weight", float, 3.0, "Weight on phone-loop lookahead penalties"),
    Arg("rcmode", str, "auto",
        "Cross-word right-context handling: 'fanout' (exact per-context "
        "word-final channels, pocketsphinx alloc_all_rc) or 'composite' "
        "(sphinx3 composite triphones, scalable to large vocabularies); "
        "'auto' picks fanout below 1000 words"),
    Arg("lcmode", str, "auto",
        "Cross-word left-context handling: 'mpx' (multiplexed senone "
        "sequences riding the Viterbi argmax, exact, pocketsphinx root-"
        "channel semantics) or 'composite' (per-state max over left "
        "contexts, sphinx3 lextree composite triphones — makes every "
        "channel's senones static, enabling the frame-parallel large-"
        "vocabulary decode path); 'auto' follows rcmode"),
    Arg("lexmode", str, "auto",
        "Lexicon layout: 'flat' (one phone chain per word, per-word LM "
        "at entry) or 'tree' (prefix-shared channels, the reference's "
        "lexicon-tree idea — ngram_search_fwdtree.c:67-149 / sphinx3 "
        "lextree: word identity resolved at the final phone, unigram "
        "lookahead smeared in the tree, exact trigram applied at the "
        "exit readout).  'auto' picks tree at >= 10k words with "
        "composite contexts; tree requires composite lc+rc"),
    Arg("treela", str, "bg",
        "Tree lookahead smear: 'bg' applies a per-re-entry-history BIGRAM "
        "subtree-max correction at root entry on top of the static "
        "unigram smear (the reference's LM lookahead at word_transition / "
        "lextree_enter; exactly cancelled at the exit readout), 'ug' "
        "keeps the static unigram smear only"),
    Arg("nlextree", int, 1,
        "Number of parallel lexicon-tree copies in lexmode='tree' "
        "(sphinx3 -Nlextree): copy n holds the n-th best history-"
        "distinct cross-word entry per frame, recovering accuracy the "
        "single-best-entry approximation loses"),
    Arg("maxbatch", int, 16,
        "Largest utterance batch handed to the device as ONE program; "
        "bigger decode_batch calls are chunked (outsized batches crashed "
        "the device runtime of the accelerator this decoder was first "
        "built for, at large vocabularies).  0 disables chunking"),
    Arg("bestpath", bool, False,
        "Run lattice trigram rescoring after Viterbi (ps -bestpath)"),
    Arg("bestpathlw", float, 9.5, "Language weight for bestpath rescoring"),
    Arg("latbeam", float, 0.0,
        "Lattice link beam for bestpath rescoring: links off every path "
        "within this (linear-probability) width of the bigram-approximate "
        "best path are skipped by the exact trigram DP.  Default 0 = "
        "fully exact rescoring; set e.g. 1e-40 for the pruned fast path "
        "(measured score-identical on the WSJ bench, PERF.md §5)"),
    Arg("ascale", float, 20.0, "Inverse acoustic scale for lattice posteriors"),
    Arg("prune", bool, True,
        "Apply beam pruning.  Matches the reference's behavior: the beams act "
        "as a path-stability prior, not just a speed knob — marginal "
        "minimum-duration word insertions die at the beam as they do in the "
        "reference (ngram_search_fwdtree.c prune_channels/save_bp)"),
]


class NgramVocab:
    """Search vocabulary: dict words in the LM + fillers, with LM ids."""

    def __init__(self, lm: NgramModel, d: Dictionary):
        words: List[int] = []
        lmwid: List[int] = []
        is_fil: List[bool] = []
        for wid in range(d.n_word):
            w = d.base_str(wid)
            if w == "<s>":
                continue
            if d.is_filler(wid):
                words.append(wid)
                lmwid.append(-1)
                is_fil.append(True)
            else:
                lw = lm.word_id(w)
                if lw < 0:
                    continue
                words.append(wid)
                lmwid.append(lw)
                is_fil.append(False)
        if not words:
            raise ValueError("no dictionary word occurs in the LM")
        self.dict_wid = np.asarray(words, np.int32)
        self.lmwid = np.asarray(lmwid, np.int32)
        self.is_filler = np.asarray(is_fil, bool)
        self.is_finish = np.asarray([d.base_str(w) == "</s>" for w in words], bool)
        self.word_str = [d.word_str(w) for w in words]
        self.n_word = len(words)


# Largest fanout/mpx channel graph the decoder will hand to the device.
# The exact cross-word configuration (rcmode='fanout', mpx left contexts)
# multiplexes per-context senone variants into every channel; larger graphs
# crashed the device runtime of the accelerator this decoder was first built
# for, and the limit has not been re-tested since.  Graphs above it fail
# fast with a ValueError naming the composite fallback instead of reaching
# the device.
FANOUT_CHAN_LIMIT = 100_000


def topk2(x, k: int, bs: int = 128):
    """Exact 2-stage top-k along the last axis: top-k over per-block
    maxima selects k candidate blocks, whose elements are re-ranked by a
    small top-k.  Exact (any block holding a true top-k element has a
    block max >= that element, so it ranks in the top-k blocks); selected
    blocks are sorted back to index order so equal values keep
    lowest-original-index priority among the selected blocks (ties can
    reorder vs direct top_k only when the k-th value ties across more
    than k blocks).  The direct lowering sorts far more than k elements."""
    M = x.shape[-1]
    nb = (M + bs - 1) // bs
    if nb <= k or M <= 4 * k * bs:
        return jax.lax.top_k(x, k)
    pad = nb * bs - M
    if pad:
        x = jnp.concatenate(
            [x, jnp.full(x.shape[:-1] + (pad,), NEG_INF, x.dtype)], -1)
    blk = x.reshape(x.shape[:-1] + (nb, bs))
    bm = blk.max(-1)
    _, bi = jax.lax.top_k(bm, k)
    bi = jnp.sort(bi, axis=-1)
    sel = jnp.take_along_axis(blk, bi[..., None], axis=-2)
    sel = sel.reshape(x.shape[:-1] + (k * bs,))
    tv, ti = jax.lax.top_k(sel, k)
    orig = (jnp.take_along_axis(bi, ti // bs, axis=-1) * bs + ti % bs)
    return tv, orig


class NgramSearch:
    """Trigram decoder over a senone scorer."""

    def __init__(self, lm: NgramModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer,
                 config: Optional[Config] = None, **kwargs):
        cfg = (config.copy() if config else Config(NGRAM_ARGS)).register(NGRAM_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.lw = float(cfg["lw"])
        self.log_wip = math.log(float(cfg["wip"]))
        log_pip = math.log(float(cfg["pip"]))
        self.log_pip = log_pip
        self.silpen = log_pip + math.log(float(cfg["silprob"]))
        self.fillpen = log_pip + math.log(float(cfg["fillprob"]))
        self.E = int(cfg["maxwpf"])
        self.prune = bool(cfg["prune"])
        self.log_beam = math.log(float(cfg["beam"]))
        self.log_wbeam = math.log(float(cfg["wbeam"]))

        self.lm = lm
        self.dict = d
        self.mdef = mdef
        self.scorer = scorer
        self.vocab = v = NgramVocab(lm, d)
        rc_mode = str(cfg["rcmode"])
        if rc_mode == "auto":
            rc_mode = "fanout" if v.n_word < 1000 else "composite"
        self.rc_mode = rc_mode
        lc_mode = str(cfg["lcmode"])
        if lc_mode == "auto":
            lc_mode = "mpx" if rc_mode == "fanout" else "composite"
        lex_mode = str(cfg["lexmode"])
        if lex_mode == "auto":
            lex_mode = ("tree" if v.n_word >= 10000
                        and rc_mode == "composite"
                        and lc_mode == "composite" else "flat")
        # Unigram lookahead for the tree smear (0 for fillers — they pay
        # their own penalties at the exit readout instead).
        ugla = None
        if lex_mode == "tree":
            ugla = np.where(v.is_filler, 0.0,
                            np.asarray(lm.ug_prob)[np.maximum(v.lmwid, 0)])
        g = self.graph = build_word_graph(v.dict_wid, d, mdef,
                                          Dict2Pid(mdef, d), rc_mode=rc_mode,
                                          lc_mode=lc_mode, lex_mode=lex_mode,
                                          ug_lookahead=ugla)
        if rc_mode == "fanout" and g.n_chan > FANOUT_CHAN_LIMIT:
            raise ValueError(
                f"rcmode='fanout' built {g.n_chan} multiplexed channels for "
                f"{v.n_word} words, above the supported limit of "
                f"{FANOUT_CHAN_LIMIT} (larger exact-fanout graphs crashed "
                "the device runtime); use rcmode='composite' — the sphinx3 "
                "composite-triphone approximation, and what rcmode='auto' "
                "selects at >= 1000 words — for this vocabulary")
        self._tree = g.lex_mode == "tree"
        self.nlextree = max(1, int(cfg["nlextree"])) if self._tree else 1
        # Static-senone fast path: with composite left contexts every
        # channel's senone row is fixed, so the [T, C, S] expansion is
        # frame-parallel; within-word propagation additionally reduces to a
        # shift when every chain channel's predecessor is the previous
        # channel (the builder emits channels word-major, position-minor).
        self._fast = g.lc_mode == "composite"
        chain = np.arange(g.n_chan) - 1
        self._chain_shift = bool(
            np.all((g.prev_chan == -1) | (g.prev_chan == chain)))
        self.E = min(self.E, v.n_word)
        self.dlm = DeviceNgram(lm)
        self.start_lmwid = lm.word_id("<s>")
        self.finish_lmwid = lm.word_id("</s>")
        self.sil_ci = mdef.sil if mdef.sil >= 0 else 0

        # Device constants.
        self._tp = jnp.asarray(tmat.log_tp[g.tmat_idx])      # [C, S, S+1]
        self._sing_sen = jnp.asarray(g.sing_sen)
        self._sing_valid = jnp.asarray(g.sing_valid)
        self._comp_mem = jnp.asarray(g.comp_mem)
        self._comp_valid = jnp.asarray(g.comp_valid)
        # width-bucketed composite member tables (lexgraph comp_groups)
        self._comp_groups = tuple(
            jnp.asarray(a) for a in (g.comp_groups or [g.comp_mem]))
        self._static_xs = jnp.asarray(g.static_xs)
        self._word_of = jnp.asarray(g.word_of)
        self._is_entry = jnp.asarray(g.is_entry)
        self._lc_row = jnp.asarray(g.lc_row)
        self._lcmap = jnp.asarray(g.lcmap)
        self._exit_tab = jnp.asarray(g.exit_tab)
        self._exit_tab_c = jnp.asarray(np.maximum(g.exit_tab, 0))
        self._rssid = jnp.asarray(g.rssid.astype(np.int32))
        self._prev_chan = jnp.asarray(g.prev_chan)
        self._prev_chan_c = jnp.asarray(np.maximum(g.prev_chan, 0))
        self._ci_of = jnp.asarray(g.ci_of)
        # Phone-loop lookahead tables: each CI phone's senone row.
        self.pl_window = int(cfg["pl_window"])
        self.pl_weight = float(cfg["pl_weight"])
        ci_sen = mdef.sseq[mdef.phone_ssid[: mdef.n_ciphone]].astype(np.int64)
        bad = int(np.int32(np.uint16(0xFFFF)))
        self._ci_sen = jnp.asarray(np.where(ci_sen == bad, 0, ci_sen))
        self._ci_sen_valid = jnp.asarray(ci_sen != bad)
        self._firstci = jnp.asarray(g.firstci)
        self._lastci = jnp.asarray(g.lastci)
        self._lmwid = jnp.asarray(v.lmwid)
        self._lmwid_c = jnp.asarray(np.maximum(v.lmwid, 0))
        self._is_filler = jnp.asarray(v.is_filler)
        # <sil>/<s>/</s> get silpen; other fillers fillpen (ngram_search.c:645-650).
        fp = np.full(v.n_word, self.fillpen, np.float32)
        for k, w in enumerate(v.word_str):
            if w in ("<sil>", "</s>", "<s>"):
                fp[k] = self.silpen
        self._fil_pen = jnp.asarray(fp)
        # Static initial entries with history (<s>,) and silence left context.
        ent0 = np.zeros(v.n_word, np.float32)
        for k in range(v.n_word):
            if v.is_filler[k]:
                ent0[k] = fp[k]
            else:
                ent0[k] = self.lw * self.lm.bg_score(
                    self.start_lmwid, int(v.lmwid[k])) + self.log_wip
        entc0 = np.full((g.n_chan,), float(NEG_INF), np.float32)
        if self._tree:
            # Tree entries carry only the lookahead smear; the exact LM
            # (including P(w|<s>) for utterance-initial words) is applied
            # at the exit readout from the (<s>, -1) history payload.
            self._setup_tree_bgla(g, v)
            entc0[g.is_entry] = self.lw * g.la[g.is_entry]
            if self.use_bgla:
                # initial entries get the <s>-context bigram correction
                entc0[self._roots_np] += self._corr0_np
        else:
            entc0[g.is_entry] = ent0[g.word_of[g.is_entry]]
        self._entc0 = jnp.asarray(entc0)
        # Initial mpx rows: silence left context.
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], self.sil_ci]
        self._entxs0 = jnp.asarray(xs0)
        self._ent0 = ent0
        self._fil_pen_np = fp
        self._is_finish_d = jnp.asarray(v.is_finish)
        if self._fast:
            self._exit_col = jnp.asarray(np.maximum(g.exit_tab[:, 0], 0))
            self._tp_bands = tuple(jnp.asarray(b) for b in
                                   hmm_bands(tmat.log_tp[g.tmat_idx]))
            if self._tree:
                # lw-scaled lookahead tables: per-entry-channel smear,
                # telescoping within-word delta, and the per-word exit
                # correction (= lw * ug(w); 0 for fillers).
                la = self.lw * g.la.astype(np.float64)
                has_prev = g.prev_chan >= 0
                delta = np.where(has_prev,
                                 la - la[np.maximum(g.prev_chan, 0)], 0.0)
                self._la_entry_c = jnp.asarray(la.astype(np.float32))
                self._la_delta_c = jnp.asarray(delta.astype(np.float32))
                self._la_word_lw = jnp.asarray(
                    (self.lw * g.la_word).astype(np.float32))
                self._core_static = self._make_core_tree()
            else:
                self._core_static = self._make_core_static()
        else:
            self._core = self._make_core(hoisted=True)
            self._core_inline = self._make_core(hoisted=False)
        self._last: Optional[tuple] = None
        self._last_batch: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _xscores_all(self, scores):
        """Extended-senone-sequence scores for ALL frames at once:
        [T, n_sen] -> [T, n_xs, S].  Singleton rows are a direct gather;
        composite rows (ordered last) gather members and max (composite
        triphones, lextree.c semantics).  Hoisted OUT of the frame scan —
        these gathers have no carry dependence, so they run frame-parallel
        before the sequential Viterbi loop."""
        neg = jnp.float32(NEG_INF)
        g = self.graph
        base = jnp.where(self._sing_valid[None],
                         scores[:, self._sing_sen], neg)
        comp = jnp.concatenate(
            [jnp.max(scores[:, cg], axis=-1) for cg in self._comp_groups],
            axis=1)
        comp = jnp.where(self._comp_valid[None], comp, neg)
        return jnp.concatenate(
            [base[:, : g.n_sing], comp[:, : g.n_xs - g.n_sing]], axis=1)

    def _init_hmmc(self):
        """Initial HMM carry: all channels silent except the static <s>
        entries; word-history payloads (hw2, hw1) start at (<s>, -1)."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        alpha = jnp.full((C, S), NEG_INF)
        hist = jnp.full((C, S), -1, jnp.int32)
        xsr = jnp.broadcast_to(self._static_xs[:, None],
                               (C, S)).astype(jnp.int32)
        hw2 = jnp.full((C, S), self.start_lmwid, jnp.int32)
        hw1 = jnp.full((C, S), -1, jnp.int32)
        alpha, (hist, xsr, hw2, hw1) = hmm_enter(
            alpha, (hist, xsr, hw2, hw1), self._entc0,
            (jnp.full((C,), -1, jnp.int32), self._entxs0,
             jnp.full((C,), self.start_lmwid, jnp.int32),
             jnp.full((C,), -1, jnp.int32)))
        return alpha, hist, xsr, hw2, hw1

    def _expand_block(self, scores_blk):
        """Frame-parallel static senone expansion for a block of K frames:
        [K, n_sen] -> [K, C, S].  With composite left contexts every
        channel's senone row is STATIC, so the expansion has no carry
        dependence; transposing time into the trailing (minor) dimension
        first makes each of the C row-gathers a [S, K]-wide contiguous
        copy instead of a per-element gather inside the frame scan."""
        g = self.graph
        neg = jnp.float32(NEG_INF)
        st = scores_blk.T                                     # [n_sen, K]
        base = jnp.where(self._sing_valid[..., None],
                         st[self._sing_sen], neg)             # [n_sing, S, K]
        comp = jnp.concatenate(
            [jnp.max(st[cg], axis=2) for cg in self._comp_groups], axis=0)
        comp = jnp.where(self._comp_valid[..., None], comp, neg)
        xsT = jnp.concatenate(
            [base[: g.n_sing], comp[: g.n_xs - g.n_sing]], axis=0)
        senT = xsT[self._static_xs]                           # [C, S, K]
        K = scores_blk.shape[0]
        return senT.transpose(2, 1, 0).reshape(K, -1)         # [K, S*C]

    def _init_hmmc_static(self):
        """Initial HMM carry for the static (composite-lc) path: no mpx
        payload; histories start at (<s>, -1).  STATE-MAJOR [S, C] layout —
        the channel axis is minor, so elementwise ops in the scan run over
        long contiguous rows (the [C, S] layout puts S=3 in the minor
        dimension)."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        alpha = jnp.full((S * C,), NEG_INF)
        hist = jnp.full((S * C,), -1, jnp.int32)
        alpha, (hist,) = hmm_enter_sm(
            alpha, (hist,), self._entc0,
            (jnp.full((C,), -1, jnp.int32),))
        return alpha, hist

    def _make_core_static(self):
        """Per-frame Viterbi core for STATIC-senone graphs (composite left
        contexts, the large-vocabulary path).  All channel-sized arrays are
        state-major [S, C] / stacked-small-major [k, C] so the big axis is
        minor (contiguous); consumes pre-expanded [S, C] senone scores; no
        mpx payload; within-word propagation is a pure shift (channels are
        word-major position-minor, so every chain channel's predecessor is
        channel c-1); entry routing is one [4, C] gather along the minor
        axis."""
        g, v = self.graph, self.vocab
        E, W, C = self.E, v.n_word, g.n_chan
        S, Vr = g.n_emit_state, g.n_rcvar
        neg = jnp.float32(NEG_INF)
        lw = jnp.float32(self.lw)
        log_wip = jnp.float32(self.log_wip)
        log_pip = jnp.float32(self.log_pip)
        use_rows = self.dlm.tg_dense is None

        def core(hmmc, inputs):
            # Tokens carry only the bp slot; per-slot histories live in
            # the side-table (PERF.md §7), read back for the E exits.
            alpha0, hist0, ht0 = hmmc                        # [S*C] flat
            sen_t, la_t, t, valid = inputs                   # sen_t [S*C]
            alpha, (hist,), ex, (exh,) = hmm_step_sm(
                alpha0, (hist0,), sen_t, self._tp_bands)

            if self.prune:
                bestscr = jnp.max(alpha)
                amax = jnp.max(alpha.reshape(S, C), axis=0)  # [C]
                if self.pl_window:
                    amax = amax + la_t[self._ci_of]
                keep = amax > bestscr + jnp.float32(self.log_beam)
                alpha = jnp.where(jnp.tile(keep, S), alpha, neg)
                ex = jnp.where(ex > bestscr + jnp.float32(self.log_wbeam),
                               ex, neg)

            # ---- word exits ----
            if Vr == 1:
                wex = ex[self._exit_col]                     # [W]
                wbp = exh[self._exit_col]                    # [W]
            else:
                exv = jnp.where(self._exit_tab >= 0,
                                ex[self._exit_tab_c], neg)
                wex = jnp.max(exv, axis=1)
                vwin = jnp.argmax(exv, axis=1)
                sel = jnp.take_along_axis(
                    self._exit_tab_c, vwin[:, None], axis=1)[:, 0]
                wbp = exh[sel]
            vals, wsel = topk2(wex, E)
            slot_rc = (vals[:, None] if Vr == 1
                       else jnp.where(self._exit_tab >= 0,
                                      ex[self._exit_tab_c], neg)[wsel])
            ok = (vals > neg * 0.5) & valid
            pe = wbp[wsel]                                   # [E]
            phist = ht0[jnp.maximum(pe, 0)]                  # [E, 2]
            prev_h2 = jnp.where(pe < 0, self.start_lmwid, phist[:, 0])
            prev_h1 = jnp.where(pe < 0, -1, phist[:, 1])
            wl = self._lmwid[wsel]
            fil = self._is_filler[wsel]
            h2 = jnp.where(fil, prev_h2, wl)
            h1 = jnp.where(fil, prev_h1, prev_h2)
            yrow = (jnp.where(ok, wsel, -1), jnp.where(ok, vals, neg),
                    pe, h2, h1, jnp.where(ok[:, None], slot_rc, neg))

            # ---- word entries ----
            if use_rows:
                rows = self.dlm.score_rows(h1, h2)           # [E, Vlm]
                lmw = jnp.take(rows, self._lmwid_c, axis=1)  # [E, W]
            else:
                lmw = self.dlm.score_tg(
                    h1[:, None], h2[:, None],
                    jnp.broadcast_to(self._lmwid_c[None, :], (E, W)))
            bonus = jnp.where(self._is_filler[None, :],
                              self._fil_pen[None, :],
                              lw * lmw + log_wip)            # [E, W]
            if Vr == 1:
                ac = slot_rc
            else:
                rcv = self._rssid[wsel][:, self._firstci]
                ac = jnp.take_along_axis(slot_rc, rcv, axis=1)
            cand = jnp.where(ok[:, None], ac + bonus, neg)
            ent_w = jnp.max(cand, axis=0)                    # [W]
            estar = jnp.argmax(cand, axis=0)
            has_ent = ent_w > neg * 0.5
            ebp_w = jnp.where(has_ent, t * E + estar, -1)

            # ---- record this frame's slot histories ----
            ht = jax.lax.dynamic_update_slice(
                ht0, jnp.where(valid, jnp.stack([h2, h1], 1), -1),
                (t * E, 0))

            # Entry routing: one [2, C] gather along the minor axis.
            entw2 = jnp.stack(
                [ent_w, ebp_w.astype(jnp.float32)], 0)       # [2, W]
            entc2 = entw2[:, self._word_of]                  # [2, C]

            # ---- within-word propagation: pure shift ----
            if self._chain_shift:
                prop = jnp.concatenate(
                    [jnp.full((1,), neg), ex[:-1] + log_pip])
                bsh = jnp.concatenate(
                    [jnp.full((1,), -1, exh.dtype), exh[:-1]])
            else:
                has_prev = self._prev_chan >= 0
                prop = jnp.where(has_prev,
                                 ex[self._prev_chan_c] + log_pip, neg)
                bsh = jnp.where(has_prev, exh[self._prev_chan_c], -1)

            entry_c = jnp.where(self._is_entry, entc2[0], prop)
            entry_b = jnp.where(self._is_entry,
                                entc2[1].astype(jnp.int32), bsh)
            alpha, (hist,) = hmm_enter_sm(
                alpha, (hist,), entry_c, (entry_b,))

            alpha = jnp.where(valid, alpha, alpha0)
            hist = jnp.where(valid, hist, hist0)
            return (alpha, hist, ht), yrow

        return core

    def _setup_tree_bgla(self, g, v) -> None:
        """Bigram-lookahead tables for the tree smear (VERDICT r4 #1).

        The static unigram smear ranks in-tree paths by max-ug of the
        reachable subtree — blind to the path's own history, which is what
        the reference's lookahead uses (ngram_search_fwdtree.c:1236-1421
        word_transition applies bigram/trigram lookahead at root entry;
        sphinx3 lextree.c:1093 lextree_enter).  Here every re-entry
        history h adds a per-root correction

            corr(h, r) = lw * (max_{w in subtree(r)} bg(h, w) - ugmax(r))

        at root entry (an upper bound via the backoff identity:
        bg(h,w) = max(explicit, bo(h)+ug(w)), so the max splits into
        bo(h)+ugmax(r) vs the explicit-successor part — admissible, so the
        true best path is never mis-pruned by it).  The correction a token
        received is recorded per (frame, copy) in a side-table and
        subtracted EXACTLY at the exit readout, where the true trigram
        replaces the whole smear — accuracy of corr affects only in-tree
        ranking/pruning, never final path scores.

        Storage is a CSR over (context, root) pairs with an explicit
        bigram successor in the subtree: corr(h, r) =
        max(lw*bo(h), csr_excess(h, r)) — the dense [Vlm, R] form would
        be ~0.8 GB at 123k words and gets embedded into the compile
        request; the CSR row is rebuilt per frame with an R-element
        scatter-max.
        `_corr0_np [R]` is the <s> row for utterance-initial entries;
        `_root_of_word [W]` maps each word to the root its tokens entered
        (the unique trie path)."""
        lm, W = self.lm, v.n_word
        prevc = g.prev_chan
        if g.exit_base >= 0:
            cur = np.arange(W, dtype=np.int64) + g.exit_base
        else:
            cur = np.asarray(np.maximum(g.exit_tab[:, 0], 0), np.int64)
        for _ in range(256):
            nxt = prevc[cur]
            m = nxt >= 0
            if not m.any():
                break
            cur = np.where(m, nxt, cur)
        roots_idx = np.nonzero(g.is_entry)[0]
        R = len(roots_idx)
        rid = np.full(g.n_chan, -1, np.int64)
        rid[roots_idx] = np.arange(R)
        root_of_word = rid[cur]
        assert (root_of_word >= 0).all(), "word path must start at a root"
        self._n_roots = R
        # Padded root count: the corr side-table lives FLAT in the scan
        # carry ([.., T*Rp]) so per-frame row writes are in-place
        # dynamic-update-slices; with R not a multiple of a 128-element
        # tile, a [T, R] layout can force a physical copy of the whole
        # table at every flat reshape.
        self._n_roots_pad = -(-R // 128) * 128
        self._roots_np = roots_idx
        self._roots_j = jnp.asarray(roots_idx.astype(np.int32))
        self._root_of_word_j = jnp.asarray(root_of_word.astype(np.int32))
        self.use_bgla = str(self.config["treela"]) == "bg"
        if not self.use_bgla:
            self._corr0_np = np.zeros(R, np.float32)
            self._corr0_j = jnp.asarray(self._corr0_np)
            return
        ugmax_root = np.asarray(g.la, np.float64)[roots_idx]
        is_fil = np.asarray(v.is_filler)
        lmw = np.asarray(v.lmwid, np.int64)
        okw = (~is_fil) & (lmw >= 0)
        has_word = np.zeros(R, bool)
        has_word[root_of_word[okw]] = True
        Vlm = lm.n_words
        lww = np.float32(self.lw)
        # Sparse excess entries: for every (context h, root r) with an
        # explicit bigram successor in subtree(r),
        #   excess = lw * (max explicit bg_prob - ugmax(r)).
        # An LM word contributes to the root of every pronunciation it
        # has in the search vocabulary.
        keys = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32)
        if len(lm.bg_wid):
            pairs = np.unique(
                np.stack([lmw[okw], root_of_word[okw]], 1), axis=0)
            pptr = np.searchsorted(pairs[:, 0], np.arange(Vlm + 1))
            cnt = np.diff(pptr)
            ctx = np.repeat(np.arange(Vlm),
                            np.diff(lm.bg_ptr)).astype(np.int64)
            wid = np.asarray(lm.bg_wid, np.int64)
            prob = np.asarray(lm.bg_prob, np.float32)
            ks, vs = [], []
            for p in range(int(cnt.max()) if len(cnt) else 0):
                sel = cnt[wid] > p
                r = pairs[pptr[wid[sel]] + p, 1]
                ks.append(ctx[sel] * R + r)
                vs.append(prob[sel] - ugmax_root[r].astype(np.float32))
            if ks:
                keys = np.concatenate(ks)
                vals = np.concatenate(vs)
                order = np.argsort(keys, kind="stable")
                keys, vals = keys[order], vals[order]
                uk, start = np.unique(keys, return_index=True)
                vmax = np.maximum.reduceat(vals, start)
                rr = (uk % R).astype(np.int64)
                keep = has_word[rr]
                keys, vals = uk[keep], (lww * vmax[keep]).astype(np.float32)
        rowptr = np.searchsorted(keys // R, np.arange(Vlm + 1))
        self._bgla_ptr = jnp.asarray(rowptr.astype(np.int32))
        self._bgla_root = jnp.asarray((keys % R).astype(np.int32)
                                      if len(keys) else
                                      np.zeros(1, np.int32))
        self._bgla_val = jnp.asarray(vals if len(vals) else
                                     np.zeros(1, np.float32))
        self._bgla_maxrow = int(np.diff(rowptr).max()) if len(keys) else 0
        self._bgla_base_j = jnp.asarray(
            (lww * np.asarray(lm.ug_bo, np.float32)).astype(np.float32))
        hw_pad = np.zeros(self._n_roots_pad, bool)
        hw_pad[:R] = has_word
        self._has_word_pad_j = jnp.asarray(hw_pad)
        # <s> row for utterance-initial entries (host-evaluated).
        corr0 = np.full(R, 0.0, np.float32)
        if self.start_lmwid >= 0:
            corr0[:] = lww * float(lm.ug_bo[self.start_lmwid])
            lo, hi = int(rowptr[self.start_lmwid]), int(
                rowptr[self.start_lmwid + 1])
            if hi > lo:
                rr = np.asarray(self._bgla_root)[lo:hi]
                np.maximum.at(corr0, rr, np.asarray(self._bgla_val)[lo:hi])
            corr0[~has_word] = 0.0
        self._corr0_np = corr0
        self._corr0_j = jnp.asarray(corr0)

    def _bgla_rows(self, h):
        """corr rows for history words h [L] -> [L, Rp] f32 (padded;
        pad columns are 0): the dense backoff base lw*bo(h) overlaid with
        the CSR excess entries via an R-bounded scatter-max; 0 for h < 0
        (no context: bg == ug) and for roots without LM words."""
        Rp = self._n_roots_pad
        L = h.shape[0]
        hc = jnp.maximum(h, 0)
        base = self._bgla_base_j[hc]                         # [L]
        corr = jnp.broadcast_to(base[:, None], (L, Rp + 1))
        if self._bgla_maxrow:
            lo = self._bgla_ptr[hc]
            hi = self._bgla_ptr[hc + 1]
            k = jnp.arange(self._bgla_maxrow, dtype=jnp.int32)[None, :]
            pos = lo[:, None] + k
            okk = pos < hi[:, None]
            idx = jnp.minimum(pos, self._bgla_root.shape[0] - 1)
            r = jnp.where(okk, self._bgla_root[idx], Rp)
            val = self._bgla_val[idx]
            rowsel = jnp.arange(L, dtype=jnp.int32)[:, None]
            corr = corr.at[rowsel, r].max(jnp.where(okk, val, NEG_INF))
        corr = corr[:, :Rp]
        corr = jnp.where(self._has_word_pad_j[None] & (h[:, None] >= 0),
                         corr, 0.0)
        return corr

    def _init_hmmc_tree(self, n_frames: int):
        """Carry for the N-copy tree core: (alpha [N, S, C], bp payload
        [N, S, C], history side-table [n_frames*E, 2]).  Tokens carry ONLY
        their backpointer slot through the HMMs; each tape slot's (h2, h1)
        lives in the side-table, read back for the E2-slot exit shortlist
        — two fewer full-C payload planes in the scan (the propagation
        gathers dominate the large-vocabulary scan).
        Copy 0 holds the initial <s> entries, copies 1.. start empty.
        With N == 1 the bp payload is an 8-bit entry AGE (255 = initial
        sentinel; slot = (t - age)*E, see _make_core_tree); with N > 1 it
        is the i32 tape slot, -1 denoting the (<s>, -1) initial history."""
        N = self.nlextree
        S, C = self.graph.n_emit_state, self.graph.n_chan
        a, h = self._init_hmmc_static()
        if N == 1:
            h = jnp.full((S * C,), 255, jnp.uint8)

        def exp(x, fill):
            rest = jnp.full((N - 1, S, C), fill, x.dtype)
            return jnp.concatenate([x.reshape(S, C)[None], rest], 0)

        ht = jnp.full((n_frames * self.E, 2), -1, jnp.int32)
        # per-(frame, copy) bigram-lookahead corrections applied at entry
        # (read back for exact cancellation at the exit readout).  FLAT
        # 1-D with padded row stride so the per-frame row write is an
        # in-place dynamic-update-slice and the point reads need no
        # layout-changing reshape.
        ct = jnp.zeros(
            (n_frames * N * (self._n_roots_pad if self.use_bgla else 1),),
            jnp.float32)
        return (exp(a, jnp.float32(NEG_INF)), exp(h, -1), ht, ct)

    def _make_core_tree(self):
        """Per-frame Viterbi core for the PREFIX-SHARED lexicon tree
        (lexmode='tree', composite lc+rc, state-major [S, C] layout —
        same calling convention as the static core, so the whole scan /
        block-expansion machinery is shared).

        The reference's fwdtree re-expressed dense (ngram_search_fwdtree.c
        delayed LM scoring; sphinx3 lextree + vithist_rescore): word
        identity is unknown at shared channels, so no per-word LM is
        applied at entry — channels carry a STATIC unigram-lookahead smear
        (telescoping deltas along within-word propagation, so the smear is
        a precomputed vector add) and every path keeps its entry history
        (h2, h1) as a token payload.  At the exit readout the smear
        cancels exactly and the true trigram P(w | h1, h2) is applied to a
        top-E2 shortlist (pre-selected on the smeared score = the
        unigram-exact path score), from which the top-E rescored exits
        become tape slots.  Cross-word re-entry takes the single best
        rescored exit for ALL roots (the composite-rc analog of
        word_transition's best-entry approximation — with one exit variant
        there is no right-context discrimination to exploit)."""
        g, v = self.graph, self.vocab
        E, W, C = self.E, v.n_word, g.n_chan
        S = g.n_emit_state
        N = self.nlextree
        if g.n_rcvar != 1:
            raise NotImplementedError("tree core requires composite rc")
        neg = jnp.float32(NEG_INF)
        lw = jnp.float32(self.lw)
        log_wip = jnp.float32(self.log_wip)
        log_pip = jnp.float32(self.log_pip)
        E2 = min(4 * E, W)
        psel_bonus = jnp.where(self._is_filler, self._fil_pen, log_wip)
        has_prev = jnp.asarray(g.prev_chan >= 0)
        xb = g.exit_base
        # With a single tree copy the re-entry always takes tape slot 0
        # of its frame (vals are sorted, ok is a prefix), so the bp slot
        # payload is recoverable as (t - age)*E from an 8-BIT entry-age —
        # and a u8 propagation gather is 2.3x cheaper than i32 (PERF.md
        # §8).  Age 255 is the <s>-initial sentinel; ages saturate there,
        # so a single word/filler instance older than 254 frames (2.54 s
        # inside one word — beyond any real word duration) would alias to
        # the initial history.
        use_age = N == 1

        def core(hmmc, inputs):
            # N parallel tree copies ride the leading axis
            # (sphinx3 -Nlextree, srch_time_switch_tree.c): copy n holds
            # the n-th-best HISTORY-DISTINCT cross-word entry, so the
            # single-best-entry approximation keeps N live histories.
            # Tokens carry ONLY the bp slot; histories come from the
            # side-table at the shortlist (PERF.md §7).
            alpha0, hist0, ht0, ct0 = hmmc                   # [N, S, C]
            sen_t, la_t, t, valid = inputs
            sen = jnp.broadcast_to(sen_t.reshape(S, C)[None], (N, S, C))
            if use_age:
                # saturating age increment (255 = initial sentinel)
                hist_in = jnp.minimum(hist0, jnp.uint8(254)) + jnp.uint8(1)
            else:
                hist_in = hist0
            alpha, (hist,), ex, (exh,) = hmm_step_bm(
                alpha0, (hist_in,), sen, self._tp_bands)

            if self.prune:
                bestscr = jnp.max(alpha)
                amax = jnp.max(alpha, axis=1)                # [N, C]
                if self.pl_window:
                    amax = amax + la_t[self._ci_of][None]
                keep = amax > bestscr + jnp.float32(self.log_beam)
                alpha = jnp.where(keep[:, None, :], alpha, neg)
                ex = jnp.where(ex > bestscr + jnp.float32(self.log_wbeam),
                               ex, neg)

            # ---- exit readout: best copy per word ----
            # Exit channels are a contiguous word-ordered block: readout
            # is a slice, not W row-gathers.
            if xb >= 0:
                wexn = ex[:, xb : xb + W]                    # [N, W]
                whn = exh[:, xb : xb + W]                    # [N, W]
            else:
                wexn = ex[:, self._exit_col]
                whn = exh[:, self._exit_col]
            if N == 1:
                wex, wbp = wexn[0], whn[0]
                nsel = None
            else:
                nsel = jnp.argmax(wexn, axis=0)              # [W]
                wex = jnp.max(wexn, axis=0)
                wbp = jnp.sum(jnp.where(
                    nsel[None] == jnp.arange(N, dtype=jnp.int32)[:, None],
                    whn, 0), axis=0)

            # ---- shortlist on the smeared score (ug + bigram corr) ----
            psel = wex + psel_bonus
            v2, wsel2 = topk2(psel, E2)                      # [E2]
            okp = (v2 > neg * 0.5) & valid
            if use_age:
                age2 = wbp[wsel2].astype(jnp.int32)          # [E2] u8 ages
                pe2 = jnp.where(age2 >= 255, -1, (t - age2) * E)
            else:
                pe2 = wbp[wsel2]                             # [E2] bp slots
            phist = ht0[jnp.maximum(pe2, 0)]                 # [E2, 2]
            ph2 = jnp.where(pe2 < 0, self.start_lmwid, phist[:, 0])
            ph1 = jnp.where(pe2 < 0, -1, phist[:, 1])
            wl2 = self._lmwid[wsel2]
            fil2 = self._is_filler[wsel2]
            # Exact trigram for the shortlist, replacing the smeared ug.
            # score_tg routes point queries by LM size: dense3 gather /
            # probe sweep (sparse LMs) / hashed tables (production-size
            # LMs — the LargeTrigramModel home) / CSR binary search.
            own = self.dlm.score_tg(ph1, ph2, jnp.maximum(wl2, 0))
            if self.use_bgla:
                # subtract the exact bigram correction this token received
                # at entry (recorded per (frame, copy) in ct)
                rw2 = self._root_of_word_j[wsel2]            # [E2]
                te2 = jnp.maximum(pe2, 0) // E
                n2 = (nsel[wsel2] if nsel is not None
                      else jnp.zeros_like(wsel2))
                cu = ct0[(te2 * N + n2) * self._n_roots_pad + rw2]
                cu = jnp.where(pe2 < 0, self._corr0_j[rw2], cu)
            else:
                cu = jnp.float32(0.0)
            resc = jnp.where(fil2, v2 - cu,
                             v2 - cu - self._la_word_lw[wsel2] + lw * own)
            resc = jnp.where(okp, resc, neg)

            # ---- top-E rescored exits -> tape slots ----
            vals, sel = jax.lax.top_k(resc, E)
            wsel = wsel2[sel]
            ok = vals > neg * 0.5
            pe = pe2[sel]
            prev_h2, prev_h1 = ph2[sel], ph1[sel]
            wl, fil = wl2[sel], fil2[sel]
            h2 = jnp.where(fil, prev_h2, wl)
            h1 = jnp.where(fil, prev_h1, prev_h2)
            yrow = (jnp.where(ok, wsel, -1), jnp.where(ok, vals, neg),
                    pe, h2, h1, jnp.where(ok[:, None], vals[:, None], neg))

            # ---- record this frame's slot histories in the side-table
            ht = jax.lax.dynamic_update_slice(
                ht0, jnp.where(valid, jnp.stack([h2, h1], 1), -1),
                (t * E, 0))

            # ---- re-entries: copy n takes the n-th history-distinct slot
            # (vals are sorted, so scan the E slots once per copy) ----
            ents, bps, hsels = [], [], []
            chosen_mask = jnp.zeros((E,), bool)
            for nth in range(N):
                avail = ok & ~chosen_mask
                # first available slot (vals sorted desc)
                idx = jnp.argmax(avail)
                has = jnp.any(avail)
                ents.append(jnp.where(has, vals[idx], neg))
                bps.append(jnp.where(has, t * E + idx, -1))
                hsels.append(jnp.where(has, h2[idx], -1))
                # mark every slot sharing this (h2, h1) trigram history
                # as used so later copies take genuinely distinct histories
                chosen_mask = chosen_mask | ((h2 == h2[idx]) & (h1 == h1[idx]))
            ent = jnp.stack(ents)                            # [N]
            ent_bp = jnp.stack(bps)

            # ---- within-word propagation with telescoping smear ----
            prop = jnp.where(has_prev[None],
                             ex[:, self._prev_chan_c] + log_pip
                             + self._la_delta_c[None], neg)
            bsh = jnp.where(has_prev[None], exh[:, self._prev_chan_c],
                            jnp.uint8(255) if use_age else -1)
            ie = self._is_entry[None]
            entry_base = ent[:, None] + self._la_entry_c[None]
            if self.use_bgla:
                # per-re-entry-history bigram corr at the roots (a static
                # R-element scatter per copy) + side-table row for
                # cancellation
                corr = self._bgla_rows(jnp.stack(hsels))     # [N, Rp]
                # valid-mask the VALUES (not the whole carry — that where
                # was a full-table rewrite per frame); rows of invalid
                # frames are never referenced (nothing enters)
                ct = jax.lax.dynamic_update_slice(
                    ct0, jnp.where(valid, corr, 0.0).reshape(-1),
                    (t * N * self._n_roots_pad,))
                entry_base = entry_base + jnp.zeros(
                    (N, C), jnp.float32).at[:, self._roots_j].set(
                        corr[:, : self._n_roots])
            else:
                ct = ct0
            entry_c = jnp.where(ie, entry_base, prop)
            if use_age:
                # freshly entered tokens have age 0
                entry_b = jnp.where(ie, jnp.uint8(0), bsh)
            else:
                entry_b = jnp.where(ie, ent_bp[:, None], bsh)
            alpha, (hist,) = hmm_enter_bm(
                alpha, (hist,), entry_c, (entry_b,))

            alpha = jnp.where(valid, alpha, alpha0)
            hist = jnp.where(valid, hist, hist0)
            return (alpha, hist, ht, ct), yrow

        return core

    # ------------------------------------------------------------------
    # Explicit-batch static path.  jax.vmap over the two-level scan makes
    # XLA's layout assignment insert physical transposes of every carry
    # array INSIDE the frame loop on the accelerator this decoder was first
    # built for.  Instead the batch is packed into the MINOR axis of
    # flat 1-D arrays — element (s, c, b) lives at (s*C + c)*B + b — so
    # elementwise ops have no layout freedom, channel gathers fetch
    # B-wide rows, and reductions reshape (free bitcasts) to [.., B].

    def _expand_block_batched(self, scores_blk):
        """[B, K, n_sen] -> [K, B, S, C] batch-major static expansion."""
        g = self.graph
        neg = jnp.float32(NEG_INF)
        B, K = scores_blk.shape[0], scores_blk.shape[1]
        C, S = g.n_chan, g.n_emit_state
        st = scores_blk.transpose(2, 1, 0).reshape(-1, K * B)  # [n_sen, K*B]
        base = jnp.where(self._sing_valid[..., None],
                         st[self._sing_sen], neg)          # [n_sing, S, K*B]
        comp = jnp.concatenate(
            [jnp.max(st[cg], axis=2) for cg in self._comp_groups], axis=0)
        comp = jnp.where(self._comp_valid[..., None], comp, neg)
        xsT = jnp.concatenate(
            [base[: g.n_sing], comp[: g.n_xs - g.n_sing]], axis=0)
        senT = xsT[self._static_xs]                        # [C, S, K*B]
        return senT.reshape(C, S, K, B).transpose(2, 3, 1, 0)

    def _get_core_static_batched(self, B: int):
        # Built per trace: the core closes over arrays computed while
        # tracing, which a cache would leak into the next trace.
        return (self._make_core_tree_batched(B) if self._tree
                else self._make_core_static_batched(B))

    def _make_core_tree_batched(self, B: int):
        """Batch-major [B, S, C] variant of the tree core (same layout
        rationale as _make_core_static_batched: vmap over the frame loop
        inserts per-frame layout transposes; explicit batch packing keeps
        channels minor)."""
        g, v = self.graph, self.vocab
        E, W, C = self.E, v.n_word, g.n_chan
        S = g.n_emit_state
        if g.n_rcvar != 1:
            raise NotImplementedError("tree core requires composite rc")
        neg = jnp.float32(NEG_INF)
        lw = jnp.float32(self.lw)
        log_wip = jnp.float32(self.log_wip)
        log_pip = jnp.float32(self.log_pip)
        E2 = min(4 * E, W)
        use_rows = self.dlm.tg_dense is None
        psel_bonus = jnp.where(self._is_filler, self._fil_pen, log_wip)
        has_prev = jnp.asarray(g.prev_chan >= 0)

        def core(hmmc, inputs):
            # Tokens carry an 8-bit entry AGE (255 = initial sentinel;
            # the batched re-entry always takes slot 0, so the tape slot
            # is (t - age)*E) — a u8 propagation gather moves a quarter of
            # the bytes of the i32 bp plane; per-utterance history
            # side-table supplies (h2, h1) for the E2 shortlist.
            alpha0, hist0, ht0, ct0 = hmmc                 # [B,S,C]/[B,TE,2]
            sen_t, t, validb = inputs                      # [B,S,C], [], [B]
            hist_in = jnp.minimum(hist0, jnp.uint8(254)) + jnp.uint8(1)
            alpha, (hist,), ex, (exh,) = hmm_step_bm(
                alpha0, (hist_in,), sen_t, self._tp_bands)

            if self.prune:
                bestscr = jnp.max(alpha, axis=(1, 2))             # [B]
                amax = jnp.max(alpha, axis=1)                     # [B, C]
                keep = amax > bestscr[:, None] + jnp.float32(self.log_beam)
                alpha = jnp.where(keep[:, None, :], alpha, neg)
                ex = jnp.where(
                    ex > bestscr[:, None] + jnp.float32(self.log_wbeam),
                    ex, neg)

            # ---- exit shortlist (smeared scores) ----
            # Contiguous word-ordered exit block: the [B, W] readout is a
            # slice; payloads are gathered only for the E2 shortlist.
            xb = g.exit_base
            if xb >= 0:
                wex = ex[:, xb : xb + W]                          # [B, W]
                wbp = exh[:, xb : xb + W]                         # [B, W]
            else:
                wex = ex[:, self._exit_col]
                wbp = exh[:, self._exit_col]
            psel = wex + psel_bonus[None, :]
            v2, wsel2 = topk2(psel, E2)                           # [B, E2]
            okp = (v2 > neg * 0.5) & validb[:, None]
            age2 = jnp.take_along_axis(wbp, wsel2,
                                       axis=1).astype(jnp.int32)  # [B, E2]
            pe2 = jnp.where(age2 >= 255, -1, (t - age2) * E)
            phist = jnp.take_along_axis(
                ht0, jnp.maximum(pe2, 0)[..., None], axis=1)      # [B,E2,2]
            ph2 = jnp.where(pe2 < 0, self.start_lmwid, phist[..., 0])
            ph1 = jnp.where(pe2 < 0, -1, phist[..., 1])
            wl2 = self._lmwid[wsel2]
            fil2 = self._is_filler[wsel2]
            own = self.dlm.score_tg(ph1, ph2, jnp.maximum(wl2, 0))
            if self.use_bgla:
                rw2 = self._root_of_word_j[wsel2]            # [B, E2]
                te2 = jnp.maximum(pe2, 0) // E
                cu = jnp.take_along_axis(
                    ct0, te2 * self._n_roots_pad + rw2, axis=1)
                cu = jnp.where(pe2 < 0, self._corr0_j[rw2], cu)
            else:
                cu = jnp.float32(0.0)
            resc = jnp.where(fil2, v2 - cu,
                             v2 - cu - self._la_word_lw[wsel2] + lw * own)
            resc = jnp.where(okp, resc, neg)

            # ---- top-E rescored exits -> tape slots ----
            vals, sel = jax.lax.top_k(resc, E)                    # [B, E]
            wsel = jnp.take_along_axis(wsel2, sel, axis=1)
            ok = vals > neg * 0.5
            pe = jnp.take_along_axis(pe2, sel, axis=1)
            prev_h2 = jnp.take_along_axis(ph2, sel, axis=1)
            prev_h1 = jnp.take_along_axis(ph1, sel, axis=1)
            wl = self._lmwid[wsel]
            fil = self._is_filler[wsel]
            h2 = jnp.where(fil, prev_h2, wl)
            h1 = jnp.where(fil, prev_h1, prev_h2)
            yrow = (jnp.where(ok, wsel, -1), jnp.where(ok, vals, neg),
                    pe, h2, h1,
                    jnp.where(ok[..., None], vals[..., None], neg))

            # ---- record this frame's histories in the side-table ----
            ht = jax.lax.dynamic_update_slice(
                ht0, jnp.where(validb[:, None, None],
                               jnp.stack([h2, h1], -1), -1),
                (0, t * E, 0))

            # ---- single best re-entry per lane ----
            has_ent = ok[:, 0]
            ent = jnp.where(has_ent, vals[:, 0], neg)             # [B]

            # ---- within-word propagation with telescoping smear ----
            prop = jnp.where(has_prev[None, :],
                             ex[:, self._prev_chan_c] + log_pip
                             + self._la_delta_c[None, :], neg)
            bsh = jnp.where(has_prev[None, :],
                            exh[:, self._prev_chan_c], jnp.uint8(255))
            ie = self._is_entry[None, :]
            entry_base = ent[:, None] + self._la_entry_c[None, :]
            if self.use_bgla:
                corr = self._bgla_rows(h2[:, 0])                  # [B, Rp]
                # value-masked in-place row write into the flat carry
                ct = jax.lax.dynamic_update_slice(
                    ct0, jnp.where(validb[:, None], corr, 0.0),
                    (0, t * self._n_roots_pad))
                B = ent.shape[0]
                entry_base = entry_base + jnp.zeros(
                    (B, self.graph.n_chan),
                    jnp.float32).at[:, self._roots_j].set(
                        corr[:, : self._n_roots])
            else:
                ct = ct0
            entry_c = jnp.where(ie, entry_base, prop)
            entry_b = jnp.where(ie, jnp.uint8(0), bsh)  # fresh entry: age 0
            alpha, (hist,) = hmm_enter_bm(
                alpha, (hist,), entry_c, (entry_b,))

            vm = validb[:, None, None]
            alpha = jnp.where(vm, alpha, alpha0)
            hist = jnp.where(vm, hist, hist0)
            return (alpha, hist, ht, ct), yrow

        return core

    def _make_core_static_batched(self, B: int):
        """Batched static core: arrays batch-major [B, S, C] / [B, C] —
        channels minor (vmap and batch-minor packing both met
        layout-assignment transposes on the accelerator this decoder was
        first built for)."""
        g, v = self.graph, self.vocab
        E, W, C = self.E, v.n_word, g.n_chan
        S, Vr = g.n_emit_state, g.n_rcvar
        if Vr != 1:
            raise NotImplementedError(
                "batched static core requires composite rc (Vr == 1)")
        neg = jnp.float32(NEG_INF)
        lw = jnp.float32(self.lw)
        log_wip = jnp.float32(self.log_wip)
        log_pip = jnp.float32(self.log_pip)
        use_rows = self.dlm.tg_dense is None
        hp = jax.lax.Precision.HIGHEST

        def core(hmmc, inputs):
            # Tokens carry only the bp slot; per-utterance history
            # side-table supplies (h2, h1) for the E exits.
            alpha0, hist0, ht0 = hmmc                      # [B,S,C]/[B,TE,2]
            sen_t, t, validb = inputs                      # [B,S,C], [], [B]
            alpha, (hist,), ex, (exh,) = hmm_step_bm(
                alpha0, (hist0,), sen_t, self._tp_bands)

            if self.prune:
                bestscr = jnp.max(alpha, axis=(1, 2))             # [B]
                amax = jnp.max(alpha, axis=1)                     # [B, C]
                keep = amax > bestscr[:, None] + jnp.float32(self.log_beam)
                alpha = jnp.where(keep[:, None, :], alpha, neg)
                ex = jnp.where(
                    ex > bestscr[:, None] + jnp.float32(self.log_wbeam),
                    ex, neg)

            # ---- word exits (composite rc: one exit channel per word).
            # Readout via transpose + ROW gather: score + bp pack into
            # [C, 2B] so each gathered row is 2B wide.
            ex2 = jnp.stack([ex, exh.astype(jnp.float32)], 1)     # [B, 2, C]
            ex2T = ex2.transpose(2, 1, 0).reshape(C, 2 * B)
            wx2 = ex2T[self._exit_col].reshape(W, 2, B)           # [W, 2, B]
            wex = wx2[:, 0].T                                     # [B, W]
            vals, wsel = topk2(wex, E)                            # [B, E]
            ok = (vals > neg * 0.5) & validb[:, None]
            pe = jnp.take_along_axis(
                wx2[:, 1].T, wsel, axis=1).astype(jnp.int32)      # [B, E]
            phist = jnp.take_along_axis(
                ht0, jnp.maximum(pe, 0)[..., None], axis=1)       # [B, E, 2]
            prev_h2 = jnp.where(pe < 0, self.start_lmwid, phist[..., 0])
            prev_h1 = jnp.where(pe < 0, -1, phist[..., 1])
            wl = self._lmwid[wsel]
            fil = self._is_filler[wsel]
            h2 = jnp.where(fil, prev_h2, wl)
            h1 = jnp.where(fil, prev_h1, prev_h2)
            yrow = (jnp.where(ok, wsel, -1), jnp.where(ok, vals, neg),
                    pe, h2, h1,
                    jnp.where(ok[..., None], vals[..., None], neg))

            # ---- word entries ----
            if use_rows:
                rows = self.dlm.score_rows(h1.reshape(-1), h2.reshape(-1))
                lmw = jnp.take(rows, self._lmwid_c, axis=1)   # [B*E, W]
            else:
                lmw = self.dlm.score_tg(
                    h1.reshape(-1)[:, None], h2.reshape(-1)[:, None],
                    jnp.broadcast_to(self._lmwid_c[None, :], (B * E, W)))
            bonus = jnp.where(self._is_filler[None, :],
                              self._fil_pen[None, :],
                              lw * lmw + log_wip)             # [B*E, W]
            cand = jnp.where(ok.reshape(-1)[:, None],
                             vals.reshape(-1)[:, None] + bonus, neg)
            cand = cand.reshape(B, E, W)
            ent_w = jnp.max(cand, axis=1)                     # [B, W]
            estar = jnp.argmax(cand, axis=1)                  # [B, W]
            has_ent = ent_w > neg * 0.5
            ebp_w = jnp.where(has_ent, t * E + estar, -1)

            # ---- record this frame's slot histories ----
            ht = jax.lax.dynamic_update_slice(
                ht0, jnp.where(validb[:, None, None],
                               jnp.stack([h2, h1], -1), -1),
                (0, t * E, 0))

            # Entry routing: pack [W, 2*B], gather 2B-wide rows, return to
            # batch-major [B, 2, C].
            ent2 = jnp.stack(
                [ent_w, ebp_w.astype(jnp.float32)], 1)        # [B, 2, W]
            ent2T = ent2.transpose(2, 1, 0).reshape(W, 2 * B)
            entc = (ent2T[self._word_of].reshape(C, 2, B)
                    .transpose(2, 1, 0))                      # [B, 2, C]

            # ---- within-word propagation: pure shift along C ----
            if self._chain_shift:
                prop = jnp.concatenate(
                    [jnp.full((B, 1), neg), ex[:, :-1] + log_pip], axis=1)
                bsh = jnp.concatenate(
                    [jnp.full((B, 1), -1, exh.dtype), exh[:, :-1]],
                    axis=1)
            else:
                has_prev = self._prev_chan >= 0
                prop = jnp.where(has_prev[None, :],
                                 ex[:, self._prev_chan_c] + log_pip, neg)
                bsh = jnp.where(has_prev[None, :],
                                exh[:, self._prev_chan_c], -1)

            ie = self._is_entry[None, :]
            entry_c = jnp.where(ie, entc[:, 0], prop)
            entry_b = jnp.where(ie, entc[:, 1].astype(jnp.int32), bsh)
            alpha, (hist,) = hmm_enter_bm(
                alpha, (hist,), entry_c, (entry_b,))

            vm = validb[:, None, None]
            alpha = jnp.where(vm, alpha, alpha0)
            hist = jnp.where(vm, hist, hist0)
            return (alpha, hist, ht), yrow

        return core

    def device_decode_batched(self, feats, valid):
        """Explicit-batch static decode: [B, Tp, D] + [B, Tp] -> tape
        arrays, each [B, ...] (same per-utterance layout the results layer
        indexes).  No vmap in the frame loop — see the packing note
        above."""
        g, E = self.graph, self.E
        B, Tp = feats.shape[0], feats.shape[1]
        C, S = g.n_chan, g.n_emit_state
        scores = jax.vmap(self.scorer.score)(feats)        # [B, Tp, n_sen]
        per_frame = (g.n_chan * S + g.comp_mem.size) * 4 * B
        KB = next(k for k in (100, 50, 25, 20, 10, 5, 4, 2, 1)
                  if self.FRAME_BUCKET % k == 0
                  and k * per_frame <= (192 << 20))
        NB = Tp // KB
        core = self._get_core_static_batched(B)
        rep = lambda a: jnp.broadcast_to(                  # noqa: E731
            a.reshape(S, C)[None], (B, S, C))
        if self._tree:
            a0, h0, _, _ = self._init_hmmc_tree(Tp)
            Rp = self._n_roots_pad if self.use_bgla else 1
            hmmc = (jnp.broadcast_to(a0, (B, S, C)),
                    jnp.broadcast_to(h0, (B, S, C)),
                    jnp.full((B, Tp * E, 2), -1, jnp.int32),
                    jnp.zeros((B, Tp * Rp), jnp.float32))
        else:
            a0, h0 = self._init_hmmc_static()
            hmmc = (rep(a0), rep(h0),
                    jnp.full((B, Tp * E, 2), -1, jnp.int32))
        sc_r = scores.reshape(B, NB, KB, -1).transpose(1, 0, 2, 3)
        val_r = valid.reshape(B, NB, KB).transpose(1, 2, 0)  # [NB, KB, B]
        t0s = jnp.arange(NB, dtype=jnp.int32) * KB

        def outer(carry, blk):
            sc_b, v_b, t0 = blk
            sen_b = self._expand_block_batched(sc_b)       # [KB, S*C*B]
            ts = t0 + jnp.arange(KB, dtype=jnp.int32)
            carry, ys = jax.lax.scan(core, carry, (sen_b, ts, v_b),
                                     unroll=self._scan_unroll())
            return carry, ys

        _, ys = jax.lax.scan(outer, hmmc, (sc_r, val_r, t0s))
        # ys arrays [NB, KB, B, E] (trc [..., 1]) -> per-utterance [B, T*E].
        def fold(a):
            extra = a.shape[4:]
            return (a.transpose(2, 0, 1, 3, *range(4, a.ndim))
                    .reshape((B, Tp * E) + extra))
        tw, tsc, tprev, th2, th1, trc = (fold(a) for a in ys)
        return tw, tsc, tprev, th2, th1, trc

    def _make_core(self, hoisted: bool = True):
        """The per-frame Viterbi core.  Takes the HMM carry (alpha + payload
        planes: backpointer slot, mpx xs row, and the two LM history words
        hw2/hw1 riding WITH the tokens — so the step never reads the tape)
        and precomputed xscores; returns the new carry and the frame's tape
        row [E] (word, score, prev slot, h2, h1, rc-variant scores).

        For small graphs every in-loop gather is reformulated as a ONE-HOT
        MATMUL, a design from the accelerator this decoder was first built
        for, whose gathers serialized; whether it pays on the GPU is an open
        measurement (ROADMAP).  Exactness is preserved: a one-hot row
        selects exactly one finite f32 value (1*v + 0*rest = v bit-exactly),
        integers are < 2^24 so the f32 round trip is lossless, and
        Precision.HIGHEST keeps the matmul in full f32.  Static index
        vectors become loop-invariant one-hots that XLA hoists out of the
        scan."""
        g, v = self.graph, self.vocab
        E, W, C = self.E, v.n_word, g.n_chan
        S, Vr = g.n_emit_state, g.n_rcvar
        neg = jnp.float32(NEG_INF)
        lw = jnp.float32(self.lw)
        log_wip = jnp.float32(self.log_wip)
        log_pip = jnp.float32(self.log_pip)
        use_rows = self.dlm.tg_dense is None
        Vlm = self.dlm.V
        hp = jax.lax.Precision.HIGHEST
        # One-hot dots are used only while the expanded matrices stay
        # small; large graphs keep the gather formulation.  The
        # estimate covers EVERY one-hot this core can build: the [W, Vr, C]
        # exit-variant select and the (Vlm+1)^2-wide history-plane one-hot
        # of the dense-trigram branch included (fanout graphs with many rc
        # variants / dense LMs otherwise blow past the cap).
        sizes = [C * C, C * W, C * S * g.n_xs, Vlm * W, W * Vr * C]
        if self.dlm.tg_dense is not None:
            sizes.append((Vlm + 1) * (Vlm + 1) * E)
        small = max(sizes) <= (8 << 20)
        self._oh_gathers = small

        def oh(idx, n):
            return (idx[..., None] ==
                    jnp.arange(n, dtype=jnp.int32)).astype(jnp.float32)

        def dyn(idx, tab, n, out_int=False):
            """tab[idx] with tab [n] or [n, K]: one-hot dot when small."""
            if not small:
                out = tab[idx]
            else:
                out = jnp.tensordot(oh(idx, n), tab.astype(jnp.float32),
                                    axes=[[-1], [0]], precision=hp)
            return out.astype(jnp.int32) if out_int else out

        def core(hmmc, inputs):
            alpha0, hist0, xsr0, hw20, hw10 = hmmc
            xs_t, la_t, t, valid = inputs
            if not hoisted:
                # xs_t is the raw [n_sen] senone row; expand to xscores
                # in-loop (big graphs, where the [T, n_xs, S] hoisted
                # tensor would not fit device memory).
                xs_t = self._xscores_all(xs_t[None])[0]
            if small:
                # sen_c[c,s] = xs_t[xsr0[c,s], s] as a batched one-hot dot.
                sen_c = jnp.einsum('csx,xs->cs', oh(xsr0, g.n_xs), xs_t,
                                   precision=hp)
            else:
                sen_c = xs_t.reshape(-1)[
                    xsr0 * S + jnp.arange(S, dtype=jnp.int32)[None, :]]

            alpha, (hist, xsr, hw2, hw1), ex, (exh, _, exh2, exh1) = hmm_step(
                alpha0, (hist0, xsr0, hw20, hw10), sen_c, self._tp)

            if self.prune:
                # Channel beam + word-exit beam relative to the frame best
                # (prune_channels / save_bp threshold semantics); with
                # lookahead, channels whose phone is unsupported by the
                # next pl_window frames' CI phone loop are penalized into
                # the beam (phone_loop_search_score consultation).
                bestscr = jnp.max(alpha)
                amax = jnp.max(alpha, axis=1)
                if self.pl_window:
                    amax = amax + la_t[self._ci_of]
                keep = amax > bestscr + jnp.float32(self.log_beam)
                alpha = jnp.where(keep[:, None], alpha, neg)
                ex = jnp.where(ex > bestscr + jnp.float32(self.log_wbeam), ex, neg)

            # ---- word exits: per-variant readout [W, Vr] ----
            exv = jnp.where(self._exit_tab >= 0,
                            dyn(self._exit_tab_c, ex, C), neg)   # [W, Vr]
            wex = jnp.max(exv, axis=1)                           # [W]
            vwin = jnp.argmax(exv, axis=1)                       # [W]
            # Exit channel id + its history payloads for the winning
            # variant, read in one pass.
            exh3 = jnp.stack([exh, exh2, exh1], -1).astype(jnp.float32)
            if small:
                sel_oh = jnp.einsum('wv,wvc->wc', oh(vwin, Vr),
                                    oh(self._exit_tab_c, C), precision=hp)
                wexh3 = jnp.einsum('wc,ch->wh', sel_oh, exh3,
                                   precision=hp).astype(jnp.int32)
            else:
                sel = jnp.take_along_axis(
                    self._exit_tab_c, vwin[:, None], axis=1)[:, 0]
                wexh3 = exh3[sel].astype(jnp.int32)

            # ---- top-E word exits -> tape slots ----
            vals, wsel = topk2(wex, E)
            ok = (vals > neg * 0.5) & valid
            slot_rc = dyn(wsel, exv, W)                          # [E, Vr]
            peh = dyn(wsel, wexh3, W, out_int=True)              # [E, 3]
            pe = peh[:, 0]                                       # prev slot (-1 = <s>)
            prev_h2 = peh[:, 1]
            prev_h1 = peh[:, 2]
            wl = dyn(wsel, self._lmwid, W, out_int=True)
            fil = dyn(wsel, self._is_filler.astype(jnp.int32), W,
                      out_int=True) > 0
            h2 = jnp.where(fil, prev_h2, wl)
            h1 = jnp.where(fil, prev_h1, prev_h2)
            yrow = (jnp.where(ok, wsel, -1), jnp.where(ok, vals, neg),
                    pe, h2, h1, jnp.where(ok[:, None], slot_rc, neg))

            # ---- word entries (take effect next frame) ----
            if use_rows:
                rows = self.dlm.score_rows(h1, h2)               # [E, Vlm]
                if small:
                    lmw = jnp.einsum('ev,wv->ew', rows,
                                     oh(self._lmwid_c, Vlm), precision=hp)
                else:
                    lmw = jnp.take(rows, self._lmwid_c, axis=1)  # [E, W]
            elif small:
                # Dense-table trigram lookup as two one-hot matmuls in place
                # of the [E, W] element gather off tg_dense.  Row = (h1, h2)
                # plane select over (V+1)^2; column = static vocab map.
                dn = self.dlm.tg_dense                           # [V1,V1,V]
                V1 = dn.shape[0]
                i1 = jnp.where(h1 < 0, Vlm, h1)
                i2 = jnp.where(h2 < 0, Vlm, h2)
                plane = dn.reshape(V1 * V1, Vlm)
                rows_all = jnp.tensordot(oh(i1 * V1 + i2, V1 * V1), plane,
                                         axes=[[-1], [0]],
                                         precision=hp)           # [E, Vlm]
                lmw = jnp.einsum('ev,wv->ew', rows_all,
                                 oh(self._lmwid_c, Vlm), precision=hp)
            else:
                lmw = self.dlm.score_tg(
                    h1[:, None], h2[:, None],
                    jnp.broadcast_to(self._lmwid_c[None, :], (E, W)))
            bonus = jnp.where(self._is_filler[None, :],
                              self._fil_pen[None, :],
                              lw * lmw + log_wip)                # [E, W]
            # Acoustic part: the exiting word's rc variant serving THIS
            # word's initial CI phone (rssid readout; composite mode has a
            # single variant so this is just the composite exit score).
            if Vr == 1:
                ac = slot_rc                                     # [E, 1]
            else:
                rcv = dyn(wsel, self._rssid[:, self._firstci], W,
                          out_int=True)                          # [E, W]
                if small:
                    ac = jnp.einsum('ewv,ev->ew', oh(rcv, Vr), slot_rc,
                                    precision=hp)
                else:
                    ac = jnp.take_along_axis(slot_rc, rcv, axis=1)
            cand = jnp.where(ok[:, None], ac + bonus, neg)
            # Single best entry per word (word_transition semantics).
            ent_w = jnp.max(cand, axis=0)                        # [W]
            estar = jnp.argmax(cand, axis=0)                     # [W]
            has_ent = ent_w > neg * 0.5
            ebp_w = jnp.where(has_ent, t * E + estar, -1)
            eh = dyn(estar, jnp.stack(
                [dyn(wsel, self._lastci, W, out_int=True), h2, h1],
                -1).astype(jnp.float32), E, out_int=True)        # [W, 3]
            lcstar, eh2_w, eh1_w = eh[:, 0], eh[:, 1], eh[:, 2]

            # Entry channel routing: score + mpx xs row by left context.
            wo = self._word_of
            entw4 = jnp.stack(
                [ent_w, ebp_w.astype(jnp.float32),
                 eh2_w.astype(jnp.float32),
                 eh1_w.astype(jnp.float32)], -1)                 # [W, 4]
            entc4 = dyn(wo, entw4, W)                            # [C, 4]
            ent_c = entc4[:, 0]
            ent_bp_c = entc4[:, 1].astype(jnp.int32)
            ent_h2_c = entc4[:, 2].astype(jnp.int32)
            ent_h1_c = entc4[:, 3].astype(jnp.int32)
            lcstar_c = dyn(wo, lcstar, W, out_int=True)          # [C]
            if small:
                # lcmap[lc_row[c], lcstar_c[c]]: static row gather hoisted,
                # dynamic column as a one-hot contraction over n_ci.
                lcmap_sel = self._lcmap[self._lc_row].astype(jnp.float32)
                ent_xs_c = jnp.einsum('cn,cn->c', oh(lcstar_c, g.n_ci),
                                      lcmap_sel,
                                      precision=hp).astype(jnp.int32)
            else:
                ent_xs_c = self._lcmap.reshape(-1)[
                    self._lc_row * g.n_ci + lcstar_c]

            # ---- within-word propagation: in-degree <= 1 -> pure gather ----
            has_prev = self._prev_chan >= 0
            prev4 = jnp.stack([ex, exh3[:, 0], exh3[:, 1], exh3[:, 2]], -1)
            prop4 = dyn(self._prev_chan_c, prev4, C)             # [C, 4]
            prop = jnp.where(has_prev, prop4[:, 0] + log_pip, neg)
            bprop = jnp.where(has_prev, prop4[:, 1].astype(jnp.int32), -1)

            entry_c = jnp.where(self._is_entry, ent_c, prop)
            entry_b = jnp.where(self._is_entry, ent_bp_c, bprop)
            entry_x = jnp.where(self._is_entry, ent_xs_c, self._static_xs)
            entry_h2 = jnp.where(self._is_entry, ent_h2_c,
                                 prop4[:, 2].astype(jnp.int32))
            entry_h1 = jnp.where(self._is_entry, ent_h1_c,
                                 prop4[:, 3].astype(jnp.int32))
            alpha, (hist, xsr, hw2, hw1) = hmm_enter(
                alpha, (hist, xsr, hw2, hw1), entry_c,
                (entry_b, entry_x, entry_h2, entry_h1))

            # Padded frames are identity.
            alpha = jnp.where(valid, alpha, alpha0)
            hist = jnp.where(valid, hist, hist0)
            xsr = jnp.where(valid, xsr, xsr0)
            hw2 = jnp.where(valid, hw2, hw20)
            hw1 = jnp.where(valid, hw1, hw10)
            return (alpha, hist, xsr, hw2, hw1), yrow

        return core

    # ------------------------------------------------------------------
    FRAME_BUCKET = 100
    # Unrolling the frame scan amortizes per-iteration loop overhead and
    # lets XLA fuse across consecutive frames; the step is latency- (not
    # bandwidth-) bound at small channel counts, so this is nearly free.
    SCAN_UNROLL = 8

    def _scan_unroll(self) -> int:
        """Unroll factor for the static-path inner frame scan: small
        graphs are loop-overhead-bound (unroll pays); large graphs are
        bandwidth-bound and unrolling only bloats compile time."""
        return (self.SCAN_UNROLL
                if self.graph.n_chan * self.graph.n_emit_state <= (32 << 10)
                else 1)

    def device_decode(self, feats, valid):
        """Pure device program: padded feats [Tpad, D] + valid mask [Tpad] ->
        backpointer tape arrays.  jit/vmap/shard_map-compatible."""
        g, E = self.graph, self.E
        Tpad = feats.shape[0]
        scores = self.scorer.score(feats)                        # [Tpad, n_sen]
        if self.pl_window:
            # CI phone-loop lookahead: best per-phone frame score relative
            # to the frame best, maxed over the next pl_window frames.
            cis = jnp.where(self._ci_sen_valid[None],
                            scores[:, self._ci_sen],
                            jnp.float32(NEG_INF)).max(-1)        # [T, nci]
            rel = cis - jnp.max(cis, axis=1, keepdims=True)
            shifts = [jnp.concatenate([rel[dt:], jnp.repeat(rel[-1:], dt, 0)])
                      for dt in range(self.pl_window)]
            la = jnp.float32(self.pl_weight) * jnp.stack(shifts).max(0)
        else:
            la = jnp.zeros((Tpad, 1), jnp.float32)
        S = g.n_emit_state
        if self._fast:
            # Static-senone path: two-level scan.  The outer level expands
            # a block of KB frames' senone scores frame-parallel (the
            # expansion has no carry dependence); the inner scan runs the
            # Viterbi core over the pre-expanded block.  KB is the largest
            # divisor of FRAME_BUCKET whose [KB, C, S] block stays under
            # ~96 MB of device memory.
            per_frame = (g.n_chan * S + g.comp_mem.size) * 4
            KB = next(k for k in (100, 50, 25, 20, 10, 5, 4, 2, 1)
                      if self.FRAME_BUCKET % k == 0
                      and k * per_frame <= (96 << 20))
            NB = Tpad // KB
            if self._tree:
                hmmc = self._init_hmmc_tree(Tpad)
            else:
                hmmc = self._init_hmmc_static() + (
                    jnp.full((Tpad * E, 2), -1, jnp.int32),)
            la_r = la.reshape(NB, KB, -1)
            sc_r = scores.reshape(NB, KB, -1)
            val_r = valid.reshape(NB, KB)
            t0s = jnp.arange(NB, dtype=jnp.int32) * KB

            def outer(carry, blk):
                sc_b, la_b, v_b, t0 = blk
                sen_b = self._expand_block(sc_b)
                ts = t0 + jnp.arange(KB, dtype=jnp.int32)
                carry, ys = jax.lax.scan(self._core_static, carry,
                                         (sen_b, la_b, ts, v_b),
                                         unroll=self._scan_unroll())
                return carry, ys

            _, ys = jax.lax.scan(outer, hmmc, (sc_r, la_r, val_r, t0s))
            tw, tsc, tprev, th2, th1, trc = ys
            B = Tpad * E
            return (tw.reshape(B), tsc.reshape(B), tprev.reshape(B),
                    th2.reshape(B), th1.reshape(B),
                    trc.reshape(B, g.n_rcvar))
        hoist = Tpad * g.n_xs * S * 4 <= (128 << 20)
        if hoist:
            xs_in, core = self._xscores_all(scores), self._core
        else:
            xs_in, core = scores, self._core_inline
        unroll = self.SCAN_UNROLL if g.n_chan * S <= (16 << 10) else 1
        hmmc = self._init_hmmc()
        _, ys = jax.lax.scan(
            core, hmmc,
            (xs_in, la, jnp.arange(Tpad, dtype=jnp.int32), valid),
            unroll=unroll)
        # ys: ([T, E] x5, [T, E, Vr]) -> flat [T*E] tape arrays (same layout
        # the host results layer indexes by slot = t*E + e).
        tw, tsc, tprev, th2, th1, trc = ys
        B = Tpad * E
        return (tw.reshape(B), tsc.reshape(B), tprev.reshape(B),
                th2.reshape(B), th1.reshape(B),
                trc.reshape(B, g.n_rcvar))

    # ------------------------------------------------------------------
    def device_backtrace(self, tape, T):
        """1-best readout entirely ON DEVICE: final-slot selection (silence
        right context + P(</s>|h), ngram_search_finish semantics) plus the
        backpointer chase.  Batched decode then transfers only small
        [Tpad]-length segment arrays instead of the full tape — the tape
        stays device-resident for get_lattice/bestpath, which fetch it
        lazily.  Mirrors the host _final_slot/_backtrace pair."""
        tw, tsc, tprev, th2, th1, trc = tape
        E = self.E
        neg = jnp.float32(NEG_INF)
        n_slots = tw.shape[0]
        sidx = jnp.arange(n_slots, dtype=jnp.int32)
        valid = (tw >= 0) & (sidx < T * E)
        frame = sidx // E
        fbest = jnp.max(jnp.where(valid, frame, -1))
        # Final-slot scoring only needs the LAST frame with exits: slice
        # its E slots and run the rc readout + P(</s>|h) on E lanes
        # instead of all T*E (the full-tape CSR trigram search was a
        # per-decode cost growing with T*E — material at 60k vocabulary).
        base = jnp.maximum(fbest, 0) * E
        tw_f = jax.lax.dynamic_slice(tw, (base,), (E,))
        tsc_f = jax.lax.dynamic_slice(tsc, (base,), (E,))
        th2_f = jax.lax.dynamic_slice(th2, (base,), (E,))
        th1_f = jax.lax.dynamic_slice(th1, (base,), (E,))
        trc_f = jax.lax.dynamic_slice(trc, (base, 0),
                                      (E, trc.shape[1]))
        twc = jnp.maximum(tw_f, 0)
        valid_f = tw_f >= 0
        rc = trc_f[jnp.arange(E), self._rssid[twc, self.sil_ci]]
        s = jnp.where(rc > neg * 0.5, rc, tsc_f)
        tg = self.dlm.score_tg(
            th1_f, th2_f, jnp.full((E,), self.finish_lmwid, jnp.int32))
        s = s + jnp.where(self._is_finish_d[twc], 0.0,
                          jnp.float32(self.lw) * tg)
        s = jnp.where(valid_f, s, neg)
        e0 = jnp.argmax(s).astype(jnp.int32)
        score = s[e0]
        slot0 = jnp.where(fbest >= 0, base + e0, -1)

        # Pointer chase as a while_loop: the chain length is bounded by the
        # number of words.  The topology's true minimum word duration is 2
        # frames (a single-phone word can enter on the 0->2 skip transition
        # and leave from the exit band next frame), so the bound is T/2 —
        # NOT T/3 — or consecutive single-phone words could silently
        # truncate the earliest segments.  Under vmap the loop runs only
        # until the LONGEST lane finishes.  Outputs are packed into ONE
        # f32 array (word/start/end rows are exact integers < 2^24) so the
        # host fetch is a single transfer.
        maxseg = n_slots // (2 * E) + 2
        out0 = jnp.full((4, maxseg + 1), neg)
        out0 = out0.at[:3].set(-1.0)

        def cond(c):
            return (c[0] >= 0) & (c[1] < maxseg)

        def body(c):
            slot, i, out = c
            ok = slot >= 0
            s0 = jnp.maximum(slot, 0)
            prev = tprev[s0]
            start = jnp.where(prev >= 0, prev // E + 1, 0)
            ii = jnp.minimum(i, maxseg - 1)
            col = jnp.stack([tw[s0].astype(jnp.float32),
                             start.astype(jnp.float32),
                             (s0 // E).astype(jnp.float32), tsc[s0]])
            out = out.at[:, ii].set(jnp.where(ok, col, out[:, ii]))
            return (jnp.where(ok, prev, -1), i + ok.astype(jnp.int32), out)

        _, _, out = jax.lax.while_loop(
            cond, body, (slot0, jnp.int32(0), out0))
        return out.at[3, maxseg].set(score)

    def _hyp_from_chase(self, chase) -> Hypothesis:
        """Host assembly of a Hypothesis from the packed device_backtrace
        output [4, maxseg+1] (emitted final-word-first; rows = word, start,
        end, score; chase[3, -1] = final path score)."""
        v = self.vocab
        ks = chase[0, :-1].astype(np.int64)
        sts = chase[1, :-1].astype(np.int64)
        ens = chase[2, :-1].astype(np.int64)
        scs, score = chase[3, :-1], chase[3, -1]
        segs: List[Segment] = []
        for k, st, en, sc in zip(ks, sts, ens, scs):
            if k < 0:
                break
            segs.append(Segment(v.word_str[int(k)], int(st), int(en),
                                float(sc)))
        if not segs:
            return Hypothesis([], float("-inf"), [])
        segs.reverse()
        words = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or not self.dict.is_filler(wid):
                words.append(self.dict.base_str(wid) if wid >= 0 else s.word)
        return Hypothesis(words, float(score), segs)

    # ------------------------------------------------------------------
    # Streaming decode: the scan carry lives on device BETWEEN chunks, so
    # audio can be decoded as it arrives with partial hypotheses at any
    # point (ps_process_raw incremental loop, pocketsphinx.c:699-719, and
    # the gst plugin's partial results).
    CHUNK = 50

    def stream_start(self, max_frames: int = 3000) -> dict:
        """Begin a streaming utterance; returns the device-resident state.

        `max_frames` sizes the initial backpointer tape; the tape GROWS
        (doubling) when audio runs past it — long-form streams degrade to
        an occasional reallocation+recompile instead of an error
        (acmod_set_grow semantics, pocketsphinx acmod.c)."""
        g, E = self.graph, self.E
        if self._fast:
            if self._tree:
                hmmc = self._init_hmmc_tree(max_frames)
            else:
                hmmc = self._init_hmmc_static() + (
                    jnp.full((max_frames * E, 2), -1, jnp.int32),)
        else:
            hmmc = self._init_hmmc()
        B = max_frames * E
        tape = (jnp.full((B,), -1, jnp.int32), jnp.full((B,), NEG_INF),
                jnp.full((B,), -1, jnp.int32), jnp.full((B,), -1, jnp.int32),
                jnp.full((B,), -1, jnp.int32),
                jnp.full((B, g.n_rcvar), NEG_INF))
        W = self.pl_window
        if not hasattr(self, "_chunk_fn"):
            def sstep(carry, inputs):
                hmmc0, tape0 = carry[:-1], carry[-1]
                core = self._core_static if self._fast else self._core
                hmmc1, y = core(hmmc0, inputs)
                t = inputs[2]
                tw, tsc, pe, h2, h1, rc = y
                tw0, tsc0, tprev0, th20, th10, trc0 = tape0
                upd = jax.lax.dynamic_update_slice
                tape1 = (upd(tw0, tw, (t * E,)), upd(tsc0, tsc, (t * E,)),
                         upd(tprev0, pe, (t * E,)), upd(th20, h2, (t * E,)),
                         upd(th10, h1, (t * E,)), upd(trc0, rc, (t * E, 0)))
                return hmmc1 + (tape1,), None

            def chunk(carry, scores_ext, t0, valid):
                # scores_ext has CHUNK + pl_window frames: the lookahead
                # window of every emitted frame is fully inside the
                # extended block, so streaming lookahead == batch
                # (phone_loop consultation, ngram_search_fwdtree.c:1390).
                ts = t0 + jnp.arange(self.CHUNK, dtype=jnp.int32)
                if W:
                    cis = jnp.where(self._ci_sen_valid[None],
                                    scores_ext[:, self._ci_sen],
                                    jnp.float32(NEG_INF)).max(-1)
                    rel = cis - jnp.max(cis, axis=1, keepdims=True)
                    shifts = [rel[dt : dt + self.CHUNK] for dt in range(W)]
                    la = jnp.float32(self.pl_weight) * jnp.stack(shifts).max(0)
                else:
                    la = jnp.zeros((self.CHUNK, 1), jnp.float32)
                if self._fast:
                    xs = self._expand_block(scores_ext[: self.CHUNK])
                else:
                    xs = self._xscores_all(scores_ext[: self.CHUNK])
                carry, _ = jax.lax.scan(sstep, carry, (xs, la, ts, valid))
                return carry
            self._chunk_fn = jax.jit(chunk)
        return {"carry": hmmc + (tape,), "t": 0,
                "max_frames": max_frames,
                "pending": np.zeros((0, 0), np.float32)}

    def _ensure_tape(self, state: dict, need_frames: int) -> None:
        """Grow the device tape (doubling) to hold `need_frames` frames."""
        while state["t"] + need_frames > state["max_frames"]:
            E, g = self.E, self.graph
            grow = state["max_frames"] * E  # double
            hmmc, tape = state["carry"][:-1], state["carry"][-1]
            tw, tsc, tprev, th2, th1, trc = tape
            tape = (
                jnp.concatenate([tw, jnp.full((grow,), -1, jnp.int32)]),
                jnp.concatenate([tsc, jnp.full((grow,), NEG_INF)]),
                jnp.concatenate([tprev, jnp.full((grow,), -1, jnp.int32)]),
                jnp.concatenate([th2, jnp.full((grow,), -1, jnp.int32)]),
                jnp.concatenate([th1, jnp.full((grow,), -1, jnp.int32)]),
                jnp.concatenate([trc, jnp.full((grow, g.n_rcvar), NEG_INF)]),
            )
            if self._fast:
                # the per-frame carry side-tables grow with the tape:
                # histories [F*E, 2] and (tree mode) entry corrections
                # [F*N, R]
                if self._tree:
                    a, h, ht, ct = hmmc
                    ht = jnp.concatenate(
                        [ht, jnp.full((grow, 2), -1, jnp.int32)])
                    ct = jnp.concatenate(
                        [ct, jnp.zeros((ct.shape[0],), jnp.float32)])
                    hmmc = (a, h, ht, ct)
                else:
                    ht = hmmc[-1]
                    ht = jnp.concatenate(
                        [ht, jnp.full((grow, 2), -1, jnp.int32)])
                    hmmc = hmmc[:-1] + (ht,)
            state["carry"] = hmmc + (tape,)
            state["max_frames"] *= 2

    def stream_push(self, state: dict, feats: np.ndarray) -> dict:
        """Feed feature frames; full CHUNK quanta are decoded on device,
        the remainder is buffered until the next push or stream_end.
        With pl_window set, the last pl_window frames are additionally
        held back so every decoded frame sees its full lookahead."""
        feats = np.asarray(feats, np.float32)
        W = self.pl_window
        pend = state["pending"]
        buf = feats if pend.size == 0 else np.concatenate([pend, feats])
        n = buf.shape[0]
        k = max(n - W, 0) // self.CHUNK
        for i in range(k):
            chunk = buf[i * self.CHUNK : (i + 1) * self.CHUNK + W]
            self._ensure_tape(state, self.CHUNK)
            scores = self.scorer.score(jnp.asarray(chunk))
            state["carry"] = self._chunk_fn(
                state["carry"], scores, jnp.int32(state["t"]),
                jnp.ones((self.CHUNK,), bool))
            state["t"] += self.CHUNK
        state["pending"] = buf[k * self.CHUNK :]
        return state

    def _stream_flush(self, state: dict) -> int:
        """Decode the buffered remainder (padded, masked).  Returns the
        total number of REAL frames decoded.  Padding replicates the last
        real frame so end-of-stream lookahead matches the batch path's
        repeat-last-frame shifts."""
        pend = state["pending"]
        n = pend.shape[0]
        W = self.pl_window
        while n:
            take = min(n, self.CHUNK)
            blk = pend[:take]
            rest = pend[take:]
            need = self.CHUNK + W
            pad = np.repeat(blk[-1:], need, axis=0)
            pad[:take] = blk
            avail = min(rest.shape[0], need - take)
            if avail:
                pad[take : take + avail] = rest[:avail]
            self._ensure_tape(state, take)
            scores = self.scorer.score(jnp.asarray(pad))
            state["carry"] = self._chunk_fn(
                state["carry"], scores, jnp.int32(state["t"]),
                jnp.arange(self.CHUNK) < take)
            state["t"] += take
            pend = rest
            n = pend.shape[0]
        state["pending"] = np.zeros((0, 0), np.float32)
        return state["t"]

    def stream_partial(self, state: dict) -> Hypothesis:
        """Best hypothesis so far (partial result) — does not disturb the
        stream; the buffered remainder is not included."""
        if state["t"] == 0:
            return Hypothesis([], float("-inf"), [])
        tape = tuple(np.asarray(a) for a in state["carry"][-1])
        return self._backtrace(*tape, state["t"])

    def stream_end(self, state: dict) -> Hypothesis:
        """Finish the stream: flush the remainder and return the final
        hypothesis; the lattice is available via get_lattice()."""
        T = self._stream_flush(state)
        tape = tuple(np.asarray(a) for a in state["carry"][-1])
        self._last = tape + (T,)
        return self._backtrace(*tape, T)

    def decode(self, feats: np.ndarray,
               bestpath: Optional[bool] = None) -> Hypothesis:
        """feats [T, D] -> best hypothesis.  With bestpath, the Viterbi
        result is rescored over the word lattice at -bestpathlw (the
        reference's third pass, ps_search default pipeline)."""
        T = int(feats.shape[0])
        if T == 0:
            return Hypothesis([], float("-inf"), [])
        if not hasattr(self, "_single_fn"):
            def _full1(f, v, T):
                tape = self.device_decode(f, v)
                return tape, self.device_backtrace(tape, T)
            self._single_fn = jax.jit(_full1)
        Tpad = -(-T // self.FRAME_BUCKET) * self.FRAME_BUCKET
        fpad = np.zeros((Tpad, feats.shape[1]), np.float32)
        fpad[:T] = feats
        valid = jnp.arange(Tpad) < T
        tape, chase = self._single_fn(jnp.asarray(fpad), valid, jnp.int32(T))
        self._last = tuple(tape) + (T,)
        self._last_batch = None
        hyp = self._hyp_from_chase(np.asarray(chase))
        if bestpath is None:
            bestpath = bool(self.config["bestpath"])
        if bestpath and hyp.segments:
            lat = self.get_lattice()
            h2 = lat.bestpath(lw=float(self.config["bestpathlw"]),
                              start_lmwid=self.start_lmwid,
                              prune_beam=self._latbeam_ln())
            if h2.segments:
                hyp = h2
        return hyp

    def _latbeam_ln(self) -> float:
        """latbeam (linear prob) -> natural-log beam width for the native
        link pruner (0 = exact)."""
        lb = float(self.config["latbeam"])
        return -math.log(lb) if lb > 0.0 else 0.0

    def _rescore_batch(self, hyps: List[Hypothesis]) -> List[Hypothesis]:
        """Bestpath-rescore every utterance of the most recent batch:
        vectorized lattice construction + the native trigram DP, with
        utterances rescored in parallel threads (the native call releases
        the GIL).  Replaces the serial per-utterance host loop that made
        the bestpath pass cost ~200 s for a 7-utterance WSJ batch."""
        from concurrent.futures import ThreadPoolExecutor
        htapes = self._batch_host_tapes()
        Ts = self._last_batch[1]
        B = len(Ts)
        bplw = float(self.config["bestpathlw"])
        bw = self._latbeam_ln()
        lats = [self._lattice_from_tape(tuple(a[i] for a in htapes)
                                        + (Ts[i],))
                if hyps[i].segments else None for i in range(B)]

        def _one(i):
            if lats[i] is None:
                return hyps[i]
            h2 = lats[i].bestpath(lw=bplw, start_lmwid=self.start_lmwid,
                                  prune_beam=bw)
            return h2 if h2.segments else hyps[i]

        with ThreadPoolExecutor(max_workers=min(8, max(B, 1))) as ex:
            return list(ex.map(_one, range(B)))

    @property
    def _explicit_batch(self) -> bool:
        """decode_batch runs device_decode_batched (else vmap of
        device_decode)."""
        return (self._fast and not self.pl_window
                and self.graph.n_rcvar == 1 and self.nlextree == 1)

    def scan_core(self) -> str:
        """Which frame-scan core decode_batch runs: 'tree_batched',
        'static_batched', 'tree', 'static', or for the multiplexed
        (mpx-lc) core 'mpx/onehot' or 'mpx/gather' by how its in-loop
        lookups are formulated."""
        if self._fast:
            core = "tree" if self._tree else "static"
            return core + "_batched" if self._explicit_batch else core
        return "mpx/onehot" if self._oh_gathers else "mpx/gather"

    def decode_batch(self, feats_list, bestpath: Optional[bool] = None,
                     mesh=None) -> List[Hypothesis]:
        """Batched decode: all utterances padded to one bucket and run as a
        single vmapped device program — utterance-level data parallelism
        (SURVEY.md §2.10 P1), amortizing device latency and filling the
        chip.  Returns one Hypothesis per utterance.

        With a `mesh` that has a 'dp' axis, the padded batch is placed
        split over it, so each device decodes its share of the utterances
        (the batch is padded with empty utterances to a multiple of the
        axis size).

        Batches larger than -maxbatch are chunked into sequential device
        programs (oversized single programs crashed the device runtime of
        the accelerator this decoder was first built for, at large
        vocabularies); the chunk
        tapes are padded to a common length and re-joined so
        select_utt/get_lattice/bestpath address the whole batch."""
        if not feats_list:
            return []
        mb = int(self.config["maxbatch"])
        # Only large graphs crashed on oversized single programs;
        # small-graph batches (e.g. the 31-utterance
        # tidigits corpus) stay one program — chunking them would just
        # serialize the scan.  (_chunk_min_chan is overridable in tests.)
        if (mb > 0 and len(feats_list) > mb and mesh is None
                and self.graph.n_chan > getattr(self, "_chunk_min_chan",
                                                50_000)):
            out: List[Hypothesis] = []
            tape_chunks, Ts_all = [], []
            for lo in range(0, len(feats_list), mb):
                out.extend(self.decode_batch(feats_list[lo : lo + mb],
                                             bestpath))
                tape_chunks.append(self._batch_host_tapes())
                Ts_all.extend(self._last_batch[1])
            SE = max(t[0].shape[1] for t in tape_chunks)
            fills = (-1, NEG_INF, -1, -1, -1, NEG_INF)

            def padcat(k):
                parts = []
                for t in tape_chunks:
                    a = t[k]
                    pad = SE - a.shape[1]
                    if pad:
                        shape = (a.shape[0], pad) + a.shape[2:]
                        a = np.concatenate(
                            [a, np.full(shape, fills[k], a.dtype)], axis=1)
                    parts.append(a)
                return np.concatenate(parts, axis=0)

            self._last_batch = (tuple(padcat(k) for k in range(6)),
                                Ts_all, len(Ts_all) - 1)
            return out
        D = int(feats_list[0].shape[1])
        Ts = [int(f.shape[0]) for f in feats_list]
        if not hasattr(self, "_batch_fn"):
            if self._explicit_batch:
                # Explicit-batch path: vmap over the frame loop makes XLA
                # insert per-frame layout transposes (see the packing note
                # at device_decode_batched); only the cheap backtrace is
                # vmapped.
                def _full_b(f, T):
                    # valid derives from T on device (one fewer upload)
                    v = jnp.arange(f.shape[1])[None, :] < T[:, None]
                    tapes = self.device_decode_batched(f, v)
                    chase = jax.vmap(self.device_backtrace)(tapes, T)
                    return tapes, chase
                self._batch_fn = jax.jit(_full_b)
            else:
                def _full(f, T):
                    v = jnp.arange(f.shape[0]) < T
                    tape = self.device_decode(f, v)
                    return tape, self.device_backtrace(tape, T)
                self._batch_fn = jax.jit(jax.vmap(_full))
        # ONE bucket: the scan is the serial axis, so total device time is
        # driven by the number of scan steps (Tmax — utterances run in
        # parallel in the vmapped batch axis), and per-step cost is
        # dominated by fixed op overhead, not per-utterance work.  Splitting
        # into per-length groups runs more scan steps in all (the sum of the
        # group Tmaxes exceeds Tmax) and launches more programs.
        Tpad = -(-max(max(Ts), 1) // self.FRAME_BUCKET) * self.FRAME_BUCKET
        B = len(Ts)
        Bp = B if mesh is None else -(-B // mesh.shape["dp"]) * mesh.shape["dp"]
        fpad = np.zeros((Bp, Tpad, D), np.float32)
        for i, f in enumerate(feats_list):
            fpad[i, : Ts[i]] = f
        Tarr = np.asarray(Ts + [0] * (Bp - B), np.int32)
        if mesh is None:
            args = (jnp.asarray(fpad), jnp.asarray(Tarr))
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P
            args = (jax.device_put(fpad, NamedSharding(mesh, P("dp"))),
                    jax.device_put(Tarr, NamedSharding(mesh, P("dp"))))
        tapes, chase = self._batch_fn(*args)
        if Bp != B:
            tapes = tuple(a[:B] for a in tapes)
        # Only the small packed chase array is copied to the host; the tape
        # stays on device unless bestpath/get_lattice needs it (then it is
        # pulled in ONE bulk transfer per array and sliced on host).
        chase = np.asarray(chase)
        bp = bool(self.config["bestpath"]) if bestpath is None else bestpath
        self._last = None
        self._last_batch = (tapes, Ts, B - 1)
        out = [self._hyp_from_chase(chase[i]) for i in range(B)]
        return self._rescore_batch(out) if bp else out

    def decode_batch_cep(self, cep_list, fp, bestpath: Optional[bool] = None
                         ) -> List[Hypothesis]:
        """Fused cepstra -> features -> decode -> backtrace in ONE device
        program: ships [T, ncep] cepstra (13-dim) instead of computed
        features (up to 51-dim for s2_4x), cutting host->device traffic
        ~4x.  `fp` is the FeatPipeline whose device
        kernel runs inside the program (bit-identical features)."""
        if not cep_list:
            return []
        Ts = [int(c.shape[0]) for c in cep_list]
        n = int(cep_list[0].shape[1])
        # The jitted program captures `fp`'s device kernel in its closure —
        # key the cache on the pipeline identity so a different FeatPipeline
        # (different feat params / LDA) recompiles instead of silently
        # reusing stale features.
        if getattr(self, "_batch_cep_fp", None) is not fp:
            if hasattr(self, "_batch_cep_fn"):
                del self._batch_cep_fn
            self._batch_cep_fp = fp
        if not hasattr(self, "_batch_cep_fn"):
            if self._explicit_batch:
                def _full_b(c, T):
                    # valid derives from T on device: one fewer upload
                    v = jnp.arange(c.shape[1])[None, :] < T[:, None]
                    f = jax.vmap(
                        lambda ci, Ti: fp._padded_kernel(ci, Ti, True))(c, T)
                    tapes = self.device_decode_batched(f, v)
                    chase = jax.vmap(self.device_backtrace)(tapes, T)
                    return tapes, chase
                self._batch_cep_fn = jax.jit(_full_b)
            else:
                def _full(c, T):
                    v = jnp.arange(c.shape[0]) < T
                    f = fp._padded_kernel(c, T, True)
                    tape = self.device_decode(f, v)
                    return tape, self.device_backtrace(tape, T)
                self._batch_cep_fn = jax.jit(jax.vmap(_full))
        Tpad = -(-max(max(Ts), 1) // self.FRAME_BUCKET) * self.FRAME_BUCKET
        B = len(Ts)
        cpad = np.zeros((B, Tpad, n), np.float32)
        for i, c in enumerate(cep_list):
            cpad[i, : Ts[i]] = c
        tapes, chase = self._batch_cep_fn(
            jnp.asarray(cpad), jnp.asarray(Ts, dtype=jnp.int32))
        chase = np.asarray(chase)
        bp = bool(self.config["bestpath"]) if bestpath is None else bestpath
        self._last = None
        self._last_batch = (tapes, Ts, B - 1)
        out = [self._hyp_from_chase(chase[i]) for i in range(B)]
        return self._rescore_batch(out) if bp else out

    def _batch_host_tapes(self):
        """Materialize the last batch's tapes on host (cached; one bulk
        D2H per tape array)."""
        tapes, Ts, _ = self._last_batch
        if not isinstance(tapes[0], np.ndarray):
            tapes = tuple(np.asarray(a) for a in tapes)
            self._last_batch = (tapes, Ts, self._last_batch[2])
        return tapes

    def select_utt(self, i: int) -> None:
        """Point get_lattice/hyp state at utterance `i` of the most recent
        decode_batch."""
        htapes = self._batch_host_tapes()
        Ts = self._last_batch[1]
        self._last = tuple(a[i] for a in htapes) + (Ts[i],)

    # ------------------------------------------------------------------
    def _slot_rc_score(self, trc_row: np.ndarray, k: int, ci: int) -> float:
        """Exit score of word k's rc variant serving CI phone ci."""
        return float(trc_row[int(self.graph.rssid[k, ci])])

    def _tg_batch(self, h1: np.ndarray, h2: np.ndarray,
                  w: np.ndarray) -> np.ndarray:
        """Batched trigram scores (native lm3g core when built)."""
        from ..utils import native
        if native is not None:
            la = getattr(self, "_lm_arrays", None)
            if la is None:
                la = self._lm_arrays = native.LmArrays(self.lm)
            out = native.tg_score_batch(la, h1, h2, w)
            if out is not None:
                return out.astype(np.float64)
        return np.asarray([self.lm.tg_score(int(a), int(b), int(c))
                           for a, b, c in zip(h1, h2, w)], np.float64)

    def _lattice_from_tape(self, last):
        """Vectorized lattice construction from one utterance's tape arrays
        (the per-slot Python loop was ~0.5 s/utterance at 5k vocabulary;
        this is numpy throughout with one batched-LM call)."""
        from .lattice import LatNode, Lattice
        tw, tsc, tprev, th2, th1, trc = (np.asarray(a) for a in last[:6])
        T = last[6]
        g, v, E = self.graph, self.vocab, self.E
        n_slots = T * E
        slots = np.nonzero(tw[:n_slots] >= 0)[0]
        k = tw[slots].astype(np.int64)
        t = slots // E
        prev = tprev[slots]
        has_prev = prev >= 0
        pidx = np.maximum(prev, 0)
        sf = np.where(has_prev, pidx // E + 1, 0)
        # Entry score = predecessor exit (rc variant serving this word's
        # first CI phone) + LM/filler term — the score the decoder entered
        # this instance with (word_transition semantics).
        pk = tw[pidx].astype(np.int64)
        rcv = g.rssid[pk, g.firstci[k]].astype(np.int64)
        base = trc[pidx, rcv]
        base = np.where(base <= float(NEG_INF) * 0.5, tsc[pidx], base)
        fil = v.is_filler[k]
        lmterm = np.where(fil, self._fil_pen_np[k], 0.0).astype(np.float64)
        nz = has_prev & ~fil
        if nz.any():
            lmterm[nz] = (self.lw * self._tg_batch(
                th1[pidx[nz]], th2[pidx[nz]], v.lmwid[k[nz]])
                + self.log_wip)
        entry = np.where(has_prev, base + lmterm, self._ent0[k])
        # Per-instance rc readout decompressed to per-CI columns.
        rc_all = np.take_along_axis(
            trc[slots], g.rssid[k].astype(np.int64), axis=1)
        vit = tsc[slots]
        fp = self._fil_pen_np[k]
        lmw = v.lmwid[k]
        fin = v.is_finish[k]
        nodes = [
            LatNode(id=i, word=v.word_str[ki], kidx=int(ki),
                    lmwid=int(lw_), is_filler=bool(fi), fil_pen=float(fpi),
                    sf=int(sfi), ef=int(ti), vit_score=float(vi),
                    rc_score=rc_all[i], entry_score=float(en),
                    is_finish=bool(fni))
            for i, (ki, lw_, fi, fpi, sfi, ti, vi, en, fni) in enumerate(
                zip(k, lmw, fil, fp, sf, t, vit, entry, fin))
        ]
        return Lattice(nodes, g.firstci, g.lastci, self.lm, self.lw,
                       self.log_wip, self.sil_ci, self.finish_lmwid, T)

    def get_lattice(self):
        """Word lattice for the most recent utterance (ps_get_lattice)."""
        if self._last is None:
            if getattr(self, "_last_batch", None) is not None:
                self.select_utt(self._last_batch[2])
            else:
                raise RuntimeError("no utterance decoded yet")
        return self._lattice_from_tape(self._last)

    # ------------------------------------------------------------------
    def _final_slot(self, tw, tsc, th2, th1, trc, T):
        """Best utterance-final tape slot at the last frame with exits,
        scored with silence right context + P(</s> | h)
        (ngram_search_finish semantics)."""
        E, v = self.E, self.vocab
        for t in range(T - 1, -1, -1):
            sl = slice(t * E, t * E + E)
            ws = tw[sl]
            if not (ws >= 0).any():
                continue
            best, best_s = -1, -np.inf
            for e in range(E):
                if ws[e] < 0:
                    continue
                s = self._slot_rc_score(trc[sl][e], int(ws[e]), self.sil_ci)
                if not np.isfinite(s) or s <= float(NEG_INF) * 0.5:
                    s = tsc[sl][e]
                if not v.is_finish[ws[e]]:
                    s += self.lw * self.lm.tg_score(
                        int(th1[sl][e]), int(th2[sl][e]), self.finish_lmwid)
                if s > best_s:
                    best, best_s = t * E + e, float(s)
            if best >= 0:
                return best, best_s
        return -1, float("-inf")

    def _backtrace(self, tw, tsc, tprev, th2, th1, trc, T) -> Hypothesis:
        slot, score = self._final_slot(tw, tsc, th2, th1, trc, T)
        if slot < 0:
            return Hypothesis([], float("-inf"), [])
        v, E = self.vocab, self.E
        segs: List[Segment] = []
        while slot >= 0:
            k = int(tw[slot])
            t = slot // E
            prev = int(tprev[slot])
            start = prev // E + 1 if prev >= 0 else 0
            segs.append(Segment(v.word_str[k], start, t, float(tsc[slot])))
            slot = prev
        segs.reverse()
        words = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or not self.dict.is_filler(wid):
                words.append(self.dict.base_str(wid) if wid >= 0 else s.word)
        return Hypothesis(words, score, segs)

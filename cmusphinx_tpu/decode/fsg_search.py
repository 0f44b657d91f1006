"""FSG (grammar) decoder: dense time-synchronous Viterbi on the device.

Capability parity with fsg_search.c / fsg_lextree.c / fsg_history.c
(reference: pocketsphinx/src/libpocketsphinx/fsg_search.c:118-146 beams,
fsg_lextree.c per-transition phone networks with cross-word triphone
contexts, fsg_history.c Viterbi history) — redesigned as a dense tensor
program (SURVEY.md §7 design stance):

- Every grammar link's word is compiled into cross-word triphone variant
  channels (lexgraph.py): left-context variants at the first phone,
  right-context fan-out at the last, (lc, rc) grids for single-phone words.
- Decoding is a `lax.scan` over frames.  Every frame: gather senone scores,
  one batched `hmm_step` over ALL channels, within-word propagation over an
  edge list, per-link right-context exit readout, and link-to-link handoff
  through the epsilon-closed grammar: entry of link k2 = max over links k of
  exit(k, rc = firstphone(k2)) + closure(dst_k, src_k2) + entry_logprob(k2),
  routed into the left-context variant channel matching k's final phone.
- The backpointer "table" is the scan's stacked per-frame output: dense
  [T, K] exit scores + predecessor ids — no dynamic allocation, no host
  sync inside the loop.  Backtrace is a host-side walk.

Exact search (no pruning) is the default: for grammar-sized state spaces the
dense program evaluates everything faster than bookkeeping an active list.

Word insertion penalty and language weight follow the reference semantics:
entry logprob = lw * link_logprob + log(wip); silence/filler self-loops are
added to every state with -silprob/-fillprob (fsg_search.c:293-301).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.dict import Dictionary
from ..models.dict2pid import Dict2Pid
from ..models.fsg import FsgModel
from ..models.mdef import Mdef
from ..models.tmat import TransitionMatrices
from ..ops.hmm import NEG_INF, hmm_enter, hmm_step
from ..utils.config import Arg, Config
from .lexgraph import build_word_graph

FSG_ARGS = [
    Arg("lw", float, 6.5, "Language model probability weight"),
    Arg("wip", float, 0.65, "Word insertion penalty"),
    Arg("silprob", float, 0.005, "Silence word transition probability"),
    Arg("fillprob", float, 1e-8, "Filler word transition probability"),
    Arg("beam", float, 1e-48, "Beam width applied to every frame in Viterbi search"),
    Arg("wbeam", float, 7e-29, "Beam width applied to word exits"),
    Arg("prune", bool, False, "Apply beam pruning (dense search is exact by default)"),
]


@dataclass
class Segment:
    word: str
    start_frame: int
    end_frame: int
    score: float


@dataclass
class Hypothesis:
    words: List[str]
    score: float
    segments: List[Segment]

    @property
    def text(self) -> str:
        return " ".join(self.words)


class FsgSearch:
    """Grammar decoder over a senone scorer."""

    def __init__(self, fsg: FsgModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer,
                 config: Optional[Config] = None, **kwargs):
        cfg = (config.copy() if config else Config(FSG_ARGS)).register(FSG_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        lw = float(cfg["lw"])
        self.lw = lw
        log_wip = math.log(float(cfg["wip"]))
        # Add silence/filler loops and alternate pronunciations, as the
        # reference does at search init (fsg_search.c:290-355).
        silprob = float(cfg["silprob"])
        fillprob = float(cfg["fillprob"])
        fsg.lw = lw
        if silprob > 0 and fsg.word_id("<sil>") < 0 and d.silwid >= 0:
            fsg.add_silence("<sil>", -1, silprob)
            for fwid in range(d.filler_start, d.filler_end + 1):
                w = d.word_str(fwid)
                if w in ("<s>", "</s>", "<sil>"):
                    continue
                if d.basewid[fwid] == fwid:
                    fsg.add_silence(w, -1, fillprob)
        for word in list(fsg.vocab):
            wid = d.wordid(word)
            if wid >= 0:
                for alt in d.alternates(wid):
                    if alt != wid:
                        fsg.add_alt(word, d.word_str(alt))

        self.fsg = fsg
        self.dict = d
        self.mdef = mdef
        self.scorer = scorer
        self.sil_ci = mdef.sil if mdef.sil >= 0 else 0

        # One word instance per grammar link.
        links = list(fsg.word_links())
        wids, src, dst, lp, words = [], [], [], [], []
        for link in links:
            word = fsg.vocab[link.wid]
            wid = d.wordid(word)
            if wid < 0:
                raise KeyError(f"FSG word {word!r} not in dictionary")
            wids.append(wid)
            src.append(link.from_state)
            dst.append(link.to_state)
            lp.append(lw * link.logprob + log_wip)
            words.append(word)
        self.words = words
        self.wids = wids
        self.n_link = K = len(links)
        self.n_state = fsg.n_state
        g = self.graph = build_word_graph(wids, d, mdef, Dict2Pid(mdef, d))
        self.src = np.asarray(src, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.entry_lp = np.asarray(lp, np.float32)
        self.closure = fsg.null_closure()          # [N, N] lw-scaled, 0 diag

        # Device constants.
        self._tp = jnp.asarray(tmat.log_tp[g.tmat_idx])
        self._sing_sen = jnp.asarray(g.sing_sen)
        self._sing_valid = jnp.asarray(g.sing_valid)
        self._comp_mem = jnp.asarray(g.comp_mem)
        self._comp_valid = jnp.asarray(g.comp_valid)
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
        self._firstci = jnp.asarray(g.firstci)
        self._lastci = jnp.asarray(g.lastci)
        # Link-to-link transition weights: W[k, k2] = closure(dst_k, src_k2)
        # + entry_lp[k2]; -inf where no grammar path.
        W = self.closure[self.dst][:, self.src] + self.entry_lp[None, :]
        self._W = jnp.asarray(W.astype(np.float32))
        # Initial entries: start state through closure.
        st0 = self.closure[fsg.start_state]                  # [N]
        ent0 = st0[self.src] + self.entry_lp                 # [K]
        self._ent0 = np.asarray(ent0, np.float32)
        self._last = None
        entc0 = np.full(g.n_chan, float(NEG_INF), np.float32)
        entc0[g.is_entry] = ent0[g.word_of[g.is_entry]]
        self._entc0 = jnp.asarray(entc0)
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], self.sil_ci]
        self._entxs0 = jnp.asarray(xs0)
        # Final weights: exit of link k (rc=SIL) + closure to final state.
        self._finw = np.asarray(
            self.closure[self.dst, fsg.final_state], np.float32)
        self._step_fn = jax.jit(self._make_step())

    # ------------------------------------------------------------------
    def _make_step(self):
        g = self.graph
        K, C, S = self.n_link, g.n_chan, g.n_emit_state
        neg = jnp.float32(NEG_INF)

        def step(carry, inputs):
            alpha0, hist0, xsr0 = carry
            sen_t, t, valid = inputs
            base = jnp.where(self._sing_valid, sen_t[self._sing_sen], neg)
            comp = jnp.where(self._comp_valid,
                             jnp.max(sen_t[self._comp_mem], axis=-1), neg)
            xscores = jnp.concatenate(
                [base[: g.n_sing], comp[: g.n_xs - g.n_sing]], axis=0)
            sen_c = xscores[xsr0, jnp.arange(S)[None, :]]
            alpha, (hist, xsr), ex, (exh, _) = hmm_step(
                alpha0, (hist0, xsr0), sen_c, self._tp)

            if bool(self.config["prune"]):
                bestscr = jnp.max(alpha)
                beam = jnp.float32(math.log(float(self.config["beam"])))
                keep = jnp.max(alpha, axis=1) > bestscr + beam
                alpha = jnp.where(keep[:, None], alpha, neg)

            # Per-link exits with per-rc-variant readout.
            exv = jnp.where(self._exit_tab >= 0,
                            ex[self._exit_tab_c], neg)         # [K, Vr]
            wex = jnp.max(exv, axis=1)                         # [K]
            vwin = jnp.argmax(exv, axis=1)
            wexh = exh[jnp.take_along_axis(
                self._exit_tab_c, vwin[:, None], axis=1)[:, 0]]

            # Link-to-link handoff: A[k, k2] = exit(k, rc=firstci(k2)) + W.
            rcv = self._rssid[:, self._firstci]                # [K, K]
            A = jnp.take_along_axis(exv, rcv, axis=1) + self._W
            bp_id = t * K + jnp.arange(K, dtype=jnp.int32)
            ent = jnp.max(A, axis=0)                           # [K]
            kstar = jnp.argmax(A, axis=0)                      # [K]
            ebp = jnp.where(ent > neg * 0.5, bp_id[kstar], -1)
            lcstar = self._lastci[kstar]                       # [K]

            wo = self._word_of
            ent_c = jnp.where(self._is_entry, ent[wo], neg)
            ent_xs_c = self._lcmap[self._lc_row, lcstar[wo]]
            ebp_c = ebp[wo]

            # Within-word propagation: in-degree <= 1 -> pure gather.
            has_prev = self._prev_chan >= 0
            prop = jnp.where(has_prev, ex[self._prev_chan_c], neg)
            bprop = jnp.where(has_prev, exh[self._prev_chan_c], -1)

            entry_c = jnp.where(self._is_entry, ent_c, prop)
            entry_b = jnp.where(self._is_entry, ebp_c, bprop)
            entry_x = jnp.where(self._is_entry, ent_xs_c, self._static_xs)
            alpha, (hist, xsr) = hmm_enter(alpha, (hist, xsr), entry_c,
                                           (entry_b, entry_x))

            alpha = jnp.where(valid, alpha, alpha0)
            hist = jnp.where(valid, hist, hist0)
            xsr = jnp.where(valid, xsr, xsr0)
            wex = jnp.where(valid, wex, neg)
            wexsil = jnp.where(
                valid,
                jnp.take_along_axis(
                    exv, self._rssid[:, self.sil_ci][:, None], axis=1)[:, 0],
                neg)
            exv = jnp.where(valid, exv, neg)
            return (alpha, hist, xsr), (wex, wexh, wexsil, exv)

        return step

    # ------------------------------------------------------------------
    FRAME_BUCKET = 100

    def decode(self, feats: np.ndarray) -> Hypothesis:
        """feats [T, D] -> best hypothesis."""
        g = self.graph
        T = int(feats.shape[0])
        if T == 0:
            return Hypothesis([], float("-inf"), [])
        Tpad = -(-T // self.FRAME_BUCKET) * self.FRAME_BUCKET
        fpad = np.zeros((Tpad, feats.shape[1]), np.float32)
        fpad[:T] = feats
        scores = self.scorer.score(jnp.asarray(fpad))
        valid = jnp.arange(Tpad) < T

        alpha = jnp.full((g.n_chan, g.n_emit_state), NEG_INF)
        hist = jnp.full((g.n_chan, g.n_emit_state), -1, jnp.int32)
        xsr = jnp.broadcast_to(self._static_xs[:, None],
                               (g.n_chan, g.n_emit_state)).astype(jnp.int32)
        alpha, (hist, xsr) = hmm_enter(
            alpha, (hist, xsr), self._entc0,
            (jnp.full((g.n_chan,), -1, jnp.int32), self._entxs0))

        (alpha, hist, xsr), (wex_t, wexh_t, wexsil_t, exv_t) = jax.lax.scan(
            self._step_fn, (alpha, hist, xsr),
            (scores, jnp.arange(Tpad, dtype=jnp.int32), valid))
        wex_t = np.asarray(wex_t)[:T]
        wexh_t = np.asarray(wexh_t)[:T]
        wexsil_t = np.asarray(wexsil_t)[:T]
        self._last = (wex_t, wexh_t, wexsil_t, np.asarray(exv_t)[:T], T)
        return self._backtrace_at(wex_t, wexh_t, wexsil_t, T)

    def _is_filler_word(self, word: str) -> bool:
        wid = self.dict.wordid(word)
        return wid >= 0 and self.dict.is_filler(wid)

    # ------------------------------------------------------------------
    # Streaming decode (gst-plugin partial-result capability for grammar
    # mode): the Viterbi carry stays on device between chunks; the small
    # per-frame [K] exit outputs accumulate on host for partial backtrace.
    CHUNK = 50

    def stream_start(self, max_frames: int = 100000) -> dict:
        g = self.graph
        alpha = jnp.full((g.n_chan, g.n_emit_state), NEG_INF)
        hist = jnp.full((g.n_chan, g.n_emit_state), -1, jnp.int32)
        xsr = jnp.broadcast_to(self._static_xs[:, None],
                               (g.n_chan, g.n_emit_state)).astype(jnp.int32)
        alpha, (hist, xsr) = hmm_enter(
            alpha, (hist, xsr), self._entc0,
            (jnp.full((g.n_chan,), -1, jnp.int32), self._entxs0))
        if not hasattr(self, "_chunk_fn"):
            def chunk(carry, scores, t0, valid):
                ts = t0 + jnp.arange(self.CHUNK, dtype=jnp.int32)
                return jax.lax.scan(self._step_fn, carry, (scores, ts, valid))
            self._chunk_fn = jax.jit(chunk)
        return {"carry": (alpha, hist, xsr), "t": 0,
                "max_frames": max_frames,
                "wex": [], "wexh": [], "wexsil": [], "exv": [],
                "pending": np.zeros((0, 0), np.float32)}

    def stream_push(self, state: dict, feats: np.ndarray) -> dict:
        feats = np.asarray(feats, np.float32)
        pend = state["pending"]
        buf = feats if pend.size == 0 else np.concatenate([pend, feats])
        n = buf.shape[0]
        k = n // self.CHUNK
        for i in range(k):
            if state["t"] + self.CHUNK > state["max_frames"]:
                raise ValueError("stream exceeds max_frames")
            chunk = buf[i * self.CHUNK : (i + 1) * self.CHUNK]
            scores = self.scorer.score(jnp.asarray(chunk))
            state["carry"], ys = self._chunk_fn(
                state["carry"], scores, jnp.int32(state["t"]),
                jnp.ones((self.CHUNK,), bool))
            wex, wexh, wexsil, exv = (np.asarray(a) for a in ys)
            state["wex"].append(wex)
            state["wexh"].append(wexh)
            state["wexsil"].append(wexsil)
            state["exv"].append(exv)
            state["t"] += self.CHUNK
        state["pending"] = buf[k * self.CHUNK :]
        return state

    def _stream_flush(self, state: dict) -> int:
        pend = state["pending"]
        n = pend.shape[0]
        if n:
            pad = np.zeros((self.CHUNK, pend.shape[1]), np.float32)
            pad[:n] = pend
            scores = self.scorer.score(jnp.asarray(pad))
            state["carry"], ys = self._chunk_fn(
                state["carry"], scores, jnp.int32(state["t"]),
                jnp.arange(self.CHUNK) < n)
            wex, wexh, wexsil, exv = (np.asarray(a)[:n] for a in ys)
            state["wex"].append(wex)
            state["wexh"].append(wexh)
            state["wexsil"].append(wexsil)
            state["exv"].append(exv)
            state["t"] += n
            state["pending"] = np.zeros((0, 0), np.float32)
        return state["t"]

    def _stream_tape(self, state: dict):
        K = self.n_link
        Vr = self.graph.n_rcvar
        wex = np.concatenate(state["wex"]) if state["wex"] else \
            np.zeros((0, K), np.float32)
        wexh = np.concatenate(state["wexh"]) if state["wexh"] else \
            np.zeros((0, K), np.int32)
        wexsil = np.concatenate(state["wexsil"]) if state["wexsil"] else \
            np.zeros((0, K), np.float32)
        exv = np.concatenate(state["exv"]) if state["exv"] else \
            np.zeros((0, K, Vr), np.float32)
        return wex, wexh, wexsil, exv

    def stream_partial(self, state: dict) -> Hypothesis:
        """Best hypothesis so far (partial result): best exit at the last
        decoded frame, preferring grammar-final-reachable links."""
        if state["t"] == 0:
            return Hypothesis([], float("-inf"), [])
        wex, wexh, wexsil, _ = self._stream_tape(state)
        return self._backtrace_at(wex, wexh, wexsil, state["t"],
                                  require_final=False)

    def stream_end(self, state: dict) -> Hypothesis:
        T = self._stream_flush(state)
        wex, wexh, wexsil, exv = self._stream_tape(state)
        self._last = (wex, wexh, wexsil, exv, T)
        return self._backtrace_at(wex, wexh, wexsil, T, require_final=True)

    def _backtrace_at(self, wex_t, wexh_t, wexsil_t, T: int,
                      require_final: bool = True) -> Hypothesis:
        if T == 0:
            return Hypothesis([], float("-inf"), [])
        finals = wexsil_t[T - 1] + self._finw
        k = int(np.argmax(finals))
        score = float(finals[k])
        if not np.isfinite(score) or score <= float(NEG_INF) / 2:
            if require_final:
                return Hypothesis([], float("-inf"), [])
            # Partial: best exit regardless of grammar-final reachability.
            k = int(np.argmax(wex_t[T - 1]))
            score = float(wex_t[T - 1, k])
            if not np.isfinite(score) or score <= float(NEG_INF) / 2:
                return Hypothesis([], float("-inf"), [])
        K = self.n_link
        segs: List[Segment] = []
        t = T - 1
        while True:
            prev = int(wexh_t[t, k])
            start = (prev // K) + 1 if prev >= 0 else 0
            segs.append(Segment(self.words[k], start, t, float(wex_t[t, k])))
            if prev < 0:
                break
            t, k = prev // K, prev % K
        segs.reverse()
        words = [s.word for s in segs if not self._is_filler_word(s.word)]
        return Hypothesis(words, score, segs)

    # ------------------------------------------------------------------
    def get_lattice(self) -> "FsgLattice":
        """Word lattice from the FSG Viterbi history (fsg_search_lattice
        capability, pocketsphinx/src/libpocketsphinx/fsg_search.c:74).
        Requires storing per-rc exits; decode(keep_lattice=True) or
        streaming populate it."""
        if getattr(self, "_last", None) is None:
            raise RuntimeError("no utterance decoded yet "
                               "(decode with keep_lattice=True)")
        wex, wexh, wexsil, exv, T = self._last
        return FsgLattice(self, wex, wexh, wexsil, exv, T)


class FsgLattice:
    """Word lattice over FSG Viterbi history (fsg_search_lattice capability,
    reference pocketsphinx/src/libpocketsphinx/fsg_search.c:74 +
    fsg_history.c).

    Nodes are link exits (frame t, grammar link k); since a node carries its
    grammar link, grammar state is fully captured and bestpath/N-best are
    EXACT over the lattice (no history approximation needed — the FSG analog
    of the trigram history pair is the link id itself).  Edge weights follow
    the standard word-boundary decomposition: the destination node's
    acoustics are path-independent (the same assumption the reference's
    bptable makes), the source contributes an rc-variant adjustment, and the
    grammar weight lw*logprob + log(wip) rides the edge.
    """

    def __init__(self, search: "FsgSearch", wex, wexh, wexsil, exv, T: int,
                 latbeam: float = 1e-28):
        self.search = search
        self.n_frames = T
        K = search.n_link
        g = search.graph
        W = np.asarray(search._W, np.float32)           # [K, K] grammar wt
        rssid = np.asarray(search.graph.rssid)          # [K, n_ci]
        firstci = np.asarray(g.firstci)
        neg = float(NEG_INF)

        # Candidate nodes: exits within latbeam of the frame-best exit
        # (wbeam-style absolute pruning keeps the lattice bounded; the
        # reference applies its word beam at bptable insertion).
        lb = math.log(latbeam)
        keep = np.zeros((T, K), bool)
        for t in range(T):
            row = wex[t]
            m = row.max()
            if m > neg / 2:
                keep[t] = row > max(m + lb, neg / 2)
        node_id = -np.ones((T, K), np.int32)
        nodes = []          # (t, k, sf, ascr)
        for t in range(T):
            for k in np.nonzero(keep[t])[0]:
                prev = int(wexh[t, k])
                if prev >= 0:
                    t1, k1 = prev // K, prev % K
                    rc = int(rssid[k1, firstci[k]])
                    ev = float(exv[t1, k1, rc])
                    if ev <= neg / 2:
                        ev = float(wex[t1, k1])
                    entry = ev + float(W[k1, k])
                    sf = t1 + 1
                else:
                    entry = float(search._ent0[k])
                    sf = 0
                ascr = float(wex[t, k]) - entry
                node_id[t, k] = len(nodes)
                nodes.append((t, k, sf, ascr))
        self.nodes = nodes
        N = len(nodes)
        # Edges: (t1,k1) -> (t2,k2) when t1 == sf2-1, grammar-connected,
        # with weight = rc-adjusted src exit - src best exit + grammar.
        by_ef: dict = {}
        for i, (t, k, sf, _) in enumerate(nodes):
            by_ef.setdefault(t, []).append(i)
        self.preds = [[] for _ in range(N)]
        self.succs = [[] for _ in range(N)]
        self.edge_w: Dict[Tuple[int, int], float] = {}
        for j, (t2, k2, sf2, ascr2) in enumerate(nodes):
            if sf2 == 0:
                continue
            for i in by_ef.get(sf2 - 1, []):
                t1, k1, _, _ = nodes[i]
                gw = float(W[k1, k2])
                if gw <= neg / 2:
                    continue
                rc = int(rssid[k1, firstci[k2]])
                ev = float(exv[t1, k1, rc])
                if ev <= neg / 2:
                    continue
                w = (ev - float(wex[t1, k1])) + gw + ascr2
                self.edge_w[(i, j)] = w
                self.succs[i].append(j)
                self.preds[j].append(i)
        # Start weight: grammar entry + own acoustics; final adjustment:
        # sil-rc exit + closure to the grammar final state.
        self.start_w = np.full(N, neg, np.float32)
        self.final_w = np.full(N, neg, np.float32)
        finw = search._finw
        for i, (t, k, sf, ascr) in enumerate(nodes):
            if sf == 0:
                self.start_w[i] = float(search._ent0[k]) + ascr
            if t == T - 1 and np.isfinite(finw[k]) and finw[k] > neg / 2:
                ws = float(wexsil[t, k])
                if ws > neg / 2:
                    self.final_w[i] = (ws - float(wex[t, k])) + float(finw[k])
        # Prune nodes that cannot lie on a complete start->final path.
        fwd = self.start_w > neg / 2
        order = sorted(range(N), key=lambda i: nodes[i][0])
        for i in order:
            if fwd[i]:
                for j in self.succs[i]:
                    fwd[j] = True
        bwd = self.final_w > neg / 2
        for i in reversed(order):
            if bwd[i]:
                for p in self.preds[i]:
                    bwd[p] = True
        self.alive = fwd & bwd

    def _word(self, i: int) -> str:
        return self.search.words[self.nodes[i][1]]

    def _segs(self, path: List[int]) -> Tuple[List[str], List[Segment]]:
        segs = [Segment(self._word(i), self.nodes[i][2], self.nodes[i][0],
                        0.0) for i in path]
        words = [s.word for s in segs
                 if not self.search._is_filler_word(s.word)]
        return words, segs

    def bestpath(self) -> Hypothesis:
        """Exact Viterbi over the lattice DAG."""
        N = len(self.nodes)
        neg = float(NEG_INF)
        best = np.where(self.alive, self.start_w, neg).astype(np.float64)
        back = -np.ones(N, np.int64)
        order = sorted(range(N), key=lambda i: self.nodes[i][0])
        for i in order:
            if best[i] <= neg / 2 or not self.alive[i]:
                continue
            for j in self.succs[i]:
                s = best[i] + self.edge_w[(i, j)]
                if s > best[j]:
                    best[j] = s
                    back[j] = i
        fin = np.where(self.alive, best + self.final_w, neg)
        j = int(np.argmax(fin))
        if fin[j] <= neg / 2:
            return Hypothesis([], float("-inf"), [])
        path = []
        i = j
        while i >= 0:
            path.append(i)
            i = int(back[i])
        path.reverse()
        words, segs = self._segs(path)
        return Hypothesis(words, float(fin[j]), segs)

    def posterior(self, ascale: float = 0.05) -> np.ndarray:
        """Node posteriors by forward-backward (ps_lattice_posterior)."""
        N = len(self.nodes)
        alpha = np.full(N, -np.inf)
        beta = np.full(N, -np.inf)
        order = sorted(range(N), key=lambda i: self.nodes[i][0])
        neg = float(NEG_INF)
        for i in order:
            if self.alive[i] and self.start_w[i] > neg / 2:
                alpha[i] = np.logaddexp(alpha[i], ascale * self.start_w[i])
        for i in order:
            if not np.isfinite(alpha[i]):
                continue
            for j in self.succs[i]:
                if self.alive[j]:
                    alpha[j] = np.logaddexp(
                        alpha[j], alpha[i] + ascale * self.edge_w[(i, j)])
        for i in order:
            if self.alive[i] and self.final_w[i] > neg / 2:
                beta[i] = ascale * self.final_w[i]
        for i in reversed(order):
            for j in self.succs[i]:
                if np.isfinite(beta[j]):
                    beta[i] = np.logaddexp(
                        beta[i], beta[j] + ascale * self.edge_w[(i, j)])
        total = -np.inf
        for i in order:
            if self.final_w[i] > neg / 2 and np.isfinite(alpha[i]):
                total = np.logaddexp(total, alpha[i] + ascale * self.final_w[i])
        return alpha + beta - total

    def nbest(self, n: int = 10) -> List[Hypothesis]:
        """A* N-best with an exact backward-Viterbi heuristic (ps_astar
        capability; exact because grammar state lives in the node)."""
        import heapq
        N = len(self.nodes)
        neg = float(NEG_INF)
        h = np.where(self.alive, self.final_w, neg).astype(np.float64)
        order = sorted(range(N), key=lambda i: self.nodes[i][0])
        for i in reversed(order):
            for j in self.succs[i]:
                if h[j] > neg / 2:
                    h[i] = max(h[i], self.edge_w[(i, j)] + h[j])
        heap = []
        cnt = 0
        for i in order:
            if self.alive[i] and self.start_w[i] > neg / 2 and h[i] > neg / 2:
                heapq.heappush(heap, (-(self.start_w[i] + h[i]), cnt, i,
                                      float(self.start_w[i]), None))
                cnt += 1
        paths: List[Tuple] = []
        out: List[Hypothesis] = []
        seen = set()
        while heap and len(out) < n:
            negf, _, i, gscore, parent = heapq.heappop(heap)
            paths.append((i, parent))
            pid = len(paths) - 1
            if self.final_w[i] > neg / 2:
                s = gscore + float(self.final_w[i])
                path = []
                p = pid
                while p is not None:
                    path.append(paths[p][0])
                    p = paths[p][1]
                path.reverse()
                words, segs = self._segs(path)
                text = " ".join(words)
                if text not in seen:
                    seen.add(text)
                    out.append(Hypothesis(words, s, segs))
            for j in self.succs[i]:
                if h[j] > neg / 2:
                    g2 = gscore + self.edge_w[(i, j)]
                    heapq.heappush(heap, (-(g2 + h[j]), cnt, j, g2, pid))
                    cnt += 1
        return out

    def write(self, path: str, uttid: str = "utt",
              logbase: float = 1.0001) -> None:
        """Sphinx lattice text format (ps_lattice.c:232-370)."""
        lb = math.log(logbase)
        ids = [i for i in range(len(self.nodes)) if self.alive[i]]
        remap = {i: r for r, i in enumerate(ids)}
        with open(path, "w") as fh:
            fh.write("# getcwd: /\n")
            fh.write(f"# -logbase {logbase:g}\n")
            fh.write(f"Frames {self.n_frames}\n#\n")
            fh.write("Nodes %d (NODEID WORD STARTFRAME FIRST-ENDFRAME "
                     "LAST-ENDFRAME)\n" % len(ids))
            for i in ids:
                t, k, sf, _ = self.nodes[i]
                fh.write(f"{remap[i]} {self._word(i)} {sf} {t} {t}\n")
            starts = [i for i in ids if self.start_w[i] > float(NEG_INF) / 2]
            finals = [i for i in ids if self.final_w[i] > float(NEG_INF) / 2]
            fh.write(f"Initial {remap[starts[0]] if starts else 0}\n")
            fh.write(f"Final {remap[finals[0]] if finals else 0}\n")
            fh.write("Edges (FROM-NODEID TO-NODEID ASCORE)\n")
            for (i, j), w in self.edge_w.items():
                if self.alive[i] and self.alive[j]:
                    fh.write(f"{remap[i]} {remap[j]} {int(w / lb)}\n")
            fh.write("End\n")

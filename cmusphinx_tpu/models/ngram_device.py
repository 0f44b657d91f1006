"""Device-resident trigram LM lookup.

The lm3g hot path (reference: sphinxbase lm/lm3g_templates.c:46-260
find_bg/find_tg binary searches + tginfo caches) reformulated for the device
(SURVEY.md §7 "Trigram LM on device"): the CSR successor tables
(ngram.py) ship to HBM unchanged and lookup is a *vectorized row-wise
binary search* — every query lane runs the same fori_loop bisection over
its own [ptr[row], ptr[row+1]) range, so thousands of (history, word)
queries per frame resolve in ~32 rounds of gathers.  No composite sort keys
(which would overflow int32 for large vocabularies) and no tginfo caches:
recomputation replaces the bookkeeping.

`score_tg(w1, w2, w3)` evaluates the full backoff chain branch-free for
whole query arrays; the decoder issues one [E, V] call per frame for all
(exit-history, entry-word) pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ngram import NgramModel


def _row_search(data, lo, hi, key):
    """First index i in [lo, hi) with data[i] == key, else -1.

    data: [N] sorted within each row; lo/hi/key: same-shape query arrays.
    Pure fixed-trip binary search (bisect_left), jit/vmap friendly.
    """
    n_iter = max(int(np.ceil(np.log2(max(int(data.shape[0]), 2)))) + 1, 1)
    lo, hi, key = jnp.broadcast_arrays(lo, hi, key)

    def body(_, lh):
        l, h = lh
        m = (l + h) // 2
        go_right = data[jnp.minimum(m, data.shape[0] - 1)] < key
        return jnp.where(go_right, m + 1, l), jnp.where(go_right, h, m)

    l, _ = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    found = (l < hi) & (data[jnp.minimum(l, data.shape[0] - 1)] == key)
    return jnp.where(found, l, -1)


class DeviceNgram:
    """Immutable device tables for vectorized backoff scoring.

    Small vocabularies get a DENSE backoff-resolved trigram tensor
    [V+1, V+1, V] (the +1 planes encode the "no context" -1 history), so
    the per-frame [E, V] lookup in the decode scan is ONE gather instead of
    ~2 log2(N)-round serial binary searches — the searches were the single
    largest per-frame cost in the scan (latency-bound gather chains).  The
    CSR binary-search path remains for large vocabularies; `dense3_limit`
    caps the dense tensor's HBM footprint.
    """

    def __init__(self, m: NgramModel, dense3_limit: int = 256 << 20):
        self.V = m.n_words
        self.n = m.n
        self.ug_prob = jnp.asarray(m.ug_prob)
        self.ug_bo = jnp.asarray(m.ug_bo)
        self.NB = len(m.bg_wid)
        self.NT = len(m.tg_wid)
        pad1 = lambda a, d: jnp.asarray(a) if len(a) else jnp.zeros((1,), d)
        self.bg_ptr = jnp.asarray(m.bg_ptr.astype(np.int32))   # [V+1]
        self.bg_wid = pad1(m.bg_wid, jnp.int32)
        self.bg_prob = pad1(m.bg_prob, jnp.float32)
        self.bg_bo = pad1(m.bg_bo if len(m.bg_bo) else
                          np.zeros(self.NB, np.float32), jnp.float32)
        self.tg_ptr = jnp.asarray(m.tg_ptr.astype(np.int32))   # [NB+1]
        self.tg_wid = pad1(m.tg_wid, jnp.int32)
        self.tg_prob = pad1(m.tg_prob, jnp.float32)
        # Max successor-list lengths (static scatter widths for score_rows).
        self.MAXB = int(np.diff(m.bg_ptr).max()) if self.NB else 0
        self.MAXT = int(np.diff(m.tg_ptr).max()) if self.NT else 0
        self.tg_dense = None
        V = self.V
        if V and (V + 1) * (V + 1) * V * 4 <= dense3_limit:
            self.tg_dense = jnp.asarray(self._build_dense3(m))
        # Small-LM probe tables: when the LM has few bigrams/trigrams
        # (floor-heavy LMs, tiny task LMs), an exact (h1, h2, w) score is
        # ONE [lanes, NB]+[lanes, NT] elementwise comparison sweep, in
        # place of per-lane binary searches (dependent gathers) or
        # materialized [lanes, V] score rows.
        self.probe = False
        if 0 < self.NB + self.NT <= (16 << 10):
            bg_w1 = np.repeat(np.arange(max(V, 1)),
                              np.diff(m.bg_ptr)).astype(np.int32)
            self._p_bg_w1 = jnp.asarray(bg_w1)
            if self.NT:
                tg_b = np.repeat(np.arange(self.NB),
                                 np.diff(m.tg_ptr)).astype(np.int64)
                self._p_tg_w1 = jnp.asarray(bg_w1[tg_b])
                self._p_tg_w2 = jnp.asarray(
                    np.asarray(m.bg_wid)[tg_b].astype(np.int32))
            self.probe = True
        # Large-LM hash tables: millions of n-grams make the probe sweep,
        # the row scatters AND per-lane binary searches all infeasible —
        # this is the HBM-resident home for production trigram LMs (the
        # sphinx4 LargeTrigramModel capability, linguist/language/ngram/
        # large).  Open-addressed tables with the probe depth fixed at
        # build time; each probe is ONE [lanes, 4]-row gather (keys and
        # payloads packed as exact-in-f32 lanes).
        self.hashed = False
        if not self.probe and self.tg_dense is None and self.NB:
            self._build_hash(m)

    # -- hashed point-lookup backend ------------------------------------
    # Load factor 0.6: the parking-function bulk insert keeps the probe
    # depth ~15 at millions of random keys (vs 9 at 0.35), and the tables
    # take 42% less memory (the size was set by a cap on a program's
    # constant payload in an earlier deployment; ROADMAP §2.7).
    _HASH_LOAD = 0.6

    @staticmethod
    def _hash32(a: np.ndarray, b: np.ndarray, size: int) -> np.ndarray:
        """uint32-wraparound hash, identical on host (uint64 masked) and
        device (native uint32)."""
        h = ((a.astype(np.uint64) * np.uint64(2654435761)
              + b.astype(np.uint64) * np.uint64(97))
             & np.uint64(0x7FFFFFFF))
        return (h % np.uint64(size)).astype(np.int64)

    @classmethod
    def _pack_table(cls, k1: np.ndarray, k2: np.ndarray,
                    vals: np.ndarray):
        """Bulk linear-probe build of a [size + maxdisp, 2 + n_vals] f32
        table (keys must be < 2^24 so the f32 lanes are exact).  Entries
        sorted by home slot get placement j_i = max(home_i, j_{i-1} + 1)
        — the classic parking-function bulk insert, vectorized — and the
        table is PADDED past `size` instead of wrapping, so lookups probe
        `slot + p` without a mod.  Returns (table, probe depth)."""
        n = len(k1)
        size = max(int(n / cls._HASH_LOAD), 8)
        home = cls._hash32(k1, k2, size)
        order = np.argsort(home, kind="stable")
        hs = home[order]
        ar = np.arange(n, dtype=np.int64)
        j = np.maximum.accumulate(hs - ar) + ar       # placements
        maxp = int((j - hs).max()) if n else 0
        tab = np.full((size + maxp + 1, 2 + vals.shape[1]), -1.0,
                      np.float32)
        tab[j, 0] = k1[order]
        tab[j, 1] = k2[order]
        tab[j, 2:] = vals[order]
        return tab, maxp + 1, size

    def _build_hash(self, m) -> None:
        if self.V >= (1 << 24) or self.NB >= (1 << 24):
            return  # keys would not be exact in f32
        bg_w1 = np.repeat(np.arange(max(self.V, 1)),
                          np.diff(m.bg_ptr)).astype(np.int64)
        bg_bo = (np.asarray(m.bg_bo) if len(m.bg_bo)
                 else np.zeros(self.NB, np.float32))
        vals = np.stack([np.asarray(m.bg_prob), bg_bo,
                         np.arange(self.NB, dtype=np.float32)], axis=1)
        tab, p, sz = self._pack_table(bg_w1,
                                      np.asarray(m.bg_wid, np.int64), vals)
        self._hbg = jnp.asarray(tab)
        self._hbg_probes = p
        self._hbg_size = sz
        if self.NT:
            tg_b = np.repeat(np.arange(self.NB),
                             np.diff(m.tg_ptr)).astype(np.int64)
            tabt, pt, szt = self._pack_table(
                tg_b, np.asarray(m.tg_wid, np.int64),
                np.asarray(m.tg_prob)[:, None])
            self._htg = jnp.asarray(tabt)
            self._htg_probes = pt
            self._htg_size = szt
        else:
            self._htg = None
        self.hashed = True

    def _hash_find(self, tab, probes: int, size: int, k1, k2):
        """Vectorized open-address lookup: -> (hit mask, [lanes, n_vals]).
        Each probe is ONE row gather from the padded table (no mod)."""
        k1f = k1.astype(jnp.float32)
        k2f = k2.astype(jnp.float32)
        h = ((k1.astype(jnp.uint32) * jnp.uint32(2654435761)
              + k2.astype(jnp.uint32) * jnp.uint32(97))
             & jnp.uint32(0x7FFFFFFF))
        slot = jnp.mod(h, jnp.uint32(size)).astype(jnp.int32)
        hit = jnp.zeros(k1.shape, bool)
        out = jnp.zeros(k1.shape + (tab.shape[1] - 2,), jnp.float32)
        for p in range(probes):
            rows = tab[slot + p]
            m = (~hit) & (rows[..., 0] == k1f) & (rows[..., 1] == k2f)
            out = jnp.where(m[..., None], rows[..., 2:], out)
            hit = hit | m
        return hit, out

    def score_tg_hashed(self, w1, w2, w3):
        """Exact trigram backoff via the hashed tables (point queries;
        lanes <= a few hundred per call is the intended regime)."""
        w1, w2, w3 = jnp.broadcast_arrays(w1, w2, w3)
        w2c = jnp.maximum(w2, 0)
        ug3 = self.ug_prob[jnp.maximum(w3, 0)]
        h23, v23 = self._hash_find(self._hbg, self._hbg_probes,
                                   self._hbg_size, w2c, w3)
        bg23 = jnp.where(w2 < 0, ug3,
                         jnp.where(h23, v23[..., 0],
                                   self.ug_bo[w2c] + ug3))
        if self.n < 3 or self._htg is None:
            return bg23
        w1c = jnp.maximum(w1, 0)
        h12, v12 = self._hash_find(self._hbg, self._hbg_probes,
                                   self._hbg_size, w1c, w2c)
        rowid = v12[..., 2].astype(jnp.int32)
        ht, vt = self._hash_find(self._htg, self._htg_probes,
                                 self._htg_size,
                                 jnp.where(h12, rowid, -1), w3)
        s = jnp.where(ht & h12, vt[..., 0],
                      jnp.where(h12, v12[..., 1], 0.0) + bg23)
        return jnp.where(w1 < 0, bg23, s)

    def _build_dense3(self, m: NgramModel) -> np.ndarray:
        """Host-side dense [V+1, V+1, V] fully-backed-off trigram scores.
        Index V in the history axes = "no context" (-1)."""
        V = self.V
        ug = m.ug_prob.astype(np.float32)                      # [V]
        # Dense bigram with backoff: B[w2, w3].
        B = m.ug_bo.astype(np.float32)[:, None] + ug[None, :]  # [V, V]
        bg_w1 = np.repeat(np.arange(V), np.diff(m.bg_ptr))
        if len(m.bg_wid):
            B[bg_w1, m.bg_wid] = m.bg_prob
        T = np.empty((V + 1, V + 1, V), np.float32)
        # w2 = -1 plane: unigram regardless of w1.
        T[:, V, :] = ug[None, :]
        # w1 = -1 plane: bigram scores.
        T[V, :V, :] = B
        if m.n < 3 or len(m.tg_wid) == 0:
            T[:V, :V, :] = B[None, :, :]
        else:
            # via-backoff default: bg_bo(w1,w2) (0 when bigram absent) + B.
            bo = np.zeros((V, V), np.float32)
            if len(m.bg_wid):
                bo[bg_w1, m.bg_wid] = m.bg_bo if len(m.bg_bo) else 0.0
            T[:V, :V, :] = bo[:, :, None] + B[None, :, :]
            # scatter trigram hits: trigram t belongs to bigram row b.
            tg_b = np.repeat(np.arange(len(m.bg_wid)),
                             np.diff(m.tg_ptr))
            T[bg_w1[tg_b], m.bg_wid[tg_b], m.tg_wid] = m.tg_prob
        return T

    # ------------------------------------------------------------------
    def _find_bg(self, w1, w2):
        """Bigram row index for (w1, w2), -1 if absent.  Vectorized."""
        if self.NB == 0:
            return jnp.full(jnp.shape(w1), -1, jnp.int32)
        lo = self.bg_ptr[w1]
        hi = self.bg_ptr[w1 + 1]
        return _row_search(self.bg_wid, lo, hi, w2)

    def score_bg(self, w2, w3):
        """bg(w2, w3) with unigram backoff; w2 < 0 -> unigram."""
        w2c = jnp.maximum(w2, 0)
        b = self._find_bg(w2c, w3)
        hit = b >= 0
        bc = jnp.maximum(b, 0)
        backoff = self.ug_bo[w2c] + self.ug_prob[w3]
        s = jnp.where(hit, self.bg_prob[bc], backoff)
        return jnp.where(w2 < 0, self.ug_prob[w3], s)

    def score_rows(self, h1, h2):
        """Dense trigram score rows for a small batch of histories:
        [E] (h1, h2) pairs -> [E, V] scores for EVERY word.

        Built by scattering the DMP successor lists instead of running
        E x V binary searches — the device analog of the reference's
        per-history tginfo caches (lm/lm3g_templates.c:46-260): start from
        the backed-off base row, overwrite the h2 bigram successors, add
        bo(h1,h2), then overwrite the (h1,h2) trigram successors.  -1
        histories back off (h1<0 -> bigram row, h2<0 -> unigram row).
        Exact: matches score_tg elementwise.
        """
        E = int(h1.shape[0])
        V = self.V
        rowsel = jnp.arange(E, dtype=jnp.int32)[:, None]
        h2c = jnp.maximum(h2, 0)
        base = jnp.where(h2[:, None] >= 0,
                         self.ug_bo[h2c][:, None] + self.ug_prob[None, :],
                         self.ug_prob[None, :])                 # [E, V]
        # Column V is a scatter dustbin for masked lanes.
        rows = jnp.concatenate([base, jnp.zeros((E, 1), base.dtype)], axis=1)
        if self.NB:
            lo, hi = self.bg_ptr[h2c], self.bg_ptr[h2c + 1]
            k = jnp.arange(self.MAXB, dtype=jnp.int32)[None, :]
            pos = lo[:, None] + k
            ok = (pos < hi[:, None]) & (h2[:, None] >= 0)
            idx = jnp.minimum(pos, self.NB - 1)
            cols = jnp.where(ok, self.bg_wid[idx], V)
            rows = rows.at[rowsel, cols].set(self.bg_prob[idx])
        if self.n >= 3 and self.NT:
            b = self._find_bg(jnp.maximum(h1, 0), h2c)
            b = jnp.where((h1 >= 0) & (h2 >= 0), b, -1)
            bc = jnp.maximum(b, 0)
            rows = rows + jnp.where(b >= 0, self.bg_bo[bc], 0.0)[:, None]
            lo, hi = self.tg_ptr[bc], self.tg_ptr[bc + 1]
            k = jnp.arange(self.MAXT, dtype=jnp.int32)[None, :]
            pos = lo[:, None] + k
            ok = (pos < hi[:, None]) & (b[:, None] >= 0)
            idx = jnp.minimum(pos, self.NT - 1)
            cols = jnp.where(ok, self.tg_wid[idx], V)
            rows = rows.at[rowsel, cols].set(self.tg_prob[idx])
        return rows[:, :V]

    def score_tg_probe(self, w1, w2, w3):
        """Exact trigram backoff scores via full comparison against the
        (small) bigram/trigram lists — no searches, no row scatters.
        Shapes broadcast; intended for <= ~4k query lanes x <= 16k entries.
        Matches score_tg elementwise."""
        w1, w2, w3 = jnp.broadcast_arrays(w1, w2, w3)
        shp = w1.shape
        w1, w2, w3 = w1.reshape(-1), w2.reshape(-1), w3.reshape(-1)
        w2c = jnp.maximum(w2, 0)
        ug3 = self.ug_prob[jnp.maximum(w3, 0)]
        # bg(w2, w3)
        h23 = ((self._p_bg_w1[None, :] == w2[:, None])
               & (self.bg_wid[None, :] == w3[:, None]))
        has23 = jnp.any(h23, axis=1)
        p23 = jnp.sum(jnp.where(h23, self.bg_prob[None, :], 0.0), axis=1)
        bg23 = jnp.where(w2 < 0, ug3,
                         jnp.where(has23, p23, self.ug_bo[w2c] + ug3))
        if self.n < 3 or self.NT == 0:
            return bg23.reshape(shp)
        # bg(w1, w2) backoff weight
        h12 = ((self._p_bg_w1[None, :] == w1[:, None])
               & (self.bg_wid[None, :] == w2[:, None]))
        bo12 = jnp.sum(jnp.where(h12, self.bg_bo[None, :], 0.0), axis=1)
        # tg(w1, w2, w3)
        ht = ((self._p_tg_w1[None, :] == w1[:, None])
              & (self._p_tg_w2[None, :] == w2[:, None])
              & (self.tg_wid[None, :] == w3[:, None]))
        hast = jnp.any(ht, axis=1)
        pt = jnp.sum(jnp.where(ht, self.tg_prob[None, :], 0.0), axis=1)
        s = jnp.where(hast, pt, bo12 + bg23)
        return jnp.where(w1 < 0, bg23, s).reshape(shp)

    def score_tg(self, w1, w2, w3):
        """Full trigram backoff chain, vectorized over query arrays.

        w1 may be -1 (no context -> bigram), w2 may be -1 (-> unigram).
        """
        if self.tg_dense is not None:
            i1 = jnp.where(w1 < 0, self.V, w1)
            i2 = jnp.where(w2 < 0, self.V, w2)
            w1b, w2b, w3b = jnp.broadcast_arrays(i1, i2, w3)
            return self.tg_dense[w1b, w2b, w3b]
        shp = np.broadcast_shapes(jnp.shape(w1), jnp.shape(w2),
                                  jnp.shape(w3))
        if (self.probe
                and int(np.prod(shp)) * (self.NB + self.NT) <= (64 << 20)):
            return self.score_tg_probe(w1, w2, w3)
        if self.hashed and int(np.prod(shp)) <= (1 << 16):
            return self.score_tg_hashed(w1, w2, w3)
        bg23 = self.score_bg(w2, w3)
        if self.n < 3 or self.NT == 0:
            return bg23
        w1c, w2c = jnp.maximum(w1, 0), jnp.maximum(w2, 0)
        b = self._find_bg(w1c, w2c)
        bhit = b >= 0
        bc = jnp.maximum(b, 0)
        t = _row_search(self.tg_wid, self.tg_ptr[bc], self.tg_ptr[bc + 1], w3)
        thit = bhit & (t >= 0)
        via_bo = jnp.where(bhit, self.bg_bo[bc], 0.0) + bg23
        s = jnp.where(thit, self.tg_prob[jnp.maximum(t, 0)], via_bo)
        return jnp.where(w1 < 0, bg23, s)

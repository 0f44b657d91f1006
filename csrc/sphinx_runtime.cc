// Native host runtime for cmusphinx_tpu: lm3g trigram scoring core +
// word-lattice results layer (bestpath / posterior / A* N-best).
//
// The device owns the per-frame compute (senone scoring, Viterbi token passing,
// Baum-Welch); this library owns the pointer-chasing host graph algorithms
// that the reference also keeps native:
//   - lm3g CSR binary-search scoring  (reference: sphinxbase
//     lm/lm3g_templates.c:46-260 find_bg/find_tg/lm3g_tg_score)
//   - exact trigram Viterbi over the lattice (reference:
//     pocketsphinx ps_lattice.c:1224 ps_lattice_bestpath)
//   - forward-backward link posteriors  (ps_lattice.c:1394)
//   - A* N-best with best-completion heuristic  (ps_lattice.c:1518-1757)
//
// Data comes in as flat arrays (the Python side extracts them from
// NgramModel / Lattice); no Python objects cross the boundary.  Build:
//   g++ -O2 -shared -fPIC -std=c++17 sphinx_runtime.cc -o libsphinx_runtime.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_map>
#include <algorithm>
#include <limits>

namespace {

constexpr float NEG = -1.0e30f;

// ---------------------------------------------------------------------------
// lm3g scoring core: CSR unigram/bigram/trigram tables, natural-log probs.
struct Lm3g {
  int32_t V;                 // vocabulary size
  const float *ug_prob, *ug_bo;
  const int64_t *bg_ptr;     // [V+1]
  const int32_t *bg_wid;     // [NB] sorted within each row
  const float *bg_prob, *bg_bo;
  const int64_t *tg_ptr;     // [NB+1]
  const int32_t *tg_wid;     // [NT] sorted within each row
  const float *tg_prob;
  int32_t order;             // 1, 2 or 3

  int64_t find_bg(int32_t w1, int32_t w2) const {
    int64_t lo = bg_ptr[w1], hi = bg_ptr[w1 + 1];
    const int32_t* first = bg_wid + lo;
    const int32_t* last = bg_wid + hi;
    const int32_t* it = std::lower_bound(first, last, w2);
    if (it != last && *it == w2) return lo + (it - first);
    return -1;
  }
  float ug_score(int32_t w) const { return ug_prob[w]; }
  float bg_score(int32_t w1, int32_t w2) const {
    if (w1 < 0) return ug_score(w2);
    int64_t b = find_bg(w1, w2);
    if (b >= 0) return bg_prob[b];
    return ug_bo[w1] + ug_score(w2);
  }
  float tg_score(int32_t w1, int32_t w2, int32_t w3) const {
    if (order < 3 || w1 < 0) return bg_score(w2, w3);
    int64_t b = find_bg(w1, w2);
    if (b < 0) return bg_score(w2, w3);
    int64_t lo = tg_ptr[b], hi = tg_ptr[b + 1];
    const int32_t* first = tg_wid + lo;
    const int32_t* last = tg_wid + hi;
    const int32_t* it = std::lower_bound(first, last, w3);
    if (it != last && *it == w3) return tg_prob[lo + (it - first)];
    return bg_bo[b] + bg_score(w2, w3);
  }
};

// ---------------------------------------------------------------------------
// Lattice view over flat arrays (one word instance per node).
struct Lat {
  int32_t N, n_ci, sil_ci;
  const int32_t *sf, *ef, *lmwid, *firstci;
  const uint8_t* is_filler;
  const uint8_t* is_finish;   // node IS the finish word </s> (filler or not)
  const float *fil_pen, *entry_score, *vit_score;
  const float* rc_score;       // [N, n_ci]
  const int64_t* succ_ptr;     // [N+1]
  const int32_t* succ;         // [E]
  Lm3g lm;
  float lw, log_wip;
  int32_t finish_lmwid, start_lmwid;

  float link_ascr(int32_t i, int32_t dst_firstci) const {
    float s = rc_score[(int64_t)i * n_ci + dst_firstci];
    if (s <= NEG / 2) s = vit_score[i];
    return s - entry_score[i];
  }
  float final_ascr(int32_t i) const {
    float s = rc_score[(int64_t)i * n_ci + sil_ci];
    if (s <= NEG / 2) s = vit_score[i];
    return s - entry_score[i];
  }
  float lm_term(int32_t h1, int32_t h2, int32_t j, float lw_) const {
    if (is_filler[j]) return fil_pen[j];
    return lw_ * lm.tg_score(h1, h2, lmwid[j]) + log_wip;
  }
  void next_hist(int32_t h1, int32_t h2, int32_t j,
                 int32_t* o1, int32_t* o2) const {
    if (is_filler[j]) { *o1 = h1; *o2 = h2; }
    else { *o1 = h2; *o2 = lmwid[j]; }
  }
};

inline uint64_t histkey(int32_t h1, int32_t h2) {
  return (uint64_t)(uint32_t)(h1 + 1) << 32 | (uint32_t)(h2 + 1);
}

std::vector<int32_t> topo_order(const Lat& L) {
  std::vector<int32_t> order(L.N);
  for (int32_t i = 0; i < L.N; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (L.sf[a] != L.sf[b]) return L.sf[a] < L.sf[b];
    return L.ef[a] < L.ef[b];
  });
  return order;
}

}  // namespace

extern "C" {

// Scalar / batch trigram scoring (exposed for tests and host rescoring).
float lm3g_tg_score(const float* ug_prob, const float* ug_bo,
                    const int64_t* bg_ptr, const int32_t* bg_wid,
                    const float* bg_prob, const float* bg_bo,
                    const int64_t* tg_ptr, const int32_t* tg_wid,
                    const float* tg_prob, int32_t V, int32_t order,
                    int32_t w1, int32_t w2, int32_t w3) {
  Lm3g lm{V, ug_prob, ug_bo, bg_ptr, bg_wid, bg_prob, bg_bo,
          tg_ptr, tg_wid, tg_prob, order};
  return lm.tg_score(w1, w2, w3);
}

void lm3g_tg_score_batch(const float* ug_prob, const float* ug_bo,
                         const int64_t* bg_ptr, const int32_t* bg_wid,
                         const float* bg_prob, const float* bg_bo,
                         const int64_t* tg_ptr, const int32_t* tg_wid,
                         const float* tg_prob, int32_t V, int32_t order,
                         const int32_t* w1, const int32_t* w2,
                         const int32_t* w3, int64_t n, float* out) {
  Lm3g lm{V, ug_prob, ug_bo, bg_ptr, bg_wid, bg_prob, bg_bo,
          tg_ptr, tg_wid, tg_prob, order};
  for (int64_t i = 0; i < n; ++i) out[i] = lm.tg_score(w1[i], w2[i], w3[i]);
}

// Exact trigram Viterbi bestpath over the lattice.
// prune_beam > 0 enables a bigram-approximate forward/backward max pass
// (one state per node, the LM history collapsed to the predecessor word —
// the same approximation ps_lattice_bestpath's alpha pass makes) whose
// link scores gate the exact trigram DP: only links on some path within
// prune_beam (natural-log units) of the global best survive.  The exact
// pass then runs over the surviving sub-lattice.
// Outputs: path node ids into out_path (capacity max_path), returns path
// length (0 = no path); *out_score = total path score.
int32_t lattice_bestpath(
    // lattice arrays
    int32_t N, int32_t n_ci, int32_t sil_ci,
    const int32_t* sf, const int32_t* ef, const int32_t* lmwid,
    const int32_t* firstci, const uint8_t* is_filler,
    const uint8_t* is_finish, const float* fil_pen,
    const float* entry_score, const float* vit_score, const float* rc_score,
    const int64_t* succ_ptr, const int32_t* succ,
    // lm arrays
    const float* ug_prob, const float* ug_bo, const int64_t* bg_ptr,
    const int32_t* bg_wid, const float* bg_prob, const float* bg_bo,
    const int64_t* tg_ptr, const int32_t* tg_wid, const float* tg_prob,
    int32_t V, int32_t order,
    // params
    float lw, float log_wip, int32_t finish_lmwid, int32_t start_lmwid,
    float prune_beam,
    // out
    int32_t* out_path, int32_t max_path, float* out_score) {
  Lat L{N, n_ci, sil_ci, sf, ef, lmwid, firstci, is_filler, is_finish,
        fil_pen,
        entry_score, vit_score, rc_score, succ_ptr, succ,
        {V, ug_prob, ug_bo, bg_ptr, bg_wid, bg_prob, bg_bo,
         tg_ptr, tg_wid, tg_prob, order},
        lw, log_wip, finish_lmwid, start_lmwid};

  auto order_v = topo_order(L);

  // Optional link pruning: per-node forward/backward best-path scores with
  // the bigram history approximation; a link survives iff the best path
  // through it is within prune_beam of the global best.
  std::vector<uint8_t> keep;
  if (prune_beam > 0.0f) {
    std::vector<float> fwd(N, NEG), bwd(N, NEG);
    for (int32_t i = 0; i < N; ++i)
      if (sf[i] == 0) fwd[i] = L.lm_term(-1, start_lmwid, i, lw);
    for (int32_t oi = 0; oi < N; ++oi) {
      int32_t i = order_v[oi];
      if (fwd[i] <= NEG / 2) continue;
      for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
        int32_t j = succ[e];
        float c = fwd[i] + L.link_ascr(i, firstci[j]) +
                  L.lm_term(-1, lmwid[i], j, lw);
        if (c > fwd[j]) fwd[j] = c;
      }
    }
    float best = -std::numeric_limits<float>::infinity();
    for (int32_t i = 0; i < N; ++i) {
      if (succ_ptr[i] != succ_ptr[i + 1]) continue;
      float fin = L.final_ascr(i);
      if (!is_finish[i])
        fin += lw * L.lm.bg_score(lmwid[i], finish_lmwid);
      bwd[i] = fin;
      if (fwd[i] > NEG / 2 && fwd[i] + fin > best) best = fwd[i] + fin;
    }
    for (int32_t oi = N - 1; oi >= 0; --oi) {
      int32_t i = order_v[oi];
      for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
        int32_t j = succ[e];
        if (bwd[j] <= NEG / 2) continue;
        float c = L.link_ascr(i, firstci[j]) + L.lm_term(-1, lmwid[i], j, lw)
                  + bwd[j];
        if (c > bwd[i]) bwd[i] = c;
      }
    }
    keep.assign((size_t)succ_ptr[N], 0);
    float thr = best - prune_beam;
    for (int32_t i = 0; i < N; ++i) {
      if (fwd[i] <= NEG / 2) continue;
      for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
        int32_t j = succ[e];
        if (bwd[j] <= NEG / 2) continue;
        float c = fwd[i] + L.link_ascr(i, firstci[j]) +
                  L.lm_term(-1, lmwid[i], j, lw) + bwd[j];
        if (c >= thr) keep[e] = 1;
      }
    }
  }

  struct State { float score; int32_t node, h1, h2, prev; };
  std::vector<State> states;
  // Per node: hist -> state index.
  std::vector<std::unordered_map<uint64_t, int32_t>> at(N);

  for (int32_t i = 0; i < N; ++i) {
    if (sf[i] != 0) continue;
    float t = L.lm_term(-1, start_lmwid, i, lw);
    int32_t h1, h2;
    L.next_hist(-1, start_lmwid, i, &h1, &h2);
    uint64_t k = histkey(h1, h2);
    auto it = at[i].find(k);
    if (it == at[i].end()) {
      at[i][k] = (int32_t)states.size();
      states.push_back({t, i, h1, h2, -1});
    } else if (t > states[it->second].score) {
      states[it->second] = {t, i, h1, h2, -1};
    }
  }
  for (int32_t oi = 0; oi < N; ++oi) {
    int32_t i = order_v[oi];
    // Copy keys first: pushing to succ==i can't happen (succ starts later),
    // but states vector may reallocate.
    std::vector<int32_t> here;
    here.reserve(at[i].size());
    for (auto& kv : at[i]) here.push_back(kv.second);
    // Hoist the per-destination acoustic/LM-independent work: link ascr
    // depends only on (i, firstci[j]) and the trigram row cache keeps the
    // inner loop light.
    for (int32_t si : here) {
      State s = states[si];
      for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
        if (!keep.empty() && !keep[e]) continue;
        int32_t j = succ[e];
        float ascr = L.link_ascr(i, firstci[j]);
        float t = L.lm_term(s.h1, s.h2, j, lw);
        int32_t h1, h2;
        L.next_hist(s.h1, s.h2, j, &h1, &h2);
        float nsc = s.score + ascr + t;
        uint64_t k = histkey(h1, h2);
        auto it = at[j].find(k);
        if (it == at[j].end()) {
          at[j][k] = (int32_t)states.size();
          states.push_back({nsc, j, h1, h2, si});
        } else if (nsc > states[it->second].score) {
          states[it->second] = {nsc, j, h1, h2, si};
        }
      }
    }
  }
  // Final states: nodes with no successors.
  int32_t best = -1;
  float bests = -std::numeric_limits<float>::infinity();
  for (int32_t i = 0; i < N; ++i) {
    if (succ_ptr[i] != succ_ptr[i + 1]) continue;
    for (auto& kv : at[i]) {
      const State& s = states[kv.second];
      float v = s.score + L.final_ascr(i);
      if (!is_finish[i])
        v += lw * L.lm.tg_score(s.h1, s.h2, finish_lmwid);
      if (v > bests) { bests = v; best = kv.second; }
    }
  }
  if (best < 0) return 0;
  *out_score = bests;
  std::vector<int32_t> rev;
  for (int32_t si = best; si >= 0; si = states[si].prev)
    rev.push_back(states[si].node);
  int32_t n = (int32_t)rev.size();
  if (n > max_path) return -n;  // caller retries with bigger buffer
  for (int32_t k = 0; k < n; ++k) out_path[k] = rev[n - 1 - k];
  return n;
}

// Forward-backward node posteriors (bigram-approximate link LM weights,
// matching Lattice.posterior).  out_post: [N] natural-log posteriors.
void lattice_posterior(
    int32_t N, int32_t n_ci, int32_t sil_ci,
    const int32_t* sf, const int32_t* ef, const int32_t* lmwid,
    const int32_t* firstci, const uint8_t* is_filler,
    const uint8_t* is_finish, const float* fil_pen,
    const float* entry_score, const float* vit_score, const float* rc_score,
    const int64_t* succ_ptr, const int32_t* succ,
    const float* ug_prob, const float* ug_bo, const int64_t* bg_ptr,
    const int32_t* bg_wid, const float* bg_prob, const float* bg_bo,
    const int64_t* tg_ptr, const int32_t* tg_wid, const float* tg_prob,
    int32_t V, int32_t order,
    float lw, float log_wip, int32_t finish_lmwid, float ascale,
    double* out_post) {
  Lat L{N, n_ci, sil_ci, sf, ef, lmwid, firstci, is_filler, is_finish,
        fil_pen,
        entry_score, vit_score, rc_score, succ_ptr, succ,
        {V, ug_prob, ug_bo, bg_ptr, bg_wid, bg_prob, bg_bo,
         tg_ptr, tg_wid, tg_prob, order},
        lw, log_wip, finish_lmwid, -1};
  const double NINF = -std::numeric_limits<double>::infinity();
  std::vector<double> alpha(N, NINF), beta(N, NINF);
  auto lgadd = [](double a, double b) {
    if (a == -std::numeric_limits<double>::infinity()) return b;
    if (b == -std::numeric_limits<double>::infinity()) return a;
    double m = a > b ? a : b;
    return m + std::log(std::exp(a - m) + std::exp(b - m));
  };
  auto order_v = topo_order(L);
  int32_t maxef = -1;
  for (int32_t i = 0; i < N; ++i) maxef = std::max(maxef, ef[i]);
  for (int32_t i = 0; i < N; ++i)
    if (sf[i] == 0) alpha[i] = ascale * L.lm_term(-1, -1, i, lw);
  for (int32_t oi = 0; oi < N; ++oi) {
    int32_t i = order_v[oi];
    if (alpha[i] == NINF) continue;
    for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
      int32_t j = succ[e];
      double w = ascale * (L.link_ascr(i, firstci[j]) +
                           L.lm_term(-1, lmwid[i], j, lw));
      alpha[j] = lgadd(alpha[j], alpha[i] + w);
    }
  }
  for (int32_t i = 0; i < N; ++i)
    if (ef[i] == maxef) beta[i] = ascale * L.final_ascr(i);
  for (int32_t oi = N - 1; oi >= 0; --oi) {
    int32_t i = order_v[oi];
    for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
      int32_t j = succ[e];
      if (beta[j] == NINF) continue;
      double w = ascale * (L.link_ascr(i, firstci[j]) +
                           L.lm_term(-1, lmwid[i], j, lw));
      beta[i] = lgadd(beta[i], beta[j] + w);
    }
  }
  double total = NINF;
  for (int32_t i = 0; i < N; ++i)
    if (ef[i] == maxef && alpha[i] != NINF)
      total = lgadd(total, alpha[i] + beta[i]);
  for (int32_t i = 0; i < N; ++i) out_post[i] = alpha[i] + beta[i] - total;
}

// A* N-best.  Emits up to n_best paths as (len, node ids...) records packed
// into out_nodes / out_lens / out_scores.  Duplicate word sequences are
// de-duplicated by the caller (needs word identity, not node identity).
int32_t lattice_nbest(
    int32_t N, int32_t n_ci, int32_t sil_ci,
    const int32_t* sf, const int32_t* ef, const int32_t* lmwid,
    const int32_t* firstci, const uint8_t* is_filler,
    const uint8_t* is_finish, const float* fil_pen,
    const float* entry_score, const float* vit_score, const float* rc_score,
    const int64_t* succ_ptr, const int32_t* succ,
    const float* ug_prob, const float* ug_bo, const int64_t* bg_ptr,
    const int32_t* bg_wid, const float* bg_prob, const float* bg_bo,
    const int64_t* tg_ptr, const int32_t* tg_wid, const float* tg_prob,
    int32_t V, int32_t order,
    float lw, float log_wip, int32_t finish_lmwid, int32_t start_lmwid,
    int32_t n_best, int32_t max_pop,
    int32_t* out_nodes, int64_t out_cap, int32_t* out_lens,
    float* out_scores) {
  Lat L{N, n_ci, sil_ci, sf, ef, lmwid, firstci, is_filler, is_finish,
        fil_pen,
        entry_score, vit_score, rc_score, succ_ptr, succ,
        {V, ug_prob, ug_bo, bg_ptr, bg_wid, bg_prob, bg_bo,
         tg_ptr, tg_wid, tg_prob, order},
        lw, log_wip, finish_lmwid, start_lmwid};
  // Backward best-completion heuristic (ps_lattice.c:1518 best_rem_score).
  std::vector<float> h(N, NEG);
  auto order_v = topo_order(L);
  for (int32_t i = 0; i < N; ++i) {
    if (succ_ptr[i] != succ_ptr[i + 1]) continue;
    float s = L.final_ascr(i);
    if (!is_finish[i]) s += lw * L.lm.bg_score(lmwid[i], finish_lmwid);
    h[i] = s;
  }
  for (int32_t oi = N - 1; oi >= 0; --oi) {
    int32_t i = order_v[oi];
    for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
      int32_t j = succ[e];
      if (h[j] <= NEG / 2) continue;
      float s = L.link_ascr(i, firstci[j]) + L.lm_term(-1, lmwid[i], j, lw)
                + h[j];
      h[i] = std::max(h[i], s);
    }
  }
  struct Path { float g; int32_t node, h1, h2, parent; };
  std::vector<Path> paths;
  using QE = std::pair<float, int32_t>;  // (f, path idx)
  std::priority_queue<QE> heap;
  for (int32_t i = 0; i < N; ++i) {
    if (sf[i] != 0) continue;
    float g = L.lm_term(-1, start_lmwid, i, lw);
    int32_t h1, h2;
    L.next_hist(-1, start_lmwid, i, &h1, &h2);
    paths.push_back({g, i, h1, h2, -1});
    heap.push({g + h[i], (int32_t)paths.size() - 1});
  }
  int32_t emitted = 0;
  int64_t out_pos = 0;
  int32_t pops = 0;
  while (!heap.empty() && emitted < n_best && pops < max_pop) {
    auto [f, pi] = heap.top();
    heap.pop();
    ++pops;
    Path p = paths[pi];
    int32_t i = p.node;
    if (succ_ptr[i] == succ_ptr[i + 1]) {
      float s = p.g + L.final_ascr(i);
      if (!is_finish[i])
        s += lw * L.lm.tg_score(p.h1, p.h2, finish_lmwid);
      // Emit path (reverse order, then flip).
      std::vector<int32_t> rev;
      for (int32_t q = pi; q >= 0; q = paths[q].parent)
        rev.push_back(paths[q].node);
      if (out_pos + (int64_t)rev.size() > out_cap) break;
      for (size_t k = 0; k < rev.size(); ++k)
        out_nodes[out_pos + k] = rev[rev.size() - 1 - k];
      out_pos += rev.size();
      out_lens[emitted] = (int32_t)rev.size();
      out_scores[emitted] = s;
      ++emitted;
      continue;
    }
    for (int64_t e = succ_ptr[i]; e < succ_ptr[i + 1]; ++e) {
      int32_t j = succ[e];
      float g2 = p.g + L.link_ascr(i, firstci[j]) +
                 L.lm_term(p.h1, p.h2, j, lw);
      int32_t h1, h2;
      L.next_hist(p.h1, p.h2, j, &h1, &h2);
      paths.push_back({g2, j, h1, h2, pi});
      heap.push({g2 + h[j], (int32_t)paths.size() - 1});
    }
  }
  return emitted;
}

}  // extern "C"

// Native variant-graph verifier.
//
// C++ port of hgtpu/align/verify.py's edit-script search (itself the
// device-native replacement for HISAT2's extension stage): walk match runs,
// branch at indel-variant positions and observed mismatches, known
// catalog variants free, novel edits charged to the budget.  Exploration
// order matches the Python implementation exactly (plain spelling first,
// then deletions in table order, then insertions; first-found wins cost
// ties), so results are bit-identical.
//
// The batch API verifies flattened (read, start-proposal) pairs across
// std::threads — the host-side hot loop of single-chip typing.

#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int MAX_OPS = 256;

// op kinds
constexpr int8_t OP_MISMATCH = 0;
constexpr int8_t OP_DELETION = 1;
constexpr int8_t OP_INSERTION = 2;

struct Op {
  int8_t kind;
  int32_t pos;
  int32_t length;
  int32_t var;       // catalog index or -1
  int32_t read_off;  // read offset where the op applies
};

struct GeneTables {
  std::vector<int8_t> bb;
  // singles sorted by pos: parallel arrays
  std::vector<int32_t> s_pos;
  std::vector<int8_t> s_base;
  std::vector<int32_t> s_vi;
  // per indel position: ranges into dels / inss
  std::vector<int32_t> d_pos, d_len, d_vi;
  std::vector<int32_t> i_pos, i_off, i_len, i_vi;
  std::vector<int8_t> ins_blob;
  std::vector<int32_t> indel_pos;  // sorted unique positions with any indel
  // per indel_pos entry: [start,end) into dels and inss arrays (which are
  // grouped by position in construction order)
  std::vector<int32_t> d_start, d_end, i_start, i_end;
  // haplotype-window path constraint (mirrors
  // hgtpu.align.verify.build_haplotype_constraint): forbidden ordered
  // catalog-indel pairs and per-variant constraint reach
  std::unordered_set<int64_t> hap_disallowed;
  std::unordered_map<int32_t, int32_t> hap_cover_right;

  int32_t cover_right_of(int32_t vi) const {
    auto it = hap_cover_right.find(vi);
    return it == hap_cover_right.end() ? -1 : it->second;
  }

  int32_t single_at(int32_t pos, int8_t base) const {
    // binary search over s_pos then scan equal range
    size_t lo = 0, hi = s_pos.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (s_pos[mid] < pos) lo = mid + 1; else hi = mid;
    }
    for (size_t k = lo; k < s_pos.size() && s_pos[k] == pos; ++k)
      if (s_base[k] == base) return s_vi[k];
    return -1;
  }

  // index into indel_pos of first entry >= pos (or size)
  size_t indel_lb(int32_t pos) const {
    size_t lo = 0, hi = indel_pos.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (indel_pos[mid] < pos) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
};

struct Search {
  const GeneTables* g;
  const int8_t* read;
  int32_t m;
  int32_t max_novel;
  bool novel_indels;
  int32_t best_cost;
  Op best_ops[MAX_OPS];
  int32_t best_nops;
  Op ops[MAX_OPS];
  int32_t nops;
  std::unordered_map<int64_t, int32_t> memo;

  void finish(int32_t budget) {
    int32_t cost = max_novel - budget;
    if (cost < best_cost) {
      best_cost = cost;
      best_nops = nops;
      std::memcpy(best_ops, ops, sizeof(Op) * nops);
    }
  }

  bool hap_ok(int32_t vi) const {
    if (g->hap_disallowed.empty()) return true;
    for (int32_t k = 0; k < nops; ++k) {
      const Op& o = ops[k];
      if (o.var >= 0 && o.kind != OP_MISMATCH &&
          g->hap_disallowed.count(((int64_t)o.var << 32) | (uint32_t)vi))
        return false;
    }
    return true;
  }

  void dfs(int32_t ri, int32_t pos, int32_t budget, bool skip_indel,
           int32_t act_r) {
    const GeneTables& G = *g;
    const int64_t P = (int64_t)G.bb.size();
    if (ri == m) { finish(budget); return; }
    if (pos >= P) return;
    if (nops >= MAX_OPS) return;
    if (!skip_indel) {
      int64_t key = ((int64_t)ri << 32) | (uint32_t)pos;
      auto it = memo.find(key);
      if (it != memo.end() && it->second >= budget) return;
      // store only constraint-free states (see verify.py)
      if (pos > act_r) memo[key] = budget;
      if (ri > 0) {
        size_t lb = G.indel_lb(pos);
        if (lb < G.indel_pos.size() && G.indel_pos[lb] == pos) {
          // plain spelling first
          dfs(ri, pos, budget, true, act_r);
          for (int32_t k = G.d_start[lb]; k < G.d_end[lb]; ++k) {
            if (!hap_ok(G.d_vi[k])) continue;
            ops[nops++] = {OP_DELETION, pos, G.d_len[k], G.d_vi[k], ri};
            dfs(ri, pos + G.d_len[k], budget, false,
                std::max(act_r, G.cover_right_of(G.d_vi[k])));
            --nops;
          }
          for (int32_t k = G.i_start[lb]; k < G.i_end[lb]; ++k) {
            int32_t d = G.i_len[k];
            if (ri + d <= m &&
                std::memcmp(read + ri, G.ins_blob.data() + G.i_off[k], d)
                    == 0) {
              if (!hap_ok(G.i_vi[k])) continue;
              ops[nops++] = {OP_INSERTION, pos, d, G.i_vi[k], ri};
              dfs(ri + d, pos, budget, false,
                  std::max(act_r, G.cover_right_of(G.i_vi[k])));
              --nops;
            }
          }
          return;
        }
      }
    }
    // advance along the diagonal to the next event
    int32_t span = (int32_t)std::min((int64_t)(m - ri), P - pos);
    int32_t nm = span;
    for (int32_t j = 0; j < span; ++j) {
      if (read[ri + j] != G.bb[pos + j]) { nm = j; break; }
    }
    if (nm > 0) {
      size_t lb = G.indel_lb(pos + 1);
      int32_t ni = (lb < G.indel_pos.size())
                       ? G.indel_pos[lb] - pos
                       : (int32_t)std::min<int64_t>(P + m, INT32_MAX / 2);
      int32_t adv = std::min(std::min(nm, ni), span);
      if (!(adv == nm && nm < ni && nm < span)) {
        dfs(ri + adv, pos + adv, budget, false, act_r);
        return;
      }
      ri += nm;
      pos += nm;
    }
    // mismatch event at (ri, pos)
    int8_t base = read[ri];
    int32_t vi = G.single_at(pos, base);
    if (vi >= 0) {
      ops[nops++] = {OP_MISMATCH, pos, 1, vi, ri};
      dfs(ri + 1, pos + 1, budget, false, act_r);
      --nops;
      return;
    }
    if (budget > 0) {
      ops[nops++] = {OP_MISMATCH, pos, 1, -1, ri};
      dfs(ri + 1, pos + 1, budget - 1, false, act_r);
      --nops;
    }
    if (novel_indels && ri > 0) {
      for (int32_t d = 1; d <= 2; ++d) {
        if (budget - d < 0) continue;
        ops[nops++] = {OP_DELETION, pos, d, -1, ri};
        dfs(ri, pos + d, budget - d, false, act_r);
        --nops;
        if (ri + d <= m) {
          ops[nops++] = {OP_INSERTION, pos, d, -1, ri};
          dfs(ri + d, pos, budget - d, false, act_r);
          --nops;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

GeneTables* hgtpu_gene_create(
    const int8_t* bb, int64_t P,
    const int32_t* s_pos, const int8_t* s_base, const int32_t* s_vi,
    int64_t n_single,
    const int32_t* indel_pos, int64_t n_indel,
    const int32_t* d_start, const int32_t* d_end,
    const int32_t* d_pos, const int32_t* d_len, const int32_t* d_vi,
    int64_t n_del,
    const int32_t* i_start, const int32_t* i_end,
    const int32_t* i_pos, const int32_t* i_off, const int32_t* i_len,
    const int32_t* i_vi, int64_t n_ins,
    const int8_t* ins_blob, int64_t blob_len) {
  auto* g = new GeneTables();
  g->bb.assign(bb, bb + P);
  g->s_pos.assign(s_pos, s_pos + n_single);
  g->s_base.assign(s_base, s_base + n_single);
  g->s_vi.assign(s_vi, s_vi + n_single);
  g->indel_pos.assign(indel_pos, indel_pos + n_indel);
  g->d_start.assign(d_start, d_start + n_indel);
  g->d_end.assign(d_end, d_end + n_indel);
  g->i_start.assign(i_start, i_start + n_indel);
  g->i_end.assign(i_end, i_end + n_indel);
  g->d_pos.assign(d_pos, d_pos + n_del);
  g->d_len.assign(d_len, d_len + n_del);
  g->d_vi.assign(d_vi, d_vi + n_del);
  g->i_pos.assign(i_pos, i_pos + n_ins);
  g->i_off.assign(i_off, i_off + n_ins);
  g->i_len.assign(i_len, i_len + n_ins);
  g->i_vi.assign(i_vi, i_vi + n_ins);
  g->ins_blob.assign(ins_blob, ins_blob + blob_len);
  return g;
}

void hgtpu_gene_destroy(GeneTables* g) { delete g; }

// Install the haplotype-window path constraint: `dis_u/dis_v` list the
// forbidden ordered pairs (both orders supplied by the caller), and
// (cr_var, cr_val) the per-variant constraint reach.
void hgtpu_gene_set_hap(GeneTables* g,
                        const int32_t* dis_u, const int32_t* dis_v,
                        int64_t n_dis,
                        const int32_t* cr_var, const int32_t* cr_val,
                        int64_t n_cr) {
  g->hap_disallowed.clear();
  g->hap_cover_right.clear();
  for (int64_t i = 0; i < n_dis; ++i)
    g->hap_disallowed.insert(((int64_t)dis_u[i] << 32) | (uint32_t)dis_v[i]);
  for (int64_t i = 0; i < n_cr; ++i)
    g->hap_cover_right[cr_var[i]] = cr_val[i];
}

// Verify flattened (read, start) pairs.  Outputs per pair:
//   out_cost[i]  best novel-edit cost, or -1 when no alignment found
//   out_nops[i]  number of ops
//   out_ops      [n_pairs, MAX_OPS, 5] int32: kind,pos,len,var,read_off
void hgtpu_verify_batch(
    GeneTables* g,
    const int8_t* reads_blob, const int64_t* read_off,
    const int32_t* read_len,
    const int32_t* starts, int64_t n_pairs,
    int32_t max_novel, int32_t novel_indels, int32_t n_threads,
    int32_t* out_cost, int32_t* out_nops, int32_t* out_ops) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int8_t* read = reads_blob + read_off[i];
      int32_t m = read_len[i];
      int32_t start = starts[i];
      out_cost[i] = -1;
      out_nops[i] = 0;
      if (start < 0 || start >= (int64_t)g->bb.size() || m == 0) continue;
      Search s;
      s.g = g;
      s.read = read;
      s.m = m;
      s.max_novel = max_novel;
      s.novel_indels = novel_indels != 0;
      s.best_cost = max_novel + 1;
      s.best_nops = 0;
      s.nops = 0;
      s.dfs(0, start, max_novel, false, -1);
      if (s.best_cost <= max_novel) {
        out_cost[i] = s.best_cost;
        out_nops[i] = s.best_nops;
        int32_t* dst = out_ops + i * MAX_OPS * 5;
        for (int32_t k = 0; k < s.best_nops; ++k) {
          dst[k * 5 + 0] = s.best_ops[k].kind;
          dst[k * 5 + 1] = s.best_ops[k].pos;
          dst[k * 5 + 2] = s.best_ops[k].length;
          dst[k * 5 + 3] = s.best_ops[k].var;
          dst[k * 5 + 4] = s.best_ops[k].read_off;
        }
      }
    }
  };
  if (n_threads <= 1 || n_pairs < 16) {
    work(0, n_pairs);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_pairs + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min<int64_t>(n_pairs, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

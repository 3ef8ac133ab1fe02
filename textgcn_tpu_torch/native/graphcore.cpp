// Native graph-construction core.
//
// TPU-native framework's host-side runtime: the reference does all graph
// assembly through networkx/scipy Python loops (reference trainer.py:98-148,
// build_graph.py:99-133); here the hot host paths are C++:
//   - weighted edgelist text parsing ("u v w" lines)
//   - COO coalescing with sum/max reduction (symmetrization support)
//   - symmetric normalization D^-1/2 (A+I) D^-1/2
//   - sliding-window co-occurrence counting for TextGCN PMI
//
// Exposed via a C ABI for ctypes (no pybind11 in this image). Memory
// protocol: functions allocate into an opaque Buffers handle; the caller
// copies out through pointers and frees the handle.
//
// This is textgcn_tpu_torch's own copy of textgcn_tpu/native/graphcore.cpp,
// with two changes:
//   - tg_window_cooccurrence returns its pairs sorted by (i, j), where the
//     original returns them in unordered_map order (unspecified);
//   - tg_parse_edgelist stops every field at the line end. The original lets
//     strtoll/strtod skip the newline, so a "u v" line took its weight from
//     the next line and lost that line; here it gets weight 1, as in the
//     Python loop.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Buffers {
  std::vector<int64_t> rows;
  std::vector<int64_t> cols;
  std::vector<double> vals;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Edgelist parsing
// ---------------------------------------------------------------------------

// Parse "u v [w]" lines. Returns a handle (or nullptr on error); the edge
// count is written to *n_out.
void* tg_parse_edgelist(const char* path, int64_t* n_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> data(static_cast<size_t>(size) + 1);
  size_t rd = std::fread(data.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  data[rd] = '\0';

  auto* buf = new Buffers();
  buf->rows.reserve(1 << 20);
  buf->cols.reserve(1 << 20);
  buf->vals.reserve(1 << 20);

  char* p = data.data();
  char* end = p + rd;
  // Skip blanks up to the next field, but never past the line end.
  auto skip_blanks = [&](char* s) {
    while (s < end && *s != '\n' &&
           std::isspace(static_cast<unsigned char>(*s)))
      ++s;
    return s;
  };
  while (p < end) {
    // skip leading whitespace/newlines
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    char* q = nullptr;
    long long u = std::strtoll(p, &q, 10);
    if (q == p) {  // malformed line: skip to newline
      while (p < end && *p != '\n') ++p;
      continue;
    }
    p = skip_blanks(q);
    long long v = 0;
    q = p;
    if (p < end && *p != '\n') v = std::strtoll(p, &q, 10);
    if (q == p) {  // one field or a malformed node id: skip the line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    p = skip_blanks(q);
    double w = 1.0;
    q = p;
    if (p < end && *p != '\n') w = std::strtod(p, &q);
    if (q == p) {
      w = 1.0;
    } else {
      p = q;
    }
    buf->rows.push_back(u);
    buf->cols.push_back(v);
    buf->vals.push_back(w);
    while (p < end && *p != '\n') ++p;
  }
  *n_out = static_cast<int64_t>(buf->rows.size());
  return buf;
}

void tg_copy_edges(void* handle, int64_t* rows, int64_t* cols, double* vals) {
  auto* buf = static_cast<Buffers*>(handle);
  std::memcpy(rows, buf->rows.data(), buf->rows.size() * sizeof(int64_t));
  std::memcpy(cols, buf->cols.data(), buf->cols.size() * sizeof(int64_t));
  std::memcpy(vals, buf->vals.data(), buf->vals.size() * sizeof(double));
}

void tg_free(void* handle) { delete static_cast<Buffers*>(handle); }

// ---------------------------------------------------------------------------
// COO coalescing / symmetrization / normalization
// ---------------------------------------------------------------------------

// Coalesce duplicate (row, col) entries; reduce = 0 sum, 1 max. If
// symmetrize != 0, A := reduce(A, A^T) first (max-symmetrize with reduce=1
// matches reference trainer.py:148). Returns handle; count in *n_out.
void* tg_coalesce(const int64_t* rows, const int64_t* cols,
                  const double* vals, int64_t n, int64_t n_nodes, int reduce,
                  int symmetrize, int64_t* n_out) {
  size_t total = static_cast<size_t>(symmetrize ? 2 * n : n);
  std::vector<std::pair<int64_t, double>> entries;
  entries.reserve(total);
  for (int64_t i = 0; i < n; ++i) {
    entries.emplace_back(rows[i] * n_nodes + cols[i], vals[i]);
    if (symmetrize) entries.emplace_back(cols[i] * n_nodes + rows[i], vals[i]);
  }
  std::sort(entries.begin(), entries.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });

  auto* buf = new Buffers();
  buf->rows.reserve(entries.size());
  for (size_t i = 0; i < entries.size();) {
    int64_t key = entries[i].first;
    double acc = entries[i].second;
    size_t j = i + 1;
    for (; j < entries.size() && entries[j].first == key; ++j) {
      acc = reduce == 1 ? std::max(acc, entries[j].second)
                        : acc + entries[j].second;
    }
    buf->rows.push_back(key / n_nodes);
    buf->cols.push_back(key % n_nodes);
    buf->vals.push_back(acc);
    i = j;
  }
  *n_out = static_cast<int64_t>(buf->rows.size());
  return buf;
}

// In-place symmetric normalization of a coalesced COO (adds self-loops
// first when add_self_loops != 0). Returns handle with normalized entries.
void* tg_sym_normalize(const int64_t* rows, const int64_t* cols,
                       const double* vals, int64_t n, int64_t n_nodes,
                       int add_self_loops, int64_t* n_out) {
  auto* buf = new Buffers();
  buf->rows.assign(rows, rows + n);
  buf->cols.assign(cols, cols + n);
  buf->vals.assign(vals, vals + n);
  if (add_self_loops) {
    // merge +1 into existing diagonal entries, append missing ones
    std::vector<char> has_diag(static_cast<size_t>(n_nodes), 0);
    for (int64_t i = 0; i < n; ++i) {
      if (buf->rows[i] == buf->cols[i]) {
        buf->vals[i] += 1.0;
        has_diag[static_cast<size_t>(buf->rows[i])] = 1;
      }
    }
    for (int64_t v = 0; v < n_nodes; ++v) {
      if (!has_diag[static_cast<size_t>(v)]) {
        buf->rows.push_back(v);
        buf->cols.push_back(v);
        buf->vals.push_back(1.0);
      }
    }
  }
  std::vector<double> deg(static_cast<size_t>(n_nodes), 0.0);
  for (size_t i = 0; i < buf->rows.size(); ++i) {
    deg[static_cast<size_t>(buf->rows[i])] += buf->vals[i];
  }
  std::vector<double> dinv(static_cast<size_t>(n_nodes), 0.0);
  for (int64_t v = 0; v < n_nodes; ++v) {
    double d = deg[static_cast<size_t>(v)];
    dinv[static_cast<size_t>(v)] = d > 0.0 ? 1.0 / std::sqrt(d) : 0.0;
  }
  for (size_t i = 0; i < buf->rows.size(); ++i) {
    buf->vals[i] *= dinv[static_cast<size_t>(buf->rows[i])] *
                    dinv[static_cast<size_t>(buf->cols[i])];
  }
  *n_out = static_cast<int64_t>(buf->rows.size());
  return buf;
}

// ---------------------------------------------------------------------------
// Sliding-window co-occurrence (TextGCN PMI)
// ---------------------------------------------------------------------------

// tokens: concatenated word-id streams for all docs; offsets: [n_docs+1]
// prefix ranges. Counts, for every unordered pair (i < j), the number of
// sliding windows (width `window`) containing both i and j, plus per-word
// window occurrence counts into occ[vocab]. Returns handle with (i, j,
// count) triplets; window count in *n_windows_out.
void* tg_window_cooccurrence(const int32_t* tokens, const int64_t* offsets,
                             int64_t n_docs, int32_t vocab, int32_t window,
                             int64_t* occ, int64_t* n_windows_out,
                             int64_t* n_out) {
  std::unordered_map<int64_t, int64_t> pair_counts;
  pair_counts.reserve(1 << 20);
  std::vector<int64_t> occ_local(static_cast<size_t>(vocab), 0);
  int64_t n_windows = 0;
  std::vector<int32_t> uniq;
  uniq.reserve(window);

  for (int64_t d = 0; d < n_docs; ++d) {
    int64_t lo = offsets[d], hi = offsets[d + 1];
    int64_t len = hi - lo;
    if (len <= 0) continue;
    int64_t n_win = len <= window ? 1 : len - window + 1;
    for (int64_t s = 0; s < n_win; ++s) {
      int64_t wlo = lo + s;
      int64_t wlen = std::min<int64_t>(window, len - s);
      uniq.assign(tokens + wlo, tokens + wlo + wlen);
      std::sort(uniq.begin(), uniq.end());
      uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
      ++n_windows;
      for (size_t a = 0; a < uniq.size(); ++a) {
        occ_local[static_cast<size_t>(uniq[a])] += 1;
        for (size_t b = a + 1; b < uniq.size(); ++b) {
          int64_t key = static_cast<int64_t>(uniq[a]) * vocab + uniq[b];
          ++pair_counts[key];
        }
      }
    }
  }
  std::memcpy(occ, occ_local.data(), occ_local.size() * sizeof(int64_t));
  *n_windows_out = n_windows;

  std::vector<std::pair<int64_t, int64_t>> pairs(pair_counts.begin(),
                                                 pair_counts.end());
  std::sort(pairs.begin(), pairs.end());
  auto* buf = new Buffers();
  buf->rows.reserve(pairs.size());
  buf->cols.reserve(pairs.size());
  buf->vals.reserve(pairs.size());
  for (const auto& kv : pairs) {
    buf->rows.push_back(kv.first / vocab);
    buf->cols.push_back(kv.first % vocab);
    buf->vals.push_back(static_cast<double>(kv.second));
  }
  *n_out = static_cast<int64_t>(buf->rows.size());
  return buf;
}

}  // extern "C"

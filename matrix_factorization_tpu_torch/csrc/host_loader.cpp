// The port's host helpers: a threaded CSV parse with dense id encoding,
// and the stable counting sorts and gathers of the rating packs.
//
// A copy of the parts of matrix_factorization_tpu/native/loader.cpp that
// the PyTorch port calls (the port imports nothing of the JAX package):
//
// * data/loader.py::load_ratings_csv: mf_count_rows, mf_parse_numeric_csv,
//   mf_dense_encode, mf_find_duplicate_pair (numeric ids; string ids take
//   the pandas path);
// * ops/ials.py's grouped packs: mf_entity_counts, mf_pack_grouped;
// * ops/segment_sgd.py::pack_ratings: mf_sort_ranges, mf_argsort_ranges,
//   mf_gather_rows, mf_sort_triple_by_key;
// * ops/sparse_gram.py: mf_sort_pairs_by_key; models/cf_topk.py:
//   mf_lexsort_pair.
//
// Every sort is a stable counting sort over dense ids, so its output is
// byte for byte that of numpy's argsort(kind='stable') applied to the
// same arrays. C ABI only, bound with ctypes; built at first use by
// ops/_build.py::load_host with the host's g++.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Range {
  const char* begin;
  const char* end;
};

// Split [begin, end) into n ranges aligned on newline boundaries.
std::vector<Range> split_ranges(const char* begin, const char* end, int n) {
  std::vector<Range> out;
  size_t total = static_cast<size_t>(end - begin);
  const char* cur = begin;
  for (int t = 0; t < n; ++t) {
    const char* hi =
        (t == n - 1) ? end : begin + total * (t + 1) / n;
    if (hi < end) {
      const char* nl = static_cast<const char*>(
          memchr(hi, '\n', static_cast<size_t>(end - hi)));
      hi = nl ? nl + 1 : end;
    }
    if (cur < hi) out.push_back({cur, hi});
    cur = hi;
    if (cur >= end) break;
  }
  return out;
}

// Fast decimal parser for CSV number fields ("123", "-4.5", "1e3" falls
// back to strtod).  Returns false on non-numeric content.
bool parse_number(const char* s, const char* e, double* out) {
  while (s < e && (*s == ' ' || *s == '\r')) ++s;
  while (e > s && (e[-1] == ' ' || e[-1] == '\r')) --e;
  if (s >= e) return false;
  bool neg = false;
  if (*s == '-') { neg = true; ++s; }
  else if (*s == '+') { ++s; }
  if (s >= e) return false;
  double v = 0.0;
  bool any = false;
  while (s < e && *s >= '0' && *s <= '9') {
    v = v * 10.0 + (*s - '0');
    ++s;
    any = true;
  }
  if (s < e && *s == '.') {
    ++s;
    double scale = 0.1;
    while (s < e && *s >= '0' && *s <= '9') {
      v += (*s - '0') * scale;
      scale *= 0.1;
      ++s;
      any = true;
    }
  }
  if (s < e) return false;  // exponent or junk: the caller tries strtod
  if (!any) return false;
  *out = neg ? -v : v;
  return true;
}

// Parse one CSV line; returns true and advances *p past the newline.
// Extracts columns cu, ci, cr as doubles; tolerates extra columns.
bool parse_line(const char** p, const char* end, int cu, int ci, int cr,
                double* u, double* i, double* r) {
  const char* s = *p;
  if (s >= end) return false;
  const char* line_end = static_cast<const char*>(
      memchr(s, '\n', static_cast<size_t>(end - s)));
  if (!line_end) line_end = end;

  int col = 0;
  int max_col = cu > ci ? cu : ci;
  if (cr > max_col) max_col = cr;
  bool got_u = false, got_i = false, got_r = false;
  const char* field = s;
  while (field <= line_end) {
    const char* comma = static_cast<const char*>(
        memchr(field, ',', static_cast<size_t>(line_end - field)));
    const char* fe = comma ? comma : line_end;
    if (col == cu || col == ci || col == cr) {
      double v;
      if (!parse_number(field, fe, &v)) {
        char buf[64];  // rare path: scientific notation etc.
        size_t len = static_cast<size_t>(fe - field);
        if (len >= sizeof(buf)) len = sizeof(buf) - 1;
        memcpy(buf, field, len);
        buf[len] = 0;
        char* endp = nullptr;
        v = strtod(buf, &endp);
        if (endp == buf || (endp && *endp != 0 && *endp != ' '
                            && *endp != '\r')) {
          *p = line_end < end ? line_end + 1 : end;
          return false;
        }
      }
      if (col == cu) { *u = v; got_u = true; }
      if (col == ci) { *i = v; got_i = true; }
      if (col == cr) { *r = v; got_r = true; }
    }
    if (col >= max_col) break;
    if (!comma) break;
    field = comma + 1;
    ++col;
  }
  *p = line_end < end ? line_end + 1 : end;
  return got_u && got_i && got_r;
}

// Open-addressing hash set/map on uint64 keys (bitcast doubles).
// `n` is only a size HINT: the table rehashes to 2x capacity whenever
// occupancy would cross load factor 1/2, so any number of distinct keys
// is safe (a column can be all-unique — n distinct ids).
struct FlatMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  size_t mask;
  size_t count = 0;
  static constexpr uint64_t kEmpty = 0xffffffffffffffffULL;

  explicit FlatMap(size_t n) {
    size_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    keys.assign(cap, kEmpty);
    vals.assign(cap, -1);
    mask = cap - 1;
  }
  static uint64_t mix(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
  }
  void grow() {
    size_t new_cap = (mask + 1) * 2;
    std::vector<uint64_t> nk(new_cap, kEmpty);
    std::vector<int32_t> nv(new_cap, -1);
    size_t nmask = new_cap - 1;
    for (size_t p = 0; p <= mask; ++p) {
      if (keys[p] == kEmpty) continue;
      size_t q = mix(keys[p]) & nmask;
      while (nk[q] != kEmpty) q = (q + 1) & nmask;
      nk[q] = keys[p];
      nv[q] = vals[p];
    }
    keys.swap(nk);
    vals.swap(nv);
    mask = nmask;
  }
  // returns existing value or inserts next_val; sets *inserted
  int32_t get_or_insert(uint64_t key, int32_t next_val, bool* inserted) {
    if ((count + 1) * 2 > mask + 1) grow();
    size_t pos = mix(key) & mask;
    for (;;) {
      if (keys[pos] == kEmpty) {
        keys[pos] = key;
        vals[pos] = next_val;
        ++count;
        *inserted = true;
        return next_val;
      }
      if (keys[pos] == key) {
        *inserted = false;
        return vals[pos];
      }
      pos = (pos + 1) & mask;
    }
  }
};

inline uint64_t dbits(double v) {
  uint64_t b;
  memcpy(&b, &v, sizeof(b));
  // normalize -0.0 and avoid the all-ones sentinel
  if (b == 0x8000000000000000ULL) b = 0;
  if (b == FlatMap::kEmpty) b = 0xfffffffffffffffeULL;
  return b;
}

}  // namespace

extern "C" {

// Count data rows (newlines, minus header). -1 on I/O error.
long long mf_count_rows(const char* data, long long size, int skip_header) {
  long long rows = 0;
  const char* p = data;
  const char* end = data + size;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    ++rows;
    if (!nl) break;
    p = nl + 1;
    if (p == end) break;  // trailing newline: no extra row
  }
  if (skip_header && rows > 0) --rows;
  return rows;
}

// Parse three numeric columns from an in-memory CSV buffer into caller
// arrays of capacity `cap`.  Returns rows parsed, or -(bad_line+1) when a
// non-numeric field is hit (the caller then reads the file with pandas).
long long mf_parse_numeric_csv(const char* data, long long size,
                               int skip_header, int cu, int ci, int cr,
                               long long cap, double* users, double* items,
                               float* ratings, int n_threads) {
  const char* begin = data;
  const char* end = data + size;
  if (skip_header) {
    const char* nl = static_cast<const char*>(
        memchr(begin, '\n', static_cast<size_t>(end - begin)));
    begin = nl ? nl + 1 : end;
  }
  if (n_threads < 1) n_threads = 1;
  std::vector<Range> ranges = split_ranges(begin, end, n_threads);

  // per-range row counts first (so each thread writes a disjoint slice)
  std::vector<long long> counts(ranges.size(), 0);
  {
    std::vector<std::thread> counters;
    for (size_t t = 0; t < ranges.size(); ++t) {
      counters.emplace_back([&, t]() {
        counts[t] = mf_count_rows(ranges[t].begin,
                                  ranges[t].end - ranges[t].begin, 0);
      });
    }
    for (auto& th : counters) th.join();
  }
  std::vector<long long> offsets(ranges.size() + 1, 0);
  for (size_t t = 0; t < ranges.size(); ++t)
    offsets[t + 1] = offsets[t] + counts[t];
  if (offsets.back() > cap) return -1;

  std::atomic<long long> bad{-1};
  std::vector<std::thread> threads;
  std::vector<long long> written(ranges.size(), 0);
  for (size_t t = 0; t < ranges.size(); ++t) {
    threads.emplace_back([&, t]() {
      const char* p = ranges[t].begin;
      long long w = offsets[t];
      while (p < ranges[t].end) {
        double u = 0.0, i = 0.0, r = 0.0;
        const char* line_start = p;
        if (!parse_line(&p, ranges[t].end, cu, ci, cr, &u, &i, &r)) {
          if (p == line_start) break;  // no progress: stop
          // skip blank/invalid lines silently unless it had content
          const char* q = line_start;
          bool blank = true;
          while (q < p && blank) {
            if (*q != '\n' && *q != '\r' && *q != ' ') blank = false;
            ++q;
          }
          if (!blank) { bad.store(w); return; }
          continue;
        }
        users[w] = u;
        items[w] = i;
        ratings[w] = static_cast<float>(r);
        ++w;
      }
      written[t] = w - offsets[t];
    });
  }
  for (auto& th : threads) th.join();
  if (bad.load() >= 0) return -(bad.load() + 1);

  // compact (ranges may have skipped blank lines)
  long long total = 0;
  for (size_t t = 0; t < ranges.size(); ++t) {
    if (total != offsets[t] && written[t] > 0) {
      memmove(users + total, users + offsets[t],
              sizeof(double) * static_cast<size_t>(written[t]));
      memmove(items + total, items + offsets[t],
              sizeof(double) * static_cast<size_t>(written[t]));
      memmove(ratings + total, ratings + offsets[t],
              sizeof(float) * static_cast<size_t>(written[t]));
    }
    total += written[t];
  }
  return total;
}

// Dense-encode values in FIRST-SEEN order (core.ids.IdVocab semantics).
// codes[cap n], uniques[cap n]; returns n_unique.
long long mf_dense_encode(const double* vals, long long n, int32_t* codes,
                          double* uniques) {
  FlatMap map(static_cast<size_t>(n) / 4 + 16);
  int32_t next = 0;
  bool inserted;
  for (long long k = 0; k < n; ++k) {
    int32_t code = map.get_or_insert(dbits(vals[k]), next, &inserted);
    if (inserted) {
      uniques[next] = vals[k];
      ++next;
    }
    codes[k] = code;
  }
  return next;
}

// Duplicate (user, item) pair detection. Returns index of the first
// duplicate row, or -1 if none.  Open addressing storing the actual pair
// (no hash-collision false positives).
long long mf_find_duplicate_pair(const double* users, const double* items,
                                 long long n) {
  size_t cap = 16;
  while (cap < static_cast<size_t>(n) * 2) cap <<= 1;
  std::vector<uint64_t> ku(cap, FlatMap::kEmpty);
  std::vector<uint64_t> ki(cap, 0);
  std::vector<uint8_t> used(cap, 0);
  size_t mask = cap - 1;
  for (long long k = 0; k < n; ++k) {
    uint64_t ub = dbits(users[k]);
    uint64_t ib = dbits(items[k]);
    size_t pos = (FlatMap::mix(ub) * 0x9e3779b97f4a7c15ULL
                  ^ FlatMap::mix(ib)) & mask;
    for (;;) {
      if (!used[pos]) {
        used[pos] = 1;
        ku[pos] = ub;
        ki[pos] = ib;
        break;
      }
      if (ku[pos] == ub && ki[pos] == ib) return k;
      pos = (pos + 1) & mask;
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// iALS grouped packing (ops/ials.py host side).
//
// The numpy path needs two stable argsorts plus several full-stream fancy
// gathers; these two functions replace all of it with O(n) passes and NO
// sorting — a stable
// counting layout preserves input order within each entity, so the packed
// bytes are identical to the argsort(kind='stable') layout.
// ---------------------------------------------------------------------------

// Per-entity occurrence counts. ids must be in [0, n_entities).
void mf_entity_counts(const int32_t* ids, long long n, int32_t n_entities,
                      int32_t* counts /* zeroed, n_entities */) {
  for (long long k = 0; k < n; ++k) ++counts[ids[k]];
}

// One pass over the raw entries, writing each into its (chunk, row, slot)
// cell.  Layout arrays are per entity (chunk_of/row_of) and per chunk
// (L_of_chunk, chunk_base into the flat pools).  fill must be zeroed.
void mf_pack_grouped(const int32_t* ids, const int32_t* other, const float* r,
                     long long n, const int32_t* chunk_of,
                     const int32_t* row_of, const int32_t* L_of_chunk,
                     const long long* chunk_base, int32_t* oi_pool,
                     float* rr_pool, float* mm_pool,
                     int32_t* fill /* zeroed, n_entities */) {
  for (long long k = 0; k < n; ++k) {
    const int32_t e = ids[k];
    const int32_t c = chunk_of[e];
    const long long L = L_of_chunk[c];
    const long long slot =
        chunk_base[c] + static_cast<long long>(row_of[e]) * L + fill[e]++;
    oi_pool[slot] = other[k];
    rr_pool[slot] = r[k];
    mm_pool[slot] = 1.0f;
  }
}

// ---------------------------------------------------------------------------
// SGD batch packing (ops/segment_sgd.py::pack_ratings host side).
//
// pack_ratings sorts each whole-batch chunk, then each batch, by an id
// key with numpy stable argsort + 4x take_along_axis.  Ids are dense (< a few hundred
// thousand), so a stable COUNTING sort per range is O(len + K), runs
// threaded across ranges (ranges are independent by construction:
// chunk bounds and batch bounds never straddle), and reproduces
// np.argsort(kind='stable') byte-for-byte.
// ---------------------------------------------------------------------------

// Stable counting-sort of [starts[j], ends[j]) ranges by key (0 = user
// column, 1 = item column), applied in place to all four columns.
void mf_sort_ranges(int32_t* u, int32_t* i, float* r, float* w,
                    const long long* starts, const long long* ends,
                    int n_ranges, int key_is_item, int32_t n_keys,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_ranges) n_threads = n_ranges;
  std::atomic<int> next_range{0};
  auto worker = [&]() {
    std::vector<int32_t> offs;
    std::vector<int32_t> su, si;
    std::vector<float> sr, sw;
    for (;;) {
      const int j = next_range.fetch_add(1);
      if (j >= n_ranges) return;
      const long long lo = starts[j], hi = ends[j];
      const long long len = hi - lo;
      if (len <= 1) continue;
      const int32_t* key = (key_is_item ? i : u) + lo;
      offs.assign(static_cast<size_t>(n_keys) + 1, 0);
      for (long long k = 0; k < len; ++k) ++offs[key[k] + 1];
      for (int32_t b = 0; b < n_keys; ++b) offs[b + 1] += offs[b];
      su.resize(len); si.resize(len); sr.resize(len); sw.resize(len);
      for (long long k = 0; k < len; ++k) {
        const int32_t pos = offs[key[k]]++;
        su[pos] = u[lo + k];
        si[pos] = i[lo + k];
        sr[pos] = r[lo + k];
        sw[pos] = w[lo + k];
      }
      memcpy(u + lo, su.data(), sizeof(int32_t) * len);
      memcpy(i + lo, si.data(), sizeof(int32_t) * len);
      memcpy(r + lo, sr.data(), sizeof(float) * len);
      memcpy(w + lo, sw.data(), sizeof(float) * len);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Stable counting ARGsort per range: perm_out gets range-relative
// positions (the np.argsort(kind='stable') permutation), sorted_out the
// keys in sorted order.
void mf_argsort_ranges(const int32_t* keys, const long long* starts,
                       const long long* ends, int n_ranges, int32_t n_keys,
                       int32_t* perm_out, int32_t* sorted_out,
                       int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_ranges) n_threads = n_ranges;
  std::atomic<int> next_range{0};
  auto worker = [&]() {
    std::vector<int32_t> offs;
    for (;;) {
      const int j = next_range.fetch_add(1);
      if (j >= n_ranges) return;
      const long long lo = starts[j], hi = ends[j];
      const long long len = hi - lo;
      offs.assign(static_cast<size_t>(n_keys) + 1, 0);
      const int32_t* key = keys + lo;
      for (long long k = 0; k < len; ++k) ++offs[key[k] + 1];
      for (int32_t b = 0; b < n_keys; ++b) offs[b + 1] += offs[b];
      for (long long k = 0; k < len; ++k) {
        const int32_t pos = offs[key[k]]++;
        perm_out[lo + pos] = static_cast<int32_t>(k);
        sorted_out[lo + pos] = key[k];
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// Shuffle application for pack_ratings: gather the three rating columns
// through the epoch permutation in one threaded pass, writing straight
// into the caller's padded buffers (replaces three numpy fancy-index
// copies plus three astype+concatenate copies).
void mf_gather_rows(const int32_t* u, const int32_t* i, const float* r,
                    const int64_t* perm, long long n, int32_t* ou,
                    int32_t* oi, float* orr, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  const long long per = (n + n_threads - 1) / n_threads;
  auto worker = [&](long long lo, long long hi) {
    for (long long k = lo; k < hi; ++k) {
      const int64_t p = perm[k];
      ou[k] = u[p];
      oi[k] = i[p];
      orr[k] = r[p];
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) {
    const long long lo = t * per;
    if (lo >= n) break;
    threads.emplace_back(worker, lo, std::min(n, lo + per));
  }
  worker(0, std::min(n, per));
  for (auto& th : threads) th.join();
}

// Stable counting sort of (other, r) pairs by a dense key — the CF
// sparse-gram stream build (ops/sparse_gram.py) needs the counterpart
// ids and ratings in entity-sorted order; the sorted keys themselves are
// rebuilt from per-entity counts.  Identical to
// other[argsort(key, kind='stable')].
void mf_sort_pairs_by_key(const int32_t* key, const int32_t* other,
                          const float* r, long long n, int32_t n_keys,
                          int32_t* other_out, float* r_out) {
  std::vector<int32_t> offs(static_cast<size_t>(n_keys) + 1, 0);
  for (long long k = 0; k < n; ++k) ++offs[key[k] + 1];
  for (int32_t b = 0; b < n_keys; ++b) offs[b + 1] += offs[b];
  for (long long k = 0; k < n; ++k) {
    const int32_t pos = offs[key[k]]++;
    other_out[pos] = other[k];
    r_out[pos] = r[k];
  }
}

// Stable counting sort of (a, b, r) triples by a dense key — the block
// order of pack_ratings sorts the stream by item, then by (user block,
// item block) cell.
void mf_sort_triple_by_key(const int32_t* key, const int32_t* a,
                           const int32_t* b, const float* r, long long n,
                           int32_t n_keys, int32_t* a_out, int32_t* b_out,
                           float* r_out) {
  std::vector<int32_t> offs(static_cast<size_t>(n_keys) + 1, 0);
  for (long long k = 0; k < n; ++k) ++offs[key[k] + 1];
  for (int32_t c = 0; c < n_keys; ++c) offs[c + 1] += offs[c];
  for (long long k = 0; k < n; ++k) {
    const int32_t pos = offs[key[k]]++;
    a_out[pos] = a[k];
    b_out[pos] = b[k];
    r_out[pos] = r[k];
  }
}

// Two-key stable sort (primary asc, then secondary asc) emitting the
// secondary ids and ratings in final order — reproduces
// np.lexsort((sec, prim)) applied to (sec, r).  Radix: one stable
// counting pass by sec, then one by prim.  The CF top-k CSR build
// (models/cf_topk.py) needs per-row candidate ids ascending for its
// device binary search.
void mf_lexsort_pair(const int32_t* prim, const int32_t* sec,
                     const float* r, long long n, int32_t n_prim,
                     int32_t n_sec, int32_t* sec_out, float* r_out) {
  std::vector<int32_t> prim_t(n);
  std::vector<int32_t> sec_t(n);
  std::vector<float> r_t(n);
  {
    std::vector<int32_t> offs(static_cast<size_t>(n_sec) + 1, 0);
    for (long long k = 0; k < n; ++k) ++offs[sec[k] + 1];
    for (int32_t b = 0; b < n_sec; ++b) offs[b + 1] += offs[b];
    for (long long k = 0; k < n; ++k) {
      const int32_t pos = offs[sec[k]]++;
      prim_t[pos] = prim[k];
      sec_t[pos] = sec[k];
      r_t[pos] = r[k];
    }
  }
  {
    std::vector<int32_t> offs(static_cast<size_t>(n_prim) + 1, 0);
    for (long long k = 0; k < n; ++k) ++offs[prim_t[k] + 1];
    for (int32_t b = 0; b < n_prim; ++b) offs[b + 1] += offs[b];
    for (long long k = 0; k < n; ++k) {
      const int32_t pos = offs[prim_t[k]]++;
      sec_out[pos] = sec_t[k];
      r_out[pos] = r_t[k];
    }
  }
}

}  // extern "C"

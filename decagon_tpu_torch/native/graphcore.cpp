// Native host runtime for decagon_tpu_torch: the host-side hot loops of
// graph construction, CSV edge parsing and rejection-sampled negative
// edges.  The port's copy of decagon_tpu/native/graphcore.cpp with its two
// entry points that the port calls, unchanged; the degree normalization
// and the Pallas edge tiling are left out (the port normalizes in numpy
// and K6 reads a CSR, decagon_tpu_torch/ops/tiling.py).
//
// The reference implementation had no native code (SURVEY.md §2.9); its
// host loops were O(E)-per-sample Python scans (e.g. the `_ismember`
// rejection sampler at decagon/deep/minibatch.py:95-99,190-216).  These
// are the C++ equivalents, exposed through a plain C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC graphcore.cpp -o libgraphcore.so

#include <cstddef>
#include <cstdint>
#include <unordered_set>

namespace {
// splitmix64: deterministic, seedable, fast.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // Unbiased bounded draw (Lemire).
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = -n % n;
      while (l < t) {
        x = next();
        m = (__uint128_t)x * n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// Rejection-sampled false edges.
// Returns the number of edges written (== count on success).
int64_t dt_sample_false_edges(
    const int64_t* pos_rows, const int64_t* pos_cols, int64_t n_pos,
    int64_t n_rows, int64_t n_cols, int64_t count, uint64_t seed,
    int64_t* out_rows, int64_t* out_cols) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  std::unordered_set<uint64_t> forbidden;
  forbidden.reserve(static_cast<size_t>(n_pos) * 2 + 16);
  const uint64_t ncols = static_cast<uint64_t>(n_cols);
  for (int64_t i = 0; i < n_pos; ++i) {
    forbidden.insert(static_cast<uint64_t>(pos_rows[i]) * ncols +
                     static_cast<uint64_t>(pos_cols[i]));
  }
  const __uint128_t total_cells =
      (__uint128_t)n_rows * (__uint128_t)n_cols;
  if (total_cells - forbidden.size() < (__uint128_t)count) return -1;

  Rng rng(seed);
  int64_t filled = 0;
  while (filled < count) {
    const uint64_t r = rng.bounded(static_cast<uint64_t>(n_rows));
    const uint64_t c = rng.bounded(ncols);
    const uint64_t key = r * ncols + c;
    if (forbidden.count(key)) continue;
    forbidden.insert(key);  // also dedups sampled negatives
    out_rows[filled] = static_cast<int64_t>(r);
    out_cols[filled] = static_cast<int64_t>(c);
    ++filled;
  }
  return filled;
}

// ---------------------------------------------------------------------
// CSV edge parsing: STITCH-style rows "CID000X,CID000Y,C000Z,...".
// Extracts up to 3 integer fields per line (non-digits stripped per
// field, matching the NodeIds codec).  Returns number of rows parsed;
// lines whose first field has no digits (headers) are skipped.
int64_t dt_parse_edge_csv(
    const char* data, int64_t length, int64_t n_fields,
    int64_t* out_a, int64_t* out_b, int64_t* out_c, int64_t max_rows) {
  int64_t row = 0;
  int64_t i = 0;
  while (i < length && row < max_rows) {
    int64_t fields[3] = {-1, -1, -1};
    bool field_ok[3] = {false, false, false};
    int field = 0;
    uint64_t acc = 0;
    bool any_digit = false;
    bool clean = true;  // header fields contain spaces ("STITCH 1")
    for (; i < length; ++i) {
      const char ch = data[i];
      if (ch == '\n' || ch == '\r') {
        break;
      }
      if (ch == ',') {
        if (field < 3) {
          fields[field] = static_cast<int64_t>(acc);
          field_ok[field] = any_digit && clean;
        }
        ++field;
        acc = 0;
        any_digit = false;
        clean = true;
        continue;
      }
      if (field < 3) {
        if (ch >= '0' && ch <= '9') {
          acc = acc * 10 + static_cast<uint64_t>(ch - '0');
          any_digit = true;
        } else if (!((ch >= 'A' && ch <= 'Z') || (ch >= 'a' && ch <= 'z'))) {
          clean = false;  // spaces/punct mark a header/label field
        }
      }
    }
    if (field < 3) {
      fields[field] = static_cast<int64_t>(acc);
      field_ok[field] = any_digit && clean;
    }
    // Skip EOL characters.
    while (i < length && (data[i] == '\n' || data[i] == '\r')) ++i;

    const int needed = static_cast<int>(n_fields);
    bool valid = true;
    for (int f = 0; f < needed; ++f) valid = valid && field_ok[f];
    if (valid) {
      out_a[row] = fields[0];
      out_b[row] = fields[1];
      if (needed > 2 && out_c) out_c[row] = fields[2];
      ++row;
    }
  }
  return row;
}

}  // extern "C"

// First-party native kernel: batched Levenshtein edit distance.
//
// The text-domain host path (WER/CER/MER/WIL/WIP/EditDistance/TER) reduces
// every sequence pair to an edit distance before anything touches the device.
// The reference leans on Python DP loops (functional/text/helper.py); this
// kernel runs the same two-row DP in C++ over a whole batch of tokenized
// (id-mapped) sequence pairs in one call.
//
// Build: g++ -O3 -shared -fPIC edit_distance.cpp -o libtm_edit.so
// ABI: plain C, driven through ctypes (no pybind11 in this environment).

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Single pair: Levenshtein distance between a[0..n) and b[0..m).
int64_t tm_levenshtein(const int64_t* a, int64_t n, const int64_t* b, int64_t m,
                       int64_t substitution_cost) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int64_t ai = a[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t sub = prev[j - 1] + (ai != b[j - 1] ? substitution_cost : 0);
      cur[j] = std::min({sub, prev[j] + 1, cur[j - 1] + 1});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Batch: flattened sequences with exclusive prefix offsets (len batch+1 each).
// out[k] = distance(a[ao[k]:ao[k+1]], b[bo[k]:bo[k+1]]).
void tm_levenshtein_batch(const int64_t* a_flat, const int64_t* a_offsets,
                          const int64_t* b_flat, const int64_t* b_offsets,
                          int64_t batch, int64_t substitution_cost,
                          int64_t* out) {
  for (int64_t k = 0; k < batch; ++k) {
    out[k] = tm_levenshtein(a_flat + a_offsets[k], a_offsets[k + 1] - a_offsets[k],
                            b_flat + b_offsets[k], b_offsets[k + 1] - b_offsets[k],
                            substitution_cost);
  }
}

// Length of the longest common subsequence of a[0..n) and b[0..m).
// Two-row DP, same layout as tm_levenshtein; serves the ROUGE-L host path
// (reference rouge.py:95-115 runs this table as a Python double loop).
int64_t tm_lcs(const int64_t* a, int64_t n, const int64_t* b, int64_t m) {
  if (n == 0 || m == 0) return 0;
  std::vector<int64_t> prev(m + 1, 0), cur(m + 1, 0);
  for (int64_t i = 1; i <= n; ++i) {
    const int64_t ai = a[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      cur[j] = (ai == b[j - 1]) ? prev[j - 1] + 1 : std::max(prev[j], cur[j - 1]);
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Batch variant, same flattened offsets convention as tm_levenshtein_batch.
void tm_lcs_batch(const int64_t* a_flat, const int64_t* a_offsets,
                  const int64_t* b_flat, const int64_t* b_offsets,
                  int64_t batch, int64_t* out) {
  for (int64_t k = 0; k < batch; ++k) {
    out[k] = tm_lcs(a_flat + a_offsets[k], a_offsets[k + 1] - a_offsets[k],
                    b_flat + b_offsets[k], b_offsets[k + 1] - b_offsets[k]);
  }
}

// ROUGE-N clipped n-gram overlap: hits = sum over distinct n-grams of
// min(count_in_a, count_in_b) (reference rouge.py:202-225 builds two Python
// Counters of token tuples per pair). Sort-and-merge over n-gram start
// positions: O((|a|+|b|) log) per pair, no hashing, no allocation per n-gram.
// a_cnt/b_cnt receive the n-gram totals (len - n + 1, clamped at 0) so the
// caller can form precision/recall without re-touching the tokens.
void tm_ngram_hits_batch(const int64_t* a_flat, const int64_t* a_offsets,
                         const int64_t* b_flat, const int64_t* b_offsets,
                         int64_t batch, int64_t n,
                         int64_t* hits, int64_t* a_cnt, int64_t* b_cnt) {
  std::vector<int64_t> ia, ib;
  for (int64_t k = 0; k < batch; ++k) {
    const int64_t* a = a_flat + a_offsets[k];
    const int64_t* b = b_flat + b_offsets[k];
    const int64_t la = a_offsets[k + 1] - a_offsets[k];
    const int64_t lb = b_offsets[k + 1] - b_offsets[k];
    const int64_t na = la - n + 1 > 0 ? la - n + 1 : 0;
    const int64_t nb = lb - n + 1 > 0 ? lb - n + 1 : 0;
    a_cnt[k] = na;
    b_cnt[k] = nb;
    if (na == 0 || nb == 0) {
      hits[k] = 0;
      continue;
    }
    ia.resize(na);
    ib.resize(nb);
    for (int64_t i = 0; i < na; ++i) ia[i] = i;
    for (int64_t i = 0; i < nb; ++i) ib[i] = i;
    auto lex_less = [n](const int64_t* base) {
      return [base, n](int64_t x, int64_t y) {
        return std::lexicographical_compare(base + x, base + x + n, base + y, base + y + n);
      };
    };
    std::sort(ia.begin(), ia.end(), lex_less(a));
    std::sort(ib.begin(), ib.end(), lex_less(b));
    auto cmp3 = [n](const int64_t* x, const int64_t* y) -> int {
      for (int64_t t = 0; t < n; ++t) {
        if (x[t] < y[t]) return -1;
        if (x[t] > y[t]) return 1;
      }
      return 0;
    };
    int64_t i = 0, j = 0, h = 0;
    while (i < na && j < nb) {
      const int c = cmp3(a + ia[i], b + ib[j]);
      if (c < 0) {
        ++i;
      } else if (c > 0) {
        ++j;
      } else {
        int64_t ri = i + 1, rj = j + 1;
        while (ri < na && cmp3(a + ia[ri], a + ia[i]) == 0) ++ri;
        while (rj < nb && cmp3(b + ib[rj], b + ib[j]) == 0) ++rj;
        h += std::min(ri - i, rj - j);
        i = ri;
        j = rj;
      }
    }
    hits[k] = h;
  }
}

}  // extern "C"

// hgtpu native runtime pieces.
//
// The reference's native layer is the HISAT2 C++ engine (graph FM index;
// SURVEY.md components #1-#4).  hgtpu keeps alignment math on the device, but
// the host-side index construction and IO run natively:
//   - SA-IS suffix array construction (linear time) + BWT derivation for
//     the FM index (hgtpu/ops/fm.py consumes these arrays)
//   - a FASTQ/FASTA scanner that returns record offsets for zero-copy
//     Python-side slicing
//
// C ABI only; bound via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SA-IS (Nong, Zhang & Chan, 2009) over an int32 alphabet.
// s has length n and must end with a unique smallest sentinel (0).
// ---------------------------------------------------------------------------
void sais(const int32_t* s, int32_t* sa, int64_t n, int32_t K) {
  std::vector<uint8_t> t(n);  // 1 = S-type
  t[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;

  auto is_lms = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<int64_t> bkt(K + 1);
  auto get_buckets = [&](bool end) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int64_t i = 0; i < n; ++i) bkt[s[i]]++;
    int64_t sum = 0;
    for (int32_t i = 0; i <= K; ++i) {
      sum += bkt[i];
      bkt[i] = end ? sum : sum - bkt[i];
    }
  };

  auto induce = [&]() {
    get_buckets(false);
    for (int64_t i = 0; i < n; ++i) {
      int64_t j = sa[i] - 1;
      if (sa[i] > 0 && j >= 0 && !t[j]) sa[bkt[s[j]]++] = j;
    }
    get_buckets(true);
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t j = sa[i] - 1;
      if (sa[i] > 0 && j >= 0 && t[j]) sa[--bkt[s[j]]] = j;
    }
  };

  // place LMS suffixes
  std::fill(sa, sa + n, -1);
  get_buckets(true);
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce();

  // compact sorted LMS substrings
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n1++] = sa[i];
  std::fill(sa + n1, sa + n, -1);

  // name LMS substrings
  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = sa[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          if (!(is_lms(pos + d) && is_lms(prev + d))) diff = true;
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  int64_t j = n - 1;
  for (int64_t i = n - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // recurse if names are not unique
  int32_t* s1 = sa + n - n1;
  if (name < n1) {
    sais(s1, sa, n1, (int32_t)(name - 1));
  } else {
    for (int64_t i = 0; i < n1; ++i) sa[s1[i]] = (int32_t)i;
  }

  // map back: sa[0..n1) = LMS positions in sorted order
  {
    int64_t j2 = 0;
    for (int64_t i = 1; i < n; ++i)
      if (is_lms(i)) s1[j2++] = (int32_t)i;  // text-order LMS into s1
  }
  for (int64_t i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
  std::fill(sa + n1, sa + n, -1);
  get_buckets(true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t p = sa[i];
    sa[i] = -1;
    sa[--bkt[s[p]]] = (int32_t)p;
  }
  induce();
}

}  // namespace

extern "C" {

// Build SA over int8 codes (0..3 bases, 4=N); appends the sentinel
// internally.  sa_out must hold n+1 entries; returns n+1.
int64_t hgtpu_build_sa(const int8_t* seq, int64_t n, int32_t* sa_out) {
  std::vector<int32_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = (int32_t)seq[i] + 1;
  s[n] = 0;
  sais(s.data(), sa_out, n + 1, 5);
  return n + 1;
}

// BWT from SA: bwt[i] = seq[sa[i]-1], with code 5 standing for the
// sentinel position.
void hgtpu_bwt_from_sa(const int8_t* seq, const int32_t* sa, int64_t n1,
                       int8_t* bwt_out) {
  for (int64_t i = 0; i < n1; ++i) {
    int32_t p = sa[i];
    bwt_out[i] = (p == 0) ? (int8_t)5 : seq[p - 1];
  }
}

// Scan FASTQ/FASTA text (already in memory): writes (name_off, name_len,
// seq_off, seq_len) per record; returns record count (capped at max_recs).
int64_t hgtpu_scan_fastx(const char* buf, int64_t n, int64_t* offsets,
                         int64_t max_recs) {
  int64_t count = 0;
  int64_t i = 0;
  if (n == 0) return 0;
  char mode = buf[0];
  while (i < n && count < max_recs) {
    if (buf[i] != mode) {  // skip malformed gaps
      ++i;
      continue;
    }
    int64_t name_off = i + 1;
    while (i < n && buf[i] != '\n') ++i;
    int64_t name_len = i - name_off;
    for (int64_t k = name_off; k < name_off + name_len; ++k) {
      if (buf[k] == ' ' || buf[k] == '\t') {
        name_len = k - name_off;
        break;
      }
    }
    ++i;
    int64_t seq_off = i;
    if (mode == '@') {
      while (i < n && buf[i] != '\n') ++i;
      int64_t seq_len = i - seq_off;
      ++i;                                   // newline
      while (i < n && buf[i] != '\n') ++i;   // '+' line
      ++i;
      while (i < n && buf[i] != '\n') ++i;   // qual line
      ++i;
      offsets[count * 4 + 0] = name_off;
      offsets[count * 4 + 1] = name_len;
      offsets[count * 4 + 2] = seq_off;
      offsets[count * 4 + 3] = seq_len;
      ++count;
    } else {  // FASTA: sequence may span lines; record contiguous length
      int64_t seq_len = 0;
      while (i < n && buf[i] != mode) {
        if (buf[i] != '\n') ++seq_len;
        ++i;
      }
      offsets[count * 4 + 0] = name_off;
      offsets[count * 4 + 1] = name_len;
      offsets[count * 4 + 2] = seq_off;
      offsets[count * 4 + 3] = seq_len;
      ++count;
    }
  }
  return count;
}

}  // extern "C"

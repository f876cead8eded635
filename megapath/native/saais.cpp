// SA-IS suffix array construction (linear time, induced sorting).
//
// Native replacement for the reference's QSufSort-based index builder
// (/root/reference/soap4/2bwt-lib/QSufSort.c) on the offline path: the
// numpy prefix-doubling builder in megapath.index.suffix is
// O(n log^2 n) at Gbp scale; this is the classic SA-IS algorithm
// (Nong, Zhang & Chan 2009) implemented from scratch with 64-bit
// positions, using an explicit unique sentinel internally.
//
// C ABI:
//   int saais_u8(const uint8_t* text, int64_t n, int64_t* sa)
//     Fills sa[0..n) with the suffix array of text (sentinel-free
//     convention: suffixes of text only). Returns 0 on success.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;

// Generic SA-IS over text[0..n) whose LAST character is the unique
// smallest (the sentinel). sa has length n.
template <typename T>
void sais(const T* text, i64 n, i64 k, i64* sa) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> stype(n);
  stype[n - 1] = true;
  for (i64 i = n - 2; i >= 0; --i)
    stype[i] =
        text[i] < text[i + 1] || (text[i] == text[i + 1] && stype[i + 1]);

  auto is_lms = [&](i64 i) { return i > 0 && stype[i] && !stype[i - 1]; };

  std::vector<i64> counts(k, 0), buckets(k);
  for (i64 i = 0; i < n; ++i) counts[text[i]]++;

  auto bucket_bounds = [&](bool end) {
    i64 sum = 0;
    for (i64 c = 0; c < k; ++c) {
      sum += counts[c];
      buckets[c] = end ? sum : sum - counts[c];
    }
  };

  auto induce = [&]() {
    // L-type left to right
    bucket_bounds(false);
    for (i64 i = 0; i < n; ++i) {
      i64 j = sa[i] - 1;
      if (sa[i] > 0 && !stype[j]) sa[buckets[text[j]]++] = j;
    }
    // S-type right to left
    bucket_bounds(true);
    for (i64 i = n - 1; i >= 0; --i) {
      i64 j = sa[i] - 1;
      if (sa[i] > 0 && stype[j]) sa[--buckets[text[j]]] = j;
    }
  };

  // step 1: LMS suffixes at bucket ends, first induction
  std::fill(sa, sa + n, i64(-1));
  bucket_bounds(true);
  for (i64 i = 1; i < n; ++i)
    if (is_lms(i)) sa[--buckets[text[i]]] = i;
  induce();

  // step 2: name sorted LMS substrings
  i64 n_lms = 0;
  for (i64 i = 0; i < n; ++i)
    if (is_lms(sa[i])) sa[n_lms++] = sa[i];
  i64* names = sa + n_lms;  // scratch: indices pos/2 < n - n_lms
  std::fill(names, sa + n, i64(-1));

  i64 name = 0, prev = -1;
  for (i64 r = 0; r < n_lms; ++r) {
    i64 pos = sa[r];
    bool diff = (prev < 0);
    if (!diff) {
      for (i64 d = 0;; ++d) {
        if (text[pos + d] != text[prev + d] ||
            stype[pos + d] != stype[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          diff = !(is_lms(pos + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    names[pos / 2] = name - 1;
  }

  // gather (lms position, name) in text order
  std::vector<i64> lms_pos;
  lms_pos.reserve(n_lms);
  for (i64 i = 1; i < n; ++i)
    if (is_lms(i)) lms_pos.push_back(i);
  std::vector<i64> sub(n_lms);
  for (i64 i = 0; i < n_lms; ++i) sub[i] = names[lms_pos[i] / 2];

  std::vector<i64> lms_sorted(n_lms);
  if (name < n_lms) {
    std::vector<i64> sub_sa(n_lms);
    sais<i64>(sub.data(), n_lms, name, sub_sa.data());
    for (i64 i = 0; i < n_lms; ++i) lms_sorted[i] = lms_pos[sub_sa[i]];
  } else {
    for (i64 i = 0; i < n_lms; ++i) lms_sorted[sub[i]] = lms_pos[i];
  }

  // step 3: place sorted LMS, final induction
  std::fill(sa, sa + n, i64(-1));
  bucket_bounds(true);
  for (i64 r = n_lms - 1; r >= 0; --r) {
    i64 p = lms_sorted[r];
    sa[--buckets[text[p]]] = p;
  }
  induce();
}

}  // namespace

extern "C" {

// Suffix array of text (values < 255) WITHOUT sentinel rows: appends a
// unique 0-sentinel internally (values shifted +1) and drops its row.
int saais_u8(const uint8_t* text, int64_t n, int64_t* sa) {
  if (n <= 0) return 0;
  std::vector<uint8_t> T(n + 1);
  for (i64 i = 0; i < n; ++i) T[i] = text[i] + 1;
  T[n] = 0;
  std::vector<i64> sa2(n + 1);
  sais<uint8_t>(T.data(), n + 1, 256, sa2.data());
  // row 0 is the sentinel suffix; drop it
  std::memcpy(sa, sa2.data() + 1, sizeof(i64) * n);
  return 0;
}
}

// Native scan kernels for the bbduk preprocessing stage.
//
// These are the two per-position sequential scans that dominate the
// host preprocessing cost (the batched numpy forms pay ~14 array ops
// per read position): the sliding-window entropy measure
// (BBDuk2.averageEntropy, /root/reference/bbmap/current/jgi/
// BBDuk2.java:3161-3264) and the optimal quality trim
// (TrimRead.testOptimal). Arithmetic order matches
// megapath/filters/bbduk.py bit-for-bit (double accumulation per
// read in step order; float32 Kadane), so the Java-oracle byte goldens
// hold on either path.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Average sliding-window entropy per read.
//   codes: B*L 2-bit codes (N already mapped to 0)
//   lens:  per-read lengths
//   out:   B doubles
void bbduk_entropy(const uint8_t* codes, const int32_t* lens, int64_t B,
                   int32_t L, int32_t k, int32_t window, double* out) {
  const int kspace = 1 << (2 * k);
  const uint32_t mask = (uint32_t)(kspace - 1);
  std::vector<double> de((size_t)window + 2, 0.0);
  {
    std::vector<double> e((size_t)window + 2, 0.0);
    for (int c = 1; c < window + 2; ++c) {
      double v = (double)c / (double)window;
      e[c] = v * std::log(v);
    }
    for (int i = 0; i < window + 1; ++i) de[i] = e[i + 1] - e[i];
  }
  const double mult = -1.0 / std::log((double)window);

  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;

  auto work = [&](int64_t b0, int64_t b1) {
    std::vector<int16_t> counts((size_t)kspace);
    for (int64_t b = b0; b < b1; ++b) {
      std::memset(counts.data(), 0, (size_t)kspace * sizeof(int16_t));
      const uint8_t* row = codes + b * L;
      const int32_t len = lens[b];
      double S = 0.0, esum = 0.0;
      int64_t nmeas = 0;
      uint32_t kadd = 0, krem = 0;
      const int total = L + window;
      for (int i = 0; i < total; ++i) {
        const int i2 = i - window;
        if (i < L) {
          kadd = ((kadd << 2) | row[i]) & mask;
          const int16_t c_old = counts[kadd];
          if (i < len) {
            S += de[c_old];
            counts[kadd] = (int16_t)(c_old + 1);
          }
        }
        if (i2 >= 0) {
          krem = ((krem << 2) | row[i2]) & mask;
          const int16_t c_old = counts[krem];
          if (i2 < len && c_old > 0) {
            S -= de[c_old - 1];
            counts[krem] = (int16_t)(c_old - 1);
          }
        }
        if (i2 >= -1 && i < len) {
          esum += S * mult;
          ++nmeas;
        }
      }
      out[b] = nmeas > 0 ? esum / (double)nmeas : 0.0;
    }
  };

  if (nthreads == 1 || B < 256) {
    work(0, B);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(B, b0 + chunk);
    if (b0 >= b1) break;
    ts.emplace_back(work, b0, b1);
  }
  for (auto& t : ts) t.join();
}

// Optimal-mode quality trim (Kadane over error-probability deltas).
//   quals: B*L phred values (int16, may be negative on malformed input)
//   is_n:  B*L 0/1 flags
//   prob_error: 127-entry float32 table (PROB_ERROR)
// Outputs per-read kept [start, stop).
void bbduk_qtrim(const int16_t* quals, const uint8_t* is_n,
                 const int32_t* lens, int64_t B, int32_t L,
                 const float* prob_error, double avg_err, double nprob,
                 int32_t* start_out, int32_t* stop_out) {
  int nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 8) nthreads = 8;

  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const int16_t* q = quals + b * L;
      const uint8_t* nn = is_n + b * L;
      const int32_t len = lens[b] < L ? lens[b] : L;
      float score = 0.0f, max_score = 0.0f;
      int32_t count = 0, max_count = -1, max_loc = -1;
      for (int i = 0; i < len; ++i) {
        int qi = q[i];
        if (qi < 0) qi = 0;
        if (qi > 126) qi = 126;
        const double prob = nn[i] ? nprob : (double)prob_error[qi];
        score += (float)(avg_err - prob);
        const bool pos = score > 0.0f;
        if (pos)
          ++count;
        else
          count = 0;
        if (pos && (score > max_score ||
                    (score == max_score && count > max_count))) {
          max_score = score;
          max_count = count;
          max_loc = i;
        }
        if (!pos) score = 0.0f;
      }
      if (max_score > 0.0f) {
        start_out[b] = max_loc - max_count + 1;
        stop_out[b] = max_loc + 1;
      } else {
        start_out[b] = 0;
        stop_out[b] = 0;
      }
    }
  };

  if (nthreads == 1 || B < 256) {
    work(0, B);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t chunk = (B + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t b0 = t * chunk;
    const int64_t b1 = std::min(B, b0 + chunk);
    if (b0 >= b1) break;
    ts.emplace_back(work, b0, b1);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"

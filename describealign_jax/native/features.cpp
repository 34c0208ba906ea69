// Native host feature extractor for describealign-jax.
//
// Computes the reference's 5 feature streams at 210 fps (semantics of
// describealign.py:545-593: smoothed log energy, zero-crossing rate, 3
// cascaded frequency-band log energies) directly from int16 PCM on the
// host CPU. This is the default feature path: the 210fps feature matrices
// are ~40x smaller than the raw PCM, so the host uploads ~12 MB of f32
// features instead of ~250 MB of PCM.
//
// Numerics: PCM values are first rounded to the float16 grid (the
// reference stores PCM as float16), then all accumulation is float32,
// mirroring the numpy/JAX implementations within normal f32 tolerance.
// Plain loops + -O3 -march=native: every hot loop is contiguous and
// auto-vectorizes.

#include <cstdint>
#include <cstring>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <locale.h>
#include <memory>
#include <mutex>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__F16C__)
#include <immintrin.h>
#define DA_AVX512 1
#endif

namespace {

// round-to-nearest-even float32 -> float16 -> float32 (portable bit math)
inline float f16_grid(float x) {
  uint32_t bits;
  std::memcpy(&bits, &x, 4);
  uint32_t sign = bits & 0x80000000u;
  uint32_t absb = bits & 0x7fffffffu;
  float out;
  if (absb >= 0x47800000u) {                       // overflow -> inf (or nan)
    uint32_t res = (absb > 0x7f800000u) ? (absb | 0x400000u)  // keep nan
                                        : 0x7f800000u;
    res |= sign;
    std::memcpy(&out, &res, 4);
    return out;
  }
  if (absb < 0x38800000u) {                        // subnormal f16 range
    // scale into integer units of 2^-24 and round to nearest even
    float a = std::fabs(x) * 16777216.0f;          // 2^24
    float ri = std::nearbyintf(a);                 // nearest, ties to even
    out = ri / 16777216.0f;
    return sign ? -out : out;
  }
  // normal range: keep 10 mantissa bits, round to nearest even
  uint32_t mant_shift = 13;
  uint32_t lsb = 1u << mant_shift;
  uint32_t rounded = absb + ((lsb >> 1) - 1) + ((absb >> mant_shift) & 1);
  rounded &= ~(lsb - 1);
  rounded |= sign;
  std::memcpy(&out, &rounded, 4);
  return out;
}

// scipy.signal.windows.hann(n+2)[1:-1], normalized to sum 1 (f32 like the
// reference's hann_taps); cosine computed in double like scipy.
std::vector<float> hann_taps(int n_plus_2) {
  int n = n_plus_2 - 2;
  std::vector<float> w(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) {
    double v = 0.5 - 0.5 * std::cos(2.0 * M_PI * (i + 1) / (n_plus_2 - 1));
    w[static_cast<size_t>(i)] = static_cast<float>(v);
  }
  float s = 0.f;
  for (float v : w) s += v;
  for (float& v : w) v /= s;
  return w;
}

// int16 -> f16-grid f32 lookup (exact round-to-nearest-even), shared by
// the scalar paths; thread-safe via C++11 magic statics.
const float* f16_lut() {
  static const std::vector<float> lut = [] {
    std::vector<float> t(65536);
    for (int v = -32768; v < 32768; ++v)
      t[static_cast<uint16_t>(static_cast<int16_t>(v))] =
          f16_grid(static_cast<float>(v));
    return t;
  }();
  return lut.data();
}

#ifdef DA_AVX512
// 16 int16 -> f32 on the f16 grid, in registers (replaces the 64K-LUT
// gather). Rounding to f16 = keeping the top 10 f32 mantissa bits with
// round-to-nearest-even, done as integer bit math on the f32 pattern:
// bits += 0xFFF + lsb(kept), clear low 13. Exact for every int16 input
// (all land in f16's normal range; a mantissa carry rolls into the
// exponent correctly, the sign bit is unreachable). The previous
// cvtps_ph/cvtph_ps round trip was correct too but stacked 3 port-5
// convert uops per vector - this spreads across the integer ports
// (exhaustively verified against the scalar f16_grid in tests).
inline __m512 cvt_i16_f16grid(__m256i v16) {
  const __m512i b = _mm512_castps_si512(
      _mm512_cvtepi32_ps(_mm512_cvtepi16_epi32(v16)));
  const __m512i rnd = _mm512_add_epi32(
      _mm512_set1_epi32(0xFFF),
      _mm512_and_si512(_mm512_srli_epi32(b, 13), _mm512_set1_epi32(1)));
  return _mm512_castsi512_ps(_mm512_and_si512(
      _mm512_add_epi32(b, rnd), _mm512_set1_epi32(~0x1FFF)));
}
#endif

// The flattened-FIR weight permutation of downsample_blur (see there):
// w[d - lo] = taps[2*(d mod ds) - d] with lo = -ds*(blur-1), so the
// per-phase 'same' convolutions collapse into one plain strided FIR.
std::vector<float> blur_w(int ds, int blur) {
  const int W = ds * blur;
  const int lo = -ds * (blur - 1);
  std::vector<float> taps = hann_taps(ds * blur + 2);
  std::vector<float> w(static_cast<size_t>(W));
  for (int d = lo; d < ds; ++d) {
    int i = ((d % ds) + ds) % ds;
    w[static_cast<size_t>(d - lo)] = taps[static_cast<size_t>(2 * i - d)];
  }
  return w;
}

// Small-W polyphase blur (the blur=3 full-rate stages): a dot per output
// never fills the vector units (the 15-21 tap window is shorter than two
// AVX registers). Decompose by phase instead: with d = ds*t + p,
//   out[j] = sum_p sum_t w[ds*t+p] * x[ds*(j + c - blur + 1 + t) + p]
// so per (p, t) the update is a CONTIGUOUS axpy over the deinterleaved
// phase signal xph_p[i] = x[ds*i + p]. Blocked so the deinterleave source
// and phase buffers stay L2-resident; the deinterleave itself is an
// AVX-512 gather (a scalar strided load dominated the stage otherwise).
//
// When band_energy != nullptr, also emits the residual band energy
//   band_energy[j] = sum_p (x[ds*j + p] - out[j])^2
// from the same hot phase buffers (saves a full re-read of x, and makes
// the ds-wide horizontal sum a sequence of contiguous vertical passes in
// the exact accumulation order of the scalar loop it replaces).
// When xi != nullptr, x is ignored and the source samples are int16 PCM
// converted to the f16 grid block-locally (a ~100 KB L2-resident buffer),
// so the full-rate f32 intermediate never has to exist in memory.
void small_w_blur(const float* x, const int16_t* xi, int ds, int blur,
                  int64_t no, const std::vector<float>& w, float* out,
                  float* band_energy) {
  const int64_t BLK = 4096;
  const int c = (blur - 1) / 2;
  const int64_t shift0 = c - blur + 1;              // <= 0 (c < blur)
  std::vector<float> ph(static_cast<size_t>(ds) * (BLK + blur));
  std::vector<float> conv(xi ? static_cast<size_t>(ds) * (BLK + blur) : 0);
  for (int64_t j0 = 0; j0 < no; j0 += BLK) {
    const int64_t jn = (BLK < no - j0) ? BLK : (no - j0);
    const int64_t i0 = j0 + shift0;                 // first phase index
    const int64_t cnt = jn + blur - 1;              // phase indices used
    const int64_t u_lo = (i0 < 0) ? -i0 : 0;        // valid index window
    const int64_t u_hi = (no - i0 < cnt) ? (no - i0) : cnt;
    if (xi && u_hi > u_lo) {
      // convert this block's sample window once; the gathers below then
      // read the same values the f32 path would
      const int64_t s0 = ds * (i0 + u_lo);
      const int64_t s1 = ds * (i0 + u_hi);
      float* cb = conv.data();
      int64_t s = s0;
#ifdef DA_AVX512
      for (; s + 16 <= s1; s += 16)
        _mm512_storeu_ps(cb + (s - s0), cvt_i16_f16grid(
            _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(xi + s))));
#endif
      const float* lut = f16_lut();
      for (; s < s1; ++s)
        cb[s - s0] = lut[static_cast<uint16_t>(xi[s])];
      x = cb - s0;
    }
    for (int p = 0; p < ds; ++p) {
      float* dst = ph.data() + static_cast<size_t>(p) * (BLK + blur);
      for (int64_t u = 0; u < u_lo; ++u) dst[u] = 0.f;
      for (int64_t u = (u_hi > u_lo) ? u_hi : u_lo; u < cnt; ++u)
        dst[u] = 0.f;
      int64_t u = u_lo;
#ifdef DA_AVX512
      const __m512i gstep = _mm512_mullo_epi32(
          _mm512_set_epi32(15, 14, 13, 12, 11, 10, 9, 8,
                           7, 6, 5, 4, 3, 2, 1, 0),
          _mm512_set1_epi32(ds));
      for (; u + 16 <= u_hi; u += 16) {
        const float* base = x + ds * (i0 + u) + p;
        _mm512_storeu_ps(dst + u,
                         _mm512_i32gather_ps(gstep, base, 4));
      }
#endif
      for (; u < u_hi; ++u) dst[u] = x[ds * (i0 + u) + p];
    }
    float* op = out + j0;
    for (int64_t jj = 0; jj < jn; ++jj) op[jj] = 0.f;
    for (int p = 0; p < ds; ++p) {
      const float* src = ph.data() + static_cast<size_t>(p) * (BLK + blur);
      for (int t = 0; t < blur; ++t) {
        const float wv = w[static_cast<size_t>(ds * t + p)];
        const float* s = src + t;
        for (int64_t jj = 0; jj < jn; ++jj) op[jj] += wv * s[jj];
      }
    }
    if (band_energy) {
      float* be = band_energy + j0;
      // x[ds*j + p] = ph_p[j - i0]; -shift0 offsets into the buffer
      for (int64_t jj = 0; jj < jn; ++jj) be[jj] = 0.f;
      for (int p = 0; p < ds; ++p) {
        const float* s = ph.data() + static_cast<size_t>(p) * (BLK + blur)
                         - shift0;
        for (int64_t jj = 0; jj < jn; ++jj) {
          const float d = s[jj] - op[jj];
          be[jj] += d * d;
        }
      }
    }
  }
}

#ifdef DA_AVX512
// blur=3 strided-FIR template (stage 0: ds=5 over 44.1 kHz int16 PCM,
// stage 1: ds=7 over the 8.8 kHz f32 stage-0 output - together the
// extractor's two hottest loops). The general small_w_blur deinterleaves
// phases with i32 gathers, which run at microcode speed on hosts with
// gather mitigations (measured ~25-40 cycles/output on the bench VM).
// Only the DS BASE tap vectors (d = 0..DS-1) are built from contiguous
// ZMM loads by two-source lane permutes + blends; taps d+DS and d+2*DS
// are the base taps shifted one/two LANES (v_{d+DS}(j)[lane] =
// x[DS*(j+lane)+d] = v_d(j)[lane+1]), so they come from single valignd
// ops against the NEXT output block's base taps - for ds=5 that is 35
// port-5 ops per 16 outputs instead of the 90 a full 15-tap permute
// build costs. The tap sums run as three accumulator chains (a single
// ascending chain is FMA-latency-bound; the reorder is plain f32
// reassociation, inside the extractor's oracle tolerance - the numpy
// fallback already sums the taps in per-phase order), and the
// band-energy residual reuses taps DS..2*DS-1 (exactly the x[DS*j+p]
// samples).
//
// xi != nullptr: the source is int16 PCM converted to the f16 grid
// block-locally (L2-resident buffer), so the full-rate f32 intermediate
// never exists in memory. xi == nullptr: x is read directly (every
// lookahead load is provably in bounds for block starts <= no-32).
//
// The [j0, j1) range form exists for the fused extractor, which walks
// energy/ZCR/blur over one L2-resident PCM tile at a time so the
// 44.1 kHz stream crosses DRAM once instead of three times (the
// extractor is DRAM-bound at media scale: ~12 GB/s single-core on the
// bench host). Writes are idempotent (out[j] depends only on the
// source), so the <=15-output overrun of a range's final vector block
// is harmless.
template <int DS>
struct Blur3LUT {
  static constexpr int kPairs = (DS + 1) / 2;
  __m512i idx[DS][kPairs];
  __mmask16 mask[DS][kPairs];
  Blur3LUT() {
    for (int d = 0; d < DS; ++d) {
      for (int p = 0; p < kPairs; ++p) {
        alignas(64) int a[16];
        uint16_t msk = 0;
        for (int lane = 0; lane < 16; ++lane) {
          const int q = DS * lane + d;    // flat offset of this lane's tap
          a[lane] = (q - 32 * p) & 31;
          if (q >= 32 * p && q < 32 * (p + 1))
            msk |= static_cast<uint16_t>(1) << lane;
        }
        idx[d][p] = _mm512_load_si512(a);
        mask[d][p] = msk;
      }
    }
  }
};

template <int DS>
void small_w_blur3_range(const float* x, const int16_t* xi, int64_t no,
                         const std::vector<float>& w, float* out,
                         float* band_energy, int64_t j0, int64_t j1,
                         std::vector<float>& buf) {
  static const Blur3LUT<DS> T;
  const int64_t m = no * DS;
  const float* lut = f16_lut();
  float wv[3 * DS];
  for (int d = 0; d < 3 * DS; ++d) wv[d] = w[static_cast<size_t>(d)];

  auto sample = [&](int64_t q) -> float {
    return xi ? lut[static_cast<uint16_t>(xi[q])] : x[q];
  };
  auto scalar_one = [&](int64_t j) {
    const int64_t base = DS * j - DS;     // DS*(j + c - blur + 1), c=1
    float s = 0.f;
    for (int d = 0; d < 3 * DS; ++d) {
      const int64_t q = base + d;
      if (q >= 0 && q < m) s += wv[d] * sample(q);
    }
    out[j] = s;
    if (band_energy) {
      float be = 0.f;
      for (int p = 0; p < DS; ++p) {
        const float dph = sample(DS * j + p) - s;
        be += dph * dph;
      }
      band_energy[j] = be;
    }
  };

  int64_t j = j0;
  const int64_t last_start = no - 32;   // last 16-wide block start: its
                                        // lookahead reads sample DS*no-1
  for (; j < 16 && j < j1; ++j) scalar_one(j);
  const int64_t BLK = 4096;
  if (xi) buf.resize(static_cast<size_t>(DS) * BLK + 32 * DS);
  const int64_t vend = (j1 <= last_start + 1) ? j1 : (last_start + 1);
  const int64_t vstart = j;
  for (int64_t jb = vstart; jb < vend; jb += BLK) {
    const int64_t jend_blk = (jb + BLK <= vend) ? (jb + BLK) : vend;
    // highest block start actually issued in this BLK span
    const int64_t jj_last = jb + ((jend_blk - 1 - jb) / 16) * 16;
    const int64_t s_lo = DS * jb - DS;
    const float* src = x;
    if (xi) {
      // convert this span's sample window once; the lookahead of the
      // last block reads up to DS*jj_last + 31*DS - 1 < m
      const int64_t s_hi = DS * jj_last + 31 * DS;   // exclusive
      const int64_t s_cv = (s_hi < m) ? s_hi : m;
      float* cb = buf.data();
      int64_t s = s_lo;
      for (; s + 16 <= s_cv; s += 16)
        _mm512_storeu_ps(cb + (s - s_lo), cvt_i16_f16grid(
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(xi + s))));
      for (; s < s_cv; ++s)
        cb[s - s_lo] = lut[static_cast<uint16_t>(xi[s])];
      for (; s < s_hi; ++s) cb[s - s_lo] = 0.f;    // unreachable-by-proof
      src = cb - s_lo;
    }
    // base taps d=0..DS-1 of the block starting at output jj (lane L
    // reads flat sample DS*(jj+L) - DS + d)
    auto load_base = [&](int64_t jj, __m512* base) {
      const float* p = src + (DS * jj - DS);
      __m512 r[DS];
      for (int t = 0; t < DS; ++t) r[t] = _mm512_loadu_ps(p + 16 * t);
      for (int d = 0; d < DS; ++d) {
        __m512 v = _mm512_setzero_ps();
        for (int pr = 0; pr < Blur3LUT<DS>::kPairs; ++pr) {
          const __m512 hi = (2 * pr + 1 < DS) ? r[2 * pr + 1] : r[2 * pr];
          const __m512 sel =
              _mm512_permutex2var_ps(r[2 * pr], T.idx[d][pr], hi);
          v = (pr == 0) ? sel : _mm512_mask_blend_ps(T.mask[d][pr], v, sel);
        }
        base[d] = v;
      }
    };
    __m512 bcur[DS], bnext[DS];
    load_base(jb, bcur);
    for (int64_t jj = jb; jj <= jj_last; jj += 16) {
      load_base(jj + 16, bnext);
      __m512 v[3 * DS];
      for (int d = 0; d < DS; ++d) {
        v[d] = bcur[d];
        v[d + DS] = _mm512_castsi512_ps(_mm512_alignr_epi32(
            _mm512_castps_si512(bnext[d]), _mm512_castps_si512(bcur[d]),
            1));
        v[d + 2 * DS] = _mm512_castsi512_ps(_mm512_alignr_epi32(
            _mm512_castps_si512(bnext[d]), _mm512_castps_si512(bcur[d]),
            2));
      }
      __m512 a0 = _mm512_setzero_ps();
      __m512 a1 = _mm512_setzero_ps();
      __m512 a2 = _mm512_setzero_ps();
      for (int d = 0; d < 3 * DS; d += 3) {
        a0 = _mm512_fmadd_ps(_mm512_set1_ps(wv[d]), v[d], a0);
        a1 = _mm512_fmadd_ps(_mm512_set1_ps(wv[d + 1]), v[d + 1], a1);
        a2 = _mm512_fmadd_ps(_mm512_set1_ps(wv[d + 2]), v[d + 2], a2);
      }
      const __m512 acc = _mm512_add_ps(_mm512_add_ps(a0, a1), a2);
      _mm512_storeu_ps(out + jj, acc);
      if (band_energy) {
        __m512 b0 = _mm512_setzero_ps();
        __m512 b1 = _mm512_setzero_ps();
        for (int p = 0; p < DS; ++p) {
          const __m512 dph = _mm512_sub_ps(v[DS + p], acc);
          if (p & 1) b1 = _mm512_fmadd_ps(dph, dph, b1);
          else b0 = _mm512_fmadd_ps(dph, dph, b0);
        }
        _mm512_storeu_ps(band_energy + jj, _mm512_add_ps(b0, b1));
      }
      for (int d = 0; d < DS; ++d) bcur[d] = bnext[d];
      j = jj + 16;
    }
  }
  for (; j < j1; ++j) scalar_one(j);
}
#endif

// np.convolve(x, taps, mode='same'): zero-padded, center (t-1)/2.
// Tap-major shift-and-add: each tap contributes one contiguous
// vectorizable pass, so the compiler's auto-vectorizer gets clean loops.
void conv_same(const float* x, int64_t n, const std::vector<float>& taps,
               float* out) {
  int t = static_cast<int>(taps.size());
  int c = (t - 1) / 2;
  for (int64_t i = 0; i < n; ++i) out[i] = 0.f;
  for (int m = 0; m < t; ++m) {
    float w = taps[static_cast<size_t>(m)];
    int64_t lo = (m - c > 0) ? (m - c) : 0;           // i + c - m >= 0
    int64_t hi = (n + m - c < n) ? (n + m - c) : n;   // i + c - m <= n-1
    const float* xs = x + (c - m);
    for (int64_t i = lo; i < hi; ++i) out[i] += w * xs[i];
  }
}

// polyphase hann lowpass + decimate (reference downsample_blur, 568-573):
// out[j] = sum_i conv_same(x[i::ds], taps(ds*blur+2)[i::ds])[j]
// x is trimmed to a multiple of ds; out has n/ds elements.
//
// The per-phase 'same' convolutions collapse algebraically into ONE plain
// FIR evaluated at stride ds: out[j] = sum_d w[d] * x[ds*(j+c) + lo + d]
// with c = (blur-1)/2, lo = -ds*(blur-1), and w a permutation of the hann
// taps (w[d - lo] = taps[2*(d mod ds) - d]); per-phase zero padding is
// exactly index clipping. One contiguous dot per output vectorizes far
// better than ds separate phase passes.
// When band_energy != nullptr it receives the per-output residual energy
// sum_p (x[ds*j+p] - out[j])^2 (resized to match out), fused into the
// blocked pass when the small-W path applies.
// xi: optional int16 source (x ignored; samples f16-grid-converted on the
// fly inside the blocked small-W path, or materialized once for the rare
// short-input dot path).
void downsample_blur(const float* x, int64_t n, int ds, int blur,
                     std::vector<float>& out,
                     std::vector<float>* band_energy = nullptr,
                     const int16_t* xi = nullptr) {
  int64_t m = n - (n % ds);
  int64_t no = m / ds;
  int W = ds * blur;
  int lo = -ds * (blur - 1);
  int c = (blur - 1) / 2;
  std::vector<float> w = blur_w(ds, blur);
  out.resize(static_cast<size_t>(no));

  if (band_energy) band_energy->resize(static_cast<size_t>(no));
  if (W <= 64 && no >= 1024) {
#ifdef DA_AVX512
    if (blur == 3 && (ds == 5 || ds == 7)) {
      std::vector<float> buf;
      float* be = band_energy ? band_energy->data() : nullptr;
      if (ds == 5)
        small_w_blur3_range<5>(x, xi, no, w, out.data(), be, 0, no, buf);
      else
        small_w_blur3_range<7>(x, xi, no, w, out.data(), be, 0, no, buf);
      return;
    }
#endif
    small_w_blur(x, xi, ds, blur, no, w, out.data(),
                 band_energy ? band_energy->data() : nullptr);
    return;
  }
  std::vector<float> materialized;
  if (xi) {
    // rare path (short inputs): materialize the f16-grid samples once
    materialized.resize(static_cast<size_t>(m));
    const float* lut = f16_lut();
    for (int64_t i = 0; i < m; ++i)
      materialized[static_cast<size_t>(i)] =
          lut[static_cast<uint16_t>(xi[i])];
    x = materialized.data();
  }

  for (int64_t j = 0; j < no; ++j) {
    int64_t base = ds * (j + c) + lo;
    int64_t klo = base < 0 ? -base : 0;
    int64_t khi = W < m - base ? W : m - base;
    const float* xp = x + base;
    float s;
#ifdef DA_AVX512
    // plain contiguous dot (w and xp both walk k): 4 ZMM accumulator
    // chains reach FMA throughput; the gcc-autovectorized 32-float
    // accumulator form measured ~2x slower on the 630-tap band-0 FIR
    {
      __m512 a0 = _mm512_setzero_ps(), a1 = _mm512_setzero_ps();
      __m512 a2 = _mm512_setzero_ps(), a3 = _mm512_setzero_ps();
      int64_t k = klo;
      for (; k + 64 <= khi; k += 64) {
        a0 = _mm512_fmadd_ps(_mm512_loadu_ps(&w[static_cast<size_t>(k)]),
                             _mm512_loadu_ps(xp + k), a0);
        a1 = _mm512_fmadd_ps(
            _mm512_loadu_ps(&w[static_cast<size_t>(k + 16)]),
            _mm512_loadu_ps(xp + k + 16), a1);
        a2 = _mm512_fmadd_ps(
            _mm512_loadu_ps(&w[static_cast<size_t>(k + 32)]),
            _mm512_loadu_ps(xp + k + 32), a2);
        a3 = _mm512_fmadd_ps(
            _mm512_loadu_ps(&w[static_cast<size_t>(k + 48)]),
            _mm512_loadu_ps(xp + k + 48), a3);
      }
      for (; k + 16 <= khi; k += 16)
        a0 = _mm512_fmadd_ps(_mm512_loadu_ps(&w[static_cast<size_t>(k)]),
                             _mm512_loadu_ps(xp + k), a0);
      if (k < khi) {
        const __mmask16 tm =
            static_cast<__mmask16>((1u << (khi - k)) - 1);
        a1 = _mm512_fmadd_ps(
            _mm512_maskz_loadu_ps(tm, &w[static_cast<size_t>(k)]),
            _mm512_maskz_loadu_ps(tm, xp + k), a1);
      }
      s = _mm512_reduce_add_ps(
          _mm512_add_ps(_mm512_add_ps(a0, a1), _mm512_add_ps(a2, a3)));
    }
#else
    // 32 accumulators in 4 independent 8-lane groups: gcc will not
    // vectorize a plain float reduction without -ffast-math, and a single
    // vector accumulator is FMA-LATENCY-bound (one dependency chain);
    // four chains in flight reach FMA throughput. Deterministic order.
    float acc[32] = {0.f};
    int64_t k = klo;
    for (; k + 32 <= khi; k += 32)
      for (int u = 0; u < 32; ++u)
        acc[u] += w[static_cast<size_t>(k + u)] * xp[k + u];
    for (; k + 8 <= khi; k += 8)
      for (int u = 0; u < 8; ++u)
        acc[u] += w[static_cast<size_t>(k + u)] * xp[k + u];
    s = 0.f;
    for (int g = 0; g < 32; g += 8)
      s += ((acc[g] + acc[g + 1]) + (acc[g + 2] + acc[g + 3]))
           + ((acc[g + 4] + acc[g + 5]) + (acc[g + 6] + acc[g + 7]));
    for (; k < khi; ++k) s += w[static_cast<size_t>(k)] * xp[k];
#endif
    out[static_cast<size_t>(j)] = s;
  }
  if (band_energy) {
    for (int64_t j = 0; j < no; ++j) {
      const float* p = x + j * ds;
      const float b = out[static_cast<size_t>(j)];
      float s = 0.f;
      for (int i = 0; i < ds; ++i) {
        const float d = p[i] - b;
        s += d * d;
      }
      (*band_energy)[static_cast<size_t>(j)] = s;
    }
  }
}

inline float log_comp(float x) { return std::log10(1.f + x) / 2.f; }

// dev-only stage timing, enabled by DESCRIBEALIGN_FEAT_PROFILE=1
struct StageTimer {
  bool on;
  std::chrono::steady_clock::time_point t;
  StageTimer() : on(std::getenv("DESCRIBEALIGN_FEAT_PROFILE") != nullptr),
                 t(std::chrono::steady_clock::now()) {}
  void lap(const char* name) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "  [feat] %-12s %.3fs\n", name,
                 std::chrono::duration<double>(now - t).count());
    t = now;
  }
};

// Reused scratch buffers: the extractor's intermediates total ~700 MB
// of traffic at 27-min scale; allocating them fresh each call costs more
// in page faults + zero-init than the arithmetic itself. A mutex-guarded
// pool (acquire at call start, return at call end) shares buffersets
// across batch-mode worker threads and bounds retention at
// kScratchRetain sets - thread_local scratch pinned one media-length
// bufferset per worker thread for the process lifetime (>1 GB after a
// 4-worker batch).
struct FeatScratch {
  std::vector<float> arr, energy, smooth, counts;
  std::vector<float> bottom[2], band_energy, band_energy0, band;
};
std::mutex g_scratch_mu;
std::vector<std::unique_ptr<FeatScratch>> g_scratch_pool;
constexpr size_t kScratchRetain = 2;  // buffersets kept across calls

struct ScratchLease {
  std::unique_ptr<FeatScratch> s;
  ScratchLease() {
    std::lock_guard<std::mutex> lk(g_scratch_mu);
    if (!g_scratch_pool.empty()) {
      s = std::move(g_scratch_pool.back());
      g_scratch_pool.pop_back();
    } else {
      s.reset(new FeatScratch);
    }
  }
  ~ScratchLease() {
    std::lock_guard<std::mutex> lk(g_scratch_mu);
    if (g_scratch_pool.size() < kScratchRetain)
      g_scratch_pool.push_back(std::move(s));
  }
};

}  // namespace

extern "C" {

// Extract all 5 feature streams from int16 PCM.
//   pcm:      (channels, samples) int16, row-major
//   out:      (5, out_stride) float32, caller-zeroed
//   out_lens: per-stream frame counts (5)
// Returns 0 on success.
int extract_features_i16(const int16_t* pcm, int64_t channels,
                         int64_t samples, float* out, int64_t out_stride,
                         int64_t* out_lens) {
  if (channels < 1 || samples < 210) return 1;
  StageTimer st;

  // --- f16-grid PCM (per channel) and channel mean ------------------------
  // int16 -> f16 via a 64K lookup table (exact round-to-nearest-even)
  const float* lut = f16_lut();

  // --- fused front pass: f16-grid channel mix + block energy ---------------
  // one pass over the PCM produces the band-cascade input (per-sample
  // f16-grid value / f16 channel mean) and the per-105-block square sums
  // the energy feature needs; no full-rate intermediate is materialized
  // twice.
  int64_t n_arr = samples - samples % 210;
  ScratchLease lease;
  FeatScratch& S = *lease.s;
  std::vector<float>& arr = S.arr;
  // mono + AVX-512: the band cascade converts PCM block-locally and the
  // energy sums convert in registers, so the 285 MB-at-media-scale
  // full-rate f32 intermediate never exists (its write + two re-reads
  // were the extractor's largest memory cost)
#ifdef DA_AVX512
  const bool fused = (channels == 1);
#else
  const bool fused = false;
#endif
  if (!fused) arr.resize(static_cast<size_t>(n_arr));
  int64_t ne = samples / 105;
  std::vector<float>& energy = S.energy;
  energy.resize(static_cast<size_t>(ne));
#ifdef DA_AVX512
  if (fused) {
    // --- fused tiled front pass (mono) -------------------------------------
    // The extractor is DRAM-bound at media scale (~12 GB/s single-core):
    // energy, ZCR, and the stage-0 blur each walk the full 44.1 kHz PCM,
    // so running them as three separate passes pays DRAM three times.
    // Here they walk ONE L2-resident tile at a time - the first sub-pass
    // pulls the tile from DRAM, the other two hit L2. The stage-0 blur's
    // band output and ZCR counts land in scratch for the shared
    // post-processing below; per-output math is identical to the
    // unfused kernels (idempotent range form of the blur).
    const int64_t nz = n_arr / 210;
    std::vector<float>& counts = S.counts;
    counts.assign(static_cast<size_t>(nz), 0.f);
    const int64_t no0 = n_arr / 5;
    std::vector<float>& bottom0 = S.bottom[0];
    std::vector<float>& be0 = S.band_energy0;
    bottom0.resize(static_cast<size_t>(no0));
    be0.resize(static_cast<size_t>(no0));
    const std::vector<float> w5 = blur_w(5, 3);
    std::vector<float> blurbuf;
    const float inv = 1.f / 105.f;
    const int64_t TILE = 215040;     // samples: lcm(210, 80)*128, ~420 KB
    for (int64_t s0 = 0; s0 < n_arr; s0 += TILE) {
      const int64_t s1 = (s0 + TILE < n_arr) ? s0 + TILE : n_arr;
      for (int64_t b = s0 / 105; b < s1 / 105; ++b) {
        const int16_t* q = pcm + b * 105;
        __m512 acc = _mm512_setzero_ps();
        for (int k = 0; k + 16 <= 105; k += 16) {
          __m512 v = cvt_i16_f16grid(_mm256_loadu_si256(
              reinterpret_cast<const __m256i*>(q + k)));
          acc = _mm512_fmadd_ps(v, v, acc);
        }
        __m512 v = cvt_i16_f16grid(
            _mm256_maskz_loadu_epi16((1u << (105 - 96)) - 1, q + 96));
        acc = _mm512_fmadd_ps(v, v, acc);
        energy[static_cast<size_t>(b)] = _mm512_reduce_add_ps(acc) * inv;
      }
      int64_t b = s0 / 210;
      if (b == 0 && nz > 0) {  // np.diff(..., prepend=False): first block
        int32_t cnt = (pcm[0] < 0);
        for (int k = 1; k < 210; ++k)
          cnt += static_cast<uint16_t>(pcm[k] ^ pcm[k - 1]) >> 15;
        counts[0] = static_cast<float>(cnt);
        b = 1;
      }
      for (; b < s1 / 210; ++b) {
        const int16_t* q = pcm + b * 210;
        __m512i acc = _mm512_setzero_si512();
        for (int k = 0; k + 32 <= 210; k += 32) {
          const __m512i a = _mm512_loadu_si512(q + k);
          const __m512i d = _mm512_loadu_si512(q + k - 1);
          acc = _mm512_add_epi16(
              acc, _mm512_srli_epi16(_mm512_xor_si512(a, d), 15));
        }
        const __mmask32 tm = (1u << 18) - 1;  // tail lanes 192..209
        const __m512i a = _mm512_maskz_loadu_epi16(tm, q + 192);
        const __m512i d = _mm512_maskz_loadu_epi16(tm, q + 191);
        acc = _mm512_add_epi16(
            acc, _mm512_srli_epi16(_mm512_xor_si512(a, d), 15));
        counts[static_cast<size_t>(b)] = static_cast<float>(
            _mm512_reduce_add_epi32(
                _mm512_madd_epi16(acc, _mm512_set1_epi16(1))));
      }
      small_w_blur3_range<5>(nullptr, pcm, no0, w5, bottom0.data(),
                             be0.data(), s0 / 5, s1 / 5, blurbuf);
    }
    for (int64_t b = n_arr / 105; b < ne; ++b) {  // blocks past n_arr
      float s = 0.f;
      const int64_t i0 = b * 105;
      for (int k = 0; k < 105; ++k) {
        float v = lut[static_cast<uint16_t>(pcm[i0 + k])];
        s += v * v;
      }
      energy[static_cast<size_t>(b)] = s * inv;
    }
  }
#endif
  if (!fused) {
    float inv = 1.f / (105.f * static_cast<float>(channels));
    if (channels == 1) {
      const int16_t* p = pcm;
      for (int64_t b = 0; b < ne; ++b) {
        float s = 0.f;
        const int64_t i0 = b * 105;
        if (i0 + 105 <= n_arr) {
          float* dst = arr.data() + i0;
          const int16_t* q = p + i0;
          for (int k = 0; k < 105; ++k) {
            float v = lut[static_cast<uint16_t>(q[k])];
            dst[k] = v;
            s += v * v;
          }
        } else {
          for (int k = 0; k < 105; ++k) {
            float v = lut[static_cast<uint16_t>(p[i0 + k])];
            if (i0 + k < n_arr) arr[static_cast<size_t>(i0 + k)] = v;
            s += v * v;
          }
        }
        energy[static_cast<size_t>(b)] = s * inv;
      }
    } else {
      // numpy float16 mean over channels accumulates in FLOAT32 and rounds
      // once (np.mean special-cases f16); per-step f16 rounding would
      // overflow to inf on clipped full-scale stereo (32768 + 32768)
      for (int64_t b = 0; b < ne; ++b) {
        float s = 0.f;
        const int64_t i0 = b * 105;
        for (int k = 0; k < 105; ++k) {
          const int64_t i = i0 + k;
          float m = lut[static_cast<uint16_t>(pcm[i])];
          s += m * m;
          for (int64_t c = 1; c < channels; ++c) {
            float v = lut[static_cast<uint16_t>(pcm[c * samples + i])];
            s += v * v;
            m += v;
          }
          if (i < n_arr)
            arr[static_cast<size_t>(i)] =
                f16_grid(m / static_cast<float>(channels));
        }
        energy[static_cast<size_t>(b)] = s * inv;
      }
    }
  }

  st.lap("front");
  // --- energy (reference 545-555) -----------------------------------------
  {
    std::vector<float>& smooth = S.smooth;
    smooth.resize(static_cast<size_t>(ne));
    conv_same(energy.data(), ne, hann_taps(15), smooth.data());
    int64_t no = (ne + 1) / 2;
    for (int64_t i = 0; i < no; ++i)
      out[i] = log_comp(smooth[static_cast<size_t>(2 * i)]);
    out_lens[0] = no;
  }

  st.lap("energy");
  // --- zero crossings (reference 557-566) ----------------------------------
  {
    int64_t n = samples - samples % 210;
    int64_t nz = n / 210;
    std::vector<float>& counts = S.counts;
    if (!fused) {
      counts.assign(static_cast<size_t>(nz), 0.f);
    }
    for (int64_t c = fused ? channels : 0; c < channels; ++c) {
      const int16_t* p = pcm + c * samples;
      // sign(q[k]) != sign(q[k-1])  <=>  the xor's sign bit is set; the
      // adjacent-load form has no loop-carried state, so it vectorizes
      // (the old running-bool `prev` forced a serial chain)
      int64_t b = 0;
      if (nz > 0) {  // np.diff(..., prepend=False): first diff vs "false"
        int32_t cnt = (p[0] < 0);
        for (int k = 1; k < 210; ++k)
          cnt += static_cast<uint16_t>(p[k] ^ p[k - 1]) >> 15;
        counts[0] += static_cast<float>(cnt);
        b = 1;
      }
#ifdef DA_AVX512
      // explicit u16-lane version: per 32 samples one load pair + xor +
      // shift + add into 32 u16 accumulators (each lane sums <= 7 bits
      // per block, far from overflow), one widening reduce per block -
      // the autovectorized form re-widened to i32 inside the loop
      for (; b < nz; ++b) {
        const int16_t* q = p + b * 210;
        __m512i acc = _mm512_setzero_si512();
        for (int k = 0; k + 32 <= 210; k += 32) {
          const __m512i a = _mm512_loadu_si512(q + k);
          const __m512i d = _mm512_loadu_si512(q + k - 1);
          acc = _mm512_add_epi16(
              acc, _mm512_srli_epi16(_mm512_xor_si512(a, d), 15));
        }
        {  // tail lanes 192..209 (18 samples)
          const __mmask32 tm = (1u << 18) - 1;
          const __m512i a = _mm512_maskz_loadu_epi16(tm, q + 192);
          const __m512i d = _mm512_maskz_loadu_epi16(tm, q + 191);
          acc = _mm512_add_epi16(
              acc, _mm512_srli_epi16(_mm512_xor_si512(a, d), 15));
        }
        const int32_t cnt = _mm512_reduce_add_epi32(
            _mm512_madd_epi16(acc, _mm512_set1_epi16(1)));
        counts[static_cast<size_t>(b)] += static_cast<float>(cnt);
      }
#else
      for (; b < nz; ++b) {
        const int16_t* q = p + b * 210;
        int32_t cnt = 0;
        for (int k = 0; k < 210; ++k)
          cnt += static_cast<uint16_t>(q[k] ^ q[k - 1]) >> 15;
        counts[static_cast<size_t>(b)] += static_cast<float>(cnt);
      }
#endif
    }
    if (channels == 1)
      for (float& v : counts) v *= 2.f;
    conv_same(counts.data(), nz, hann_taps(15),
              out + out_stride);
    out_lens[1] = nz;
  }

  st.lap("zcr");
  // --- freq bands (reference 568-593) --------------------------------------
  {
    const int downsamples[3] = {5, 7, 6};
    int64_t decimation = 1;
    const float* cur = fused ? nullptr : arr.data();
    const int16_t* cur_i16 = fused ? pcm : nullptr;
    int64_t cur_n = n_arr;
    for (int stage = 0; stage < 3; ++stage) {
      int ds = downsamples[stage];
      int64_t m = cur_n - cur_n % ds;
      int64_t nb = m / ds;
      std::vector<float>& bottom = S.bottom[stage & 1];
      std::vector<float>* band_energy = &S.band_energy;
      decimation *= ds;
      if (stage == 0 && fused) {
        // the fused front pass already produced stage 0's blur (bottom0)
        // and residual band energy
        band_energy = &S.band_energy0;
      } else if (stage < 2) {
        downsample_blur(cur, m, ds, 3, bottom, band_energy, cur_i16);
      } else {
        band_energy->resize(static_cast<size_t>(nb));
        for (int64_t j = 0; j < nb; ++j) {
          const float* p = cur + j * ds;
          float s = 0.f;
          for (int i = 0; i < ds; ++i) s += p[i] * p[i];
          (*band_energy)[static_cast<size_t>(j)] = s;
        }
      }
      st.lap("  blur+be");
      std::vector<float>& band = S.band;
      downsample_blur(band_energy->data(), nb,
                      static_cast<int>(210 / decimation), 15, band);
      float* dst = out + (2 + stage) * out_stride;
      for (size_t j = 0; j < band.size(); ++j)
        dst[j] = log_comp(band[j] / 210.f);
      out_lens[2 + stage] = static_cast<int64_t>(band.size());
      char nm[16];
      std::snprintf(nm, sizeof nm, "band%d", stage);
      st.lap(nm);
      cur = bottom.data();
      cur_i16 = nullptr;
      cur_n = static_cast<int64_t>(bottom.size());
    }
  }
  return 0;
}

// Phase-vocoder phase propagation with identity phase locking (the frame
// recurrence of stretch/phase_vocoder.py: the LOCKED phase carries
// forward, so frames are inherently sequential; bins vectorize).
//   phase_a:        (C, F, BINS) analysis phases (f32)
//   mag:            (C, F, BINS) magnitudes (f32)
//   inst_over_rate: (C, F-1, BINS) per-hop phase increments (f32)
//   phases (out):   (C, F, BINS) locked synthesis phases
// Returns 0 on success.
int pv_phase_lock(const float* phase_a, const float* mag,
                  const float* inst_over_rate, int64_t c, int64_t f,
                  int64_t bins, float* phases) {
  if (f < 1 || bins < 2) return 1;
  std::vector<float> rot(static_cast<size_t>(bins));
  for (int64_t ch = 0; ch < c; ++ch) {
    const float* pa = phase_a + ch * f * bins;
    const float* mg = mag + ch * f * bins;
    const float* io = inst_over_rate + ch * (f - 1) * bins;
    float* out = phases + ch * f * bins;
    std::memcpy(out, pa, static_cast<size_t>(bins) * 4);
    const float* prev = out;                    // locked phases, frame k-1
    for (int64_t k = 1; k < f; ++k) {
      const float* pak = pa + k * bins;
      const float* mgk = mg + k * bins;
      const float* iok = io + (k - 1) * bins;
      float* cur = out + k * bins;
      for (int64_t b = 0; b < bins; ++b)
        rot[static_cast<size_t>(b)] = prev[b] + iok[b] - pak[b];
      for (int64_t b = 0; b < bins; ++b) {
        const float m = mgk[b];
        const float lm = b > 0 ? mgk[b - 1] : 0.f;
        const float rm = b + 1 < bins ? mgk[b + 1] : 0.f;
        float r = rot[static_cast<size_t>(b)];
        if (lm > m && lm > rm) {
          r = rot[static_cast<size_t>(b - 1)];
        } else if (rm > m) {
          r = rot[static_cast<size_t>(b + 1)];
        }
        cur[b] = pak[b] + r;
      }
      prev = cur;
    }
  }
  return 0;
}

// Chunked variant of pv_phase_lock: processes EVERY frame of a block via
// the recurrence, seeded with the previous block's last locked phases, so
// the host PV can stream bounded-memory frame blocks instead of
// materializing media-length (C, F, BINS) temporaries (the measured
// memory-bound regime, PERF.md round 4).
//   phase_a, mag:   (C, F, BINS) this block's analysis phases/magnitudes
//   inst_over_rate: (C, F, BINS) - entry k is the increment from frame
//                   k-1 (the carry frame for k=0)
//   init_locked:    (C, BINS) locked phases of the frame before the block
//   phases (out):   (C, F, BINS)
// Identical arithmetic to pv_phase_lock's steady-state loop.
int pv_phase_lock_carry(const float* phase_a, const float* mag,
                        const float* inst_over_rate,
                        const float* init_locked, int64_t c, int64_t f,
                        int64_t bins, float* phases) {
  if (f < 1 || bins < 2) return 1;
  std::vector<float> rot(static_cast<size_t>(bins));
  for (int64_t ch = 0; ch < c; ++ch) {
    const float* pa = phase_a + ch * f * bins;
    const float* mg = mag + ch * f * bins;
    const float* io = inst_over_rate + ch * f * bins;
    float* out = phases + ch * f * bins;
    const float* prev = init_locked + ch * bins;
    for (int64_t k = 0; k < f; ++k) {
      const float* pak = pa + k * bins;
      const float* mgk = mg + k * bins;
      const float* iok = io + k * bins;
      float* cur = out + k * bins;
      for (int64_t b = 0; b < bins; ++b)
        rot[static_cast<size_t>(b)] = prev[b] + iok[b] - pak[b];
      for (int64_t b = 0; b < bins; ++b) {
        const float m = mgk[b];
        const float lm = b > 0 ? mgk[b - 1] : 0.f;
        const float rm = b + 1 < bins ? mgk[b + 1] : 0.f;
        float r = rot[static_cast<size_t>(b)];
        if (lm > m && lm > rm) {
          r = rot[static_cast<size_t>(b - 1)];
        } else if (rm > m) {
          r = rot[static_cast<size_t>(b + 1)];
        }
        cur[b] = pak[b] + r;
      }
      prev = cur;
    }
  }
  return 0;
}

// Quadratic (3-point Lagrange) resampler - native twin of
// stretch/resample.py::_resample_host (the reference's pitch-shifting
// interpolation semantics, describealign.py:233-244/412-414: f64 sample
// positions, f32 Lagrange weighting, f16-grid write-back). Bit-equal to
// the numpy twin: products/sums are explicit temporaries (no FMA
// contraction in the combine), std::nearbyint matches np.round's
// half-to-even, f16_grid matches astype(f16).astype(f32). The numpy
// path's 3 media-length fancy-index gathers plus broadcast multiplies
// measure ~10 s per 5-minute stereo segment on the 1-core bench host;
// this single pass with sequential-locality loads runs the same segment
// in well under a second.
//   x: (c, n) f32 channel-major; out: (c, num_out) f32. Returns 0.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
int resample_quad(const float* x, int64_t c, int64_t n, double x_start,
                  double x_end, int64_t num_out, float* out) {
  if (c < 1 || n < 3 || num_out < 1) return 1;
  const double step = (x_end - x_start) / static_cast<double>(num_out);
  const double bmax = static_cast<double>(n - 2);
  for (int64_t ch = 0; ch < c; ++ch) {
    const float* xc = x + ch * n;
    float* oc = out + ch * num_out;
    for (int64_t i = 0; i < num_out; ++i) {
      const double si = step * static_cast<double>(i);
      const double p = x_start + si;
      double b = std::nearbyint(p);
      if (b < 1.0) b = 1.0;
      if (b > bmax) b = bmax;
      const int64_t bi = static_cast<int64_t>(b);
      const float t = static_cast<float>(p - b);
      const float th = 0.5f * t;
      const float w_m1 = th * (t - 1.0f);
      const float w_0 = (1.0f - t) * (1.0f + t);
      const float w_p1 = th * (t + 1.0f);
      const float p0 = w_m1 * xc[bi - 1];
      const float p1 = w_0 * xc[bi];
      const float p2 = w_p1 * xc[bi + 1];
      const float s01 = p0 + p1;
      oc[i] = f16_grid(s01 + p2);
    }
  }
  return 0;
}
#pragma GCC pop_options

// np.convolve twin for the continuity/compression stages (f64 path data).
//   np_mode: 0 = 'valid' (out length n-t+1), 1 = 'same' (out length n,
//   zero-padded edges). Tap-major shift-and-add: each tap is one
//   contiguous auto-vectorizable pass with a deterministic per-tap order.
//   numpy's correlate loop runs ~1 f64 FLOP/cycle; this reaches the FMA
//   ports (~4x on the 2.1 GHz host for the 19/41-tap path kernels).
// Returns 0 on success.
int conv_f64(const double* x, int64_t n, const double* taps, int64_t t,
             int np_mode, double* out) {
  if (t < 1 || n < t) return 1;
  // full-conv index j = i + shift: out[i] = sum_m taps[m] * x[i+shift-m].
  // Output-blocked so the accumulator block lives in L1 across the tap
  // loop (a whole-array tap-major sweep is out-RMW-bound: t passes over a
  // media-length f64 array measure SLOWER than numpy's scalar loop).
  const int64_t shift = np_mode ? (t - 1) / 2 : (t - 1);
  const int64_t m_out = np_mode ? n : (n - t + 1);
  const int64_t BLK = 2048;
  for (int64_t b0 = 0; b0 < m_out; b0 += BLK) {
    const int64_t b1 = (b0 + BLK < m_out) ? (b0 + BLK) : m_out;
    for (int64_t i = b0; i < b1; ++i) out[i] = 0.0;
    for (int64_t m = 0; m < t; ++m) {
      const double w = taps[m];
      int64_t lo = (m - shift > b0) ? (m - shift) : b0;
      int64_t hi = (n + m - shift < b1) ? (n + m - shift) : b1;
      const double* xs = x + (shift - m);
      for (int64_t i = lo; i < hi; ++i) out[i] += w * xs[i];
    }
  }
  return 0;
}

// Least-squares gain rescale of one feature-stream pair (the semantics of
// reference describealign.py:733-741 as used by alignment/api.py):
//   scale = <vf[yi], af[xi]> / max(<vf[yi], vf[yi]>, 1e-30)
//   sd    = np.std(af)  (two-pass, f64)
//   audio_out[k*stride] = (float)(af[k] / sd)           for k < na
//   video_out[k*stride] = (float)(vf[k] * (scale/sd))   for k < nv
// Sources are the f32 feature rows (promoted per element, exact); all
// accumulation is f64 in 4 independent chains - deterministic, and within
// f64 reassociation noise of numpy's pairwise sums / BLAS ddot, which
// vanishes in the f32 round of the outputs. Replaces ~8 media-length
// numpy array passes per stream (astype copies, fancy-index gathers,
// divide, multiply, astype) with one gather pass + two output passes.
int rescale_feature(const float* vf, int64_t nv, const float* af, int64_t na,
                    const int64_t* yi, const int64_t* xi, int64_t npath,
                    float* audio_out, float* video_out, int64_t stride) {
  if (nv < 1 || na < 1 || npath < 0 || stride < 1) return 1;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  int64_t k = 0;
  for (; k + 4 <= na; k += 4) {
    s[0] += af[k];
    s[1] += af[k + 1];
    s[2] += af[k + 2];
    s[3] += af[k + 3];
  }
  double mean = (s[0] + s[1]) + (s[2] + s[3]);
  for (; k < na; ++k) mean += af[k];
  mean /= static_cast<double>(na);
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  for (k = 0; k + 4 <= na; k += 4) {
    const double d0 = af[k] - mean, d1 = af[k + 1] - mean;
    const double d2 = af[k + 2] - mean, d3 = af[k + 3] - mean;
    v[0] += d0 * d0;
    v[1] += d1 * d1;
    v[2] += d2 * d2;
    v[3] += d3 * d3;
  }
  double var = (v[0] + v[1]) + (v[2] + v[3]);
  for (; k < na; ++k) {
    const double d = af[k] - mean;
    var += d * d;
  }
  const double sd = std::sqrt(var / static_cast<double>(na));

  double num[4] = {0.0, 0.0, 0.0, 0.0};
  double den[4] = {0.0, 0.0, 0.0, 0.0};
  int64_t t = 0;
  for (; t + 4 <= npath; t += 4) {
    for (int u = 0; u < 4; ++u) {
      const int64_t y = yi[t + u], x = xi[t + u];
      if (y < 0 || y >= nv || x < 0 || x >= na) return 2;
      const double vy = vf[y];
      num[u] += vy * static_cast<double>(af[x]);
      den[u] += vy * vy;
    }
  }
  double dnum = (num[0] + num[1]) + (num[2] + num[3]);
  double dden = (den[0] + den[1]) + (den[2] + den[3]);
  for (; t < npath; ++t) {
    const int64_t y = yi[t], x = xi[t];
    if (y < 0 || y >= nv || x < 0 || x >= na) return 2;
    const double vy = vf[y];
    dnum += vy * static_cast<double>(af[x]);
    dden += vy * vy;
  }
  const double scale = dnum / ((dden > 1e-30) ? dden : 1e-30);

  // numpy divides per element (af / af_std); keep the division so the
  // f64 value matches numpy's bit-for-bit before the f32 round
  for (k = 0; k < na; ++k)
    audio_out[k * stride] =
        static_cast<float>(static_cast<double>(af[k]) / sd);
  const double q = scale / sd;
  for (k = 0; k < nv; ++k)
    video_out[k * stride] =
        static_cast<float>(static_cast<double>(vf[k]) * q);
  return 0;
}

// Python round(v, 6) twin for the pass-2 cluster keys: correctly-rounded
// decimal rounding, half-to-even on exact decimal ties - semantics that
// np.round's scale-multiply-round does NOT guarantee (glibc's %.6f and
// strtod are both correctly rounded, so format+parse reproduces
// CPython's dtoa-based round exactly). Values too large for 6 decimals
// to matter (spacing > 1e-6 at |v| >= ~4.5e9) and non-finite values pass
// through, as in Python. Replaces a ~22k-call/pair Python round() loop.
// The format+parse pair runs under a pinned "C" locale: a host app (the
// wx GUI sets the process locale from the environment on some platforms)
// could otherwise switch LC_NUMERIC to a comma-decimal locale, making
// snprintf emit "0,998700" and strtod parse just "0" - silently
// collapsing every cluster key. uselocale is per-thread and cheap.
int round_decimals6_f64(const double* v, int64_t n, double* out) {
  static const locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  const locale_t prev = c_loc ? uselocale(c_loc) : (locale_t)0;
  char buf[64];
  for (int64_t i = 0; i < n; ++i) {
    const double x = v[i];
    if (!(std::fabs(x) < 1e12)) { out[i] = x; continue; }
    std::snprintf(buf, sizeof buf, "%.6f", x);
    out[i] = std::strtod(buf, nullptr);
  }
  if (c_loc) uselocale(prev);
  return 0;
}

}  // extern "C"

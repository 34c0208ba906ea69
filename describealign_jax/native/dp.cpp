// Native host dynamic programs for describealign-jax.
//
// The device handles the dense matching; these two irregular, data-dependent DPs
// run on the host and must keep up with device throughput:
//
// 1. weighted_lis: maximal-weight monotone chain over match candidates
//    (semantics of reference describealign.py:654-699, SortedList variant).
// 2. refine_dp: pass-2 cluster-switch DP over per-frame candidate points
//    (semantics of reference describealign.py:946-983).
//
// Both use ordered std::map/std::multimap keyed by video position; every
// candidate inserts once and is erased at most once => O(n log n).

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>
#include <map>
#include <vector>

namespace {

// Monotone frontier over small-integer keys for the weighted LIS.
//
// The multimap frontier's semantics (upper_bound / last-entry-<=-key /
// erase-dominated-successors, with equal keys kept in insertion order and
// queries always hitting the NEWEST equal-key entry) collapse, for integer
// keys bounded by the video length, to one-entry-per-key arrays with
// last-writer-wins plus a 3-level bitmap for predecessor/successor scans.
// Every operation is a handful of word ops on flat memory instead of a
// red-black-tree walk + node allocation: ~8x faster at the 10^6-candidate
// scale the matcher emits on self-similar media.
//
// Equivalence argument for one-entry-per-key: in the multimap, an entry
// inserted at key v with hint-after-equal-keys shadows every older entry
// at v for all future upper_bound(v')/prev queries (v' >= v reaches only
// the newest), the erase scan starts strictly after key v (old equal-key
// entries are never re-exposed), and the final best.rbegin() also sees
// only the newest at the max key. So older same-key entries are
// unobservable; overwriting them is exact.
struct BitFrontier {
  int64_t cap;                       // keys in [0, cap)
  std::vector<uint64_t> l0, l1, l2;  // l0 bit k = key k occupied
  std::vector<double> cum;
  // node ids fit i32 (candidate count is bounded far below 2^31); the
  // narrower array keeps more of the latency-bound frontier in cache
  std::vector<int32_t> node;

  explicit BitFrontier(int64_t cap_) : cap(cap_) {
    const int64_t n0 = (cap + 63) / 64;
    const int64_t n1 = (n0 + 63) / 64;
    const int64_t n2 = (n1 + 63) / 64;
    l0.assign(static_cast<size_t>(n0), 0);
    l1.assign(static_cast<size_t>(n1), 0);
    l2.assign(static_cast<size_t>(n2), 0);
    cum.resize(static_cast<size_t>(cap));
    node.resize(static_cast<size_t>(cap));
  }

  inline void set(int64_t k, double c, int64_t nd) {
    cum[static_cast<size_t>(k)] = c;
    node[static_cast<size_t>(k)] = static_cast<int32_t>(nd);
    l0[static_cast<size_t>(k >> 6)] |= 1ull << (k & 63);
    l1[static_cast<size_t>(k >> 12)] |= 1ull << ((k >> 6) & 63);
    l2[static_cast<size_t>(k >> 18)] |= 1ull << ((k >> 12) & 63);
  }

  inline void clear(int64_t k) {
    uint64_t& w0 = l0[static_cast<size_t>(k >> 6)];
    w0 &= ~(1ull << (k & 63));
    if (w0) return;
    uint64_t& w1 = l1[static_cast<size_t>(k >> 12)];
    w1 &= ~(1ull << ((k >> 6) & 63));
    if (w1) return;
    l2[static_cast<size_t>(k >> 18)] &= ~(1ull << ((k >> 12) & 63));
  }

  // highest occupied key <= k, or -1 if none
  inline int64_t pred(int64_t k) const {
    int64_t w = k >> 6;
    uint64_t bits = l0[static_cast<size_t>(w)]
                    & (~0ull >> (63 - (k & 63)));
    if (bits) return (w << 6) + 63 - __builtin_clzll(bits);
    int64_t w1 = w >> 6;
    uint64_t b1 = (w & 63)
        ? l1[static_cast<size_t>(w1)] & (~0ull >> (64 - (w & 63)))
        : 0;
    if (!b1) {
      int64_t w2 = w1 >> 6;
      uint64_t b2 = (w1 & 63)
          ? l2[static_cast<size_t>(w2)] & (~0ull >> (64 - (w1 & 63)))
          : 0;
      while (!b2) {
        if (--w2 < 0) return -1;
        b2 = l2[static_cast<size_t>(w2)];
      }
      w1 = (w2 << 6) + 63 - __builtin_clzll(b2);
      b1 = l1[static_cast<size_t>(w1)];
    }
    w = (w1 << 6) + 63 - __builtin_clzll(b1);
    bits = l0[static_cast<size_t>(w)];
    return (w << 6) + 63 - __builtin_clzll(bits);
  }

  // lowest occupied key > k, or -1 if none
  inline int64_t succ(int64_t k) const {
    if (k + 1 >= cap) return -1;
    int64_t w = (k + 1) >> 6;
    uint64_t bits = l0[static_cast<size_t>(w)] & (~0ull << ((k + 1) & 63));
    if (bits) return (w << 6) + __builtin_ctzll(bits);
    const int64_t w1p = w + 1;
    int64_t w1 = w1p >> 6;
    if (w1 >= static_cast<int64_t>(l1.size())) return -1;
    uint64_t b1 = l1[static_cast<size_t>(w1)] & (~0ull << (w1p & 63));
    if (!b1) {
      const int64_t w2p = w1 + 1;
      int64_t w2 = w2p >> 6;
      if (w2 >= static_cast<int64_t>(l2.size())) return -1;
      uint64_t b2 = l2[static_cast<size_t>(w2)] & (~0ull << (w2p & 63));
      while (!b2) {
        if (++w2 >= static_cast<int64_t>(l2.size())) return -1;
        b2 = l2[static_cast<size_t>(w2)];
      }
      w1 = (w2 << 6) + __builtin_ctzll(b2);
      b1 = l1[static_cast<size_t>(w1)];
    }
    w = (w1 << 6) + __builtin_ctzll(b1);
    bits = l0[static_cast<size_t>(w)];
    return (w << 6) + __builtin_ctzll(bits);
  }

  // highest occupied key overall, or -1 if empty
  inline int64_t last() const {
    for (int64_t w2 = static_cast<int64_t>(l2.size()) - 1; w2 >= 0; --w2) {
      if (!l2[static_cast<size_t>(w2)]) continue;
      const int64_t w1 =
          (w2 << 6) + 63 - __builtin_clzll(l2[static_cast<size_t>(w2)]);
      const int64_t w =
          (w1 << 6) + 63 - __builtin_clzll(l1[static_cast<size_t>(w1)]);
      return (w << 6) + 63 - __builtin_clzll(l0[static_cast<size_t>(w)]);
    }
    return -1;
  }
};

// Streaming weighted-LIS context: chunks of matcher output (in audio
// order) feed one frontier, so the host DP can run while later chunks are
// still computing on the device or in flight to the host.
struct LisStream {
  // 12 B/node: v < 2^28 (the frontier key cap), a and prev bounded far
  // below 2^31 - half the push_back traffic of the i64 triple at the
  // ~2M-candidate media scale
  struct Node { int32_t v, a, prev; };
  std::vector<Node> nodes;
  BitFrontier best;
  explicit LisStream(int64_t cap) : best(cap) {
    nodes.reserve(1 << 20);
    nodes.push_back({-1, -1, -1});  // sentinel
    best.set(0, 0.0, 0);
  }
};

// 8 B/candidate: v < 2^28 (frontier cap) and q is a decoded f16-grid
// value, exact in f32 (the f64 chain sums promote losslessly), so the
// per-frame insertion sort shuffles half the bytes
struct Cand { int32_t v; float q; };

// insert into a (v, q)-ascending insertion-sorted candidate array
inline void cand_add(Cand* cands, int& m, int64_t v, double q) {
  Cand c{static_cast<int32_t>(v), static_cast<float>(q)};
  int p = m++;
  while (p > 0 && (cands[p - 1].v > c.v ||
                   (cands[p - 1].v == c.v && cands[p - 1].q > c.q))) {
    cands[p] = cands[p - 1];
    --p;
  }
  cands[p] = c;
}

// Process one audio frame's sorted candidates against the frontier
// (shared core of every feed variant): exact duplicates collapse to one,
// each survivor extends the best chain ending at-or-before its video key
// and erases dominated successors. Returns false if a key falls outside
// the frontier capacity.
inline bool lis_frame(LisStream& st, const Cand* cands, int m, int64_t a) {
  BitFrontier& best = st.best;
  const int64_t cap = best.cap;
  if (a > 0x7fffffff) return false;  // i32 node fields (≈2840 h of audio)
  // the frontier's cum/node/l0 arrays are several MB at media scale, so
  // each candidate's pred/succ walk is LLC-latency-bound; issuing all of
  // the frame's lookups up front shaves a few % on the production-shaped
  // microbench (scripts/bench_lis.py). The walk itself is a true serial
  // chain (a candidate's set/erase can change the next one's pred), so
  // the remaining latency is not overlappable without changing the
  // frame-sequencing semantics.
  for (int t = 0; t < m; ++t) {
    const int64_t key = cands[t].v + 1;
    if (key >= 1 && key < cap) {
      __builtin_prefetch(&best.cum[static_cast<size_t>(key)]);
      __builtin_prefetch(&best.node[static_cast<size_t>(key)]);
      __builtin_prefetch(&best.l0[static_cast<size_t>(key >> 6)]);
    }
  }
  for (int t = 0; t < m; ++t) {
    if (t > 0 && cands[t].v == cands[t - 1].v
        && cands[t].q == cands[t - 1].q) {
      continue;
    }
    const int64_t v = cands[t].v;
    const int64_t key = v + 1;
    if (key < 1 || key >= cap) return false;
    const int64_t pk = best.pred(key);
    const double cum = best.cum[static_cast<size_t>(pk)] + cands[t].q;
    const int64_t prev_node = best.node[static_cast<size_t>(pk)];
    for (int64_t sk = best.succ(key); sk >= 0; ) {
      if (best.cum[static_cast<size_t>(sk)] > cum) break;
      const int64_t nxt = best.succ(sk);
      best.clear(sk);
      sk = nxt;
    }
    st.nodes.push_back({static_cast<int32_t>(v), static_cast<int32_t>(a),
                        static_cast<int32_t>(prev_node)});
    best.set(key, cum, static_cast<int64_t>(st.nodes.size()) - 1);
  }
  return true;
}

// u8-coded qualities: code 0 = empty; else the f16 bit pattern is
// (code + 0xA0) << 6 (a 6-bit-truncated f16 grid covering the quality
// range (0.033, 50]; pure bit math so device and host decode identically,
// bit-for-bit). Matches matching.py's _qual_quantize/_qual_dequantize.
inline const float* qual_u8_table() {
  static float table[256];
  static const bool init = [] {
    for (int c = 0; c < 256; ++c) {
      if (c == 0) {
        table[c] = 0.f;
        continue;
      }
      const uint32_t bits16 = (static_cast<uint32_t>(c) + 0xA0u) << 6;
      // normal-range f16 -> f32 (the grid's exponents are all normal)
      const uint32_t e = (bits16 >> 10) & 0x1Fu;
      const uint32_t mant = bits16 & 0x3FFu;
      const uint32_t b32 = ((e + 112u) << 23) | (mant << 13);
      std::memcpy(&table[c], &b32, 4);
    }
    return true;
  }();
  (void)init;
  return table;
}

}  // namespace

extern "C" {

// --------------------------------------------------------------------------
// weighted LIS
// --------------------------------------------------------------------------
// Inputs sorted by (audio, video, qual). Outputs the chain in increasing
// order as (video, audio) pairs. Returns 0 on success.
int weighted_lis(const int64_t* video_idx, const int64_t* audio_idx,
                 const double* qual, int64_t n,
                 int64_t* out_video, int64_t* out_audio, int64_t* out_len) {
  struct Node { int64_t v, a; int64_t prev; };
  std::vector<Node> nodes;
  nodes.reserve(static_cast<size_t>(n) + 1);
  nodes.push_back({-1, -1, -1});  // sentinel

  struct Entry { double cum; int64_t node; };
  // key: video index; equal keys keep insertion order (multimap guarantees
  // insertion order among equivalent keys since C++11)
  std::multimap<int64_t, Entry> best;
  best.insert({-1, {0.0, 0}});

  for (int64_t t = 0; t < n; ++t) {
    const int64_t v = video_idx[t];
    const int64_t a = audio_idx[t];
    auto it = best.upper_bound(v);  // first entry with key > v
    auto prev = std::prev(it);     // last entry with key <= v (sentinel safe)
    const double cum = prev->second.cum + qual[t];
    const int64_t prev_node = prev->second.node;
    while (it != best.end() && it->second.cum <= cum) {
      it = best.erase(it);
    }
    nodes.push_back({v, a, prev_node});
    best.insert(it, {v, {cum, static_cast<int64_t>(nodes.size()) - 1}});
    // note: 'it' is a valid hint at-or-after the insertion point; multimap
    // inserts as close to the hint as ordering allows (after equal keys)
  }

  // walk back from the overall best (last entry has the max cum by invariant)
  int64_t cur = best.rbegin()->second.node;
  int64_t m = 0;
  while (cur != 0) {  // stop at sentinel
    out_video[m] = nodes[cur].v;
    out_audio[m] = nodes[cur].a;
    ++m;
    cur = nodes[cur].prev;
  }
  // reverse in place
  for (int64_t i = 0; i < m / 2; ++i) {
    std::swap(out_video[i], out_video[m - 1 - i]);
    std::swap(out_audio[i], out_audio[m - 1 - i]);
  }
  *out_len = m;
  return 0;
}

// Fused flatten + sort + weighted LIS straight off the device matcher's
// compressed output. quals: (nb, blk, k) f32 with 0 marking empty slots;
// voffs: (nb, blk, k) int16 video offsets within a search band; starts:
// (nb, n_groups) int32 band start frames - slot j belongs to band
// j / (k / n_groups), and its video frame is starts[b][group] + voff.
// The audio frame of slot (b, l, *) is b*blk + l, so candidates arrive
// already sorted by audio; each frame's live slots are insertion-sorted
// by (video, qual) to match the (audio, video, qual) processing order of
// weighted_lis above, and exact duplicates (overlapping bands yielding
// the same candidate) collapse to one like the reference's per-frame
// candidate sets. Outputs as in weighted_lis. Returns 0 on success.
// --- streaming API: new -> feed (chunks in audio order) -> finish -> free.
// Frontier keys are video frames shifted by +1 (sentinel v=-1 -> key 0);
// cap must exceed the largest possible video frame + 1.
void* lis_stream_new(int64_t cap) {
  // 2^28 keys = 355 hours of video at 210 fps; the frontier arrays are
  // 16 bytes/key, so this also bounds the allocation at ~4.3 GB
  if (cap < 2 || cap > (int64_t{1} << 28)) return nullptr;
  try {
    return new LisStream(cap);
  } catch (...) {
    return nullptr;  // bad_alloc must not cross the C ABI
  }
}

void lis_stream_free(void* ctx) {
  delete static_cast<LisStream*>(ctx);
}

// quals/voffs: (nb, blk, k); starts: (nb, n_groups) band starts for THIS
// chunk; a_base: absolute audio frame of the chunk's first row.
int lis_stream_feed(void* ctx, const float* quals, const int16_t* voffs,
                    const int32_t* starts, int64_t nb, int64_t blk,
                    int64_t k, int64_t n_groups, int64_t a_base) {
  if (!ctx || k > 64 || n_groups < 1 || k % n_groups != 0) return 1;
  LisStream& st = *static_cast<LisStream*>(ctx);
  const int64_t k_per_group = k / n_groups;
  Cand cands[64];
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* base = starts + b * n_groups;
    for (int64_t l = 0; l < blk; ++l) {
      const float* qrow = quals + (b * blk + l) * k;
      const int16_t* vrow = voffs + (b * blk + l) * k;
      int m = 0;
      for (int64_t j = 0; j < k; ++j) {
        if (qrow[j] > 0.f)
          cand_add(cands, m, base[j / k_per_group] + vrow[j],
                   static_cast<double>(qrow[j]));
      }
      if (!lis_frame(st, cands, m, a_base + b * blk + l)) return 1;
    }
  }
  return 0;
}

// lis_stream_feed with u8-coded qualities
int lis_stream_feed_u8(void* ctx, const uint8_t* qcodes,
                       const int16_t* voffs, const int32_t* starts,
                       int64_t nb, int64_t blk, int64_t k, int64_t n_groups,
                       int64_t a_base) {
  if (!ctx || k > 64 || n_groups < 1 || k % n_groups != 0) return 1;
  const float* table = qual_u8_table();
  LisStream& st = *static_cast<LisStream*>(ctx);
  const int64_t k_per_group = k / n_groups;
  Cand cands[64];
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* base = starts + b * n_groups;
    for (int64_t l = 0; l < blk; ++l) {
      const uint8_t* qrow = qcodes + (b * blk + l) * k;
      const int16_t* vrow = voffs + (b * blk + l) * k;
      int m = 0;
      for (int64_t j = 0; j < k; ++j) {
        if (qrow[j])
          cand_add(cands, m, base[j / k_per_group] + vrow[j],
                   static_cast<double>(table[qrow[j]]));
      }
      if (!lis_frame(st, cands, m, a_base + b * blk + l)) return 1;
    }
  }
  return 0;
}

// lis_stream_feed with the split transport layout: band-1 slots (k1,
// groups 0..1) arrive for every frame; rescue slots (k2, groups 2..)
// arrive only for EVEN frames (they are zero on odd frames by
// construction - the rescue bands sample every 2nd frame), at rows
// l/2 of the half-height q2/o2 arrays. Semantics identical to feeding
// the full-rate arrays with odd-frame rescue slots zeroed.
int lis_stream_feed_split(void* ctx, const uint8_t* q1, const int16_t* o1,
                          const uint8_t* q2, const int16_t* o2,
                          const int32_t* starts, int64_t nb, int64_t blk,
                          int64_t k1, int64_t k2, int64_t n_groups,
                          int64_t a_base) {
  if (!ctx || k1 + k2 > 64 || n_groups < 2 || k1 % 2 != 0) return 1;
  if (blk % 2 != 0) return 1;               // q2/o2 rows are blk/2-high
  if (n_groups == 2 ? k2 != 0 : k2 % (n_groups - 2) != 0) return 1;
  const float* table = qual_u8_table();
  LisStream& st = *static_cast<LisStream*>(ctx);
  const int64_t k1_per_group = k1 / 2;
  const int64_t k2_per_group =
      (n_groups > 2) ? k2 / (n_groups - 2) : k2;
  Cand cands[64];
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* base = starts + b * n_groups;
    for (int64_t l = 0; l < blk; ++l) {
      int m = 0;
      const uint8_t* q1row = q1 + (b * blk + l) * k1;
      const int16_t* o1row = o1 + (b * blk + l) * k1;
      for (int64_t j = 0; j < k1; ++j) {
        if (q1row[j])
          cand_add(cands, m, base[j / k1_per_group] + o1row[j],
                   static_cast<double>(table[q1row[j]]));
      }
      if ((l & 1) == 0 && k2 > 0) {
        const uint8_t* q2row = q2 + (b * (blk / 2) + l / 2) * k2;
        const int16_t* o2row = o2 + (b * (blk / 2) + l / 2) * k2;
        for (int64_t j = 0; j < k2; ++j) {
          if (q2row[j])
            cand_add(cands, m, base[2 + j / k2_per_group] + o2row[j],
                     static_cast<double>(table[q2row[j]]));
        }
      }
      if (!lis_frame(st, cands, m, a_base + b * blk + l)) return 1;
    }
  }
  return 0;
}

// lis_stream_feed straight off the device chunk's packed int16 transport
// buffer (matching._pack_slots' layout), so the host feeds chunks with
// ZERO intermediate copies. Per block row: band-1 frames at full rate,
// then rescue rows for even frames only. Each row of k slots is laid out
// as k u8 quality codes, k u8 offset LOW bytes, then k/4 high-bit bytes
// (2 bits per slot: slot j in byte j/4 at bit 2*(j%4)) padded to an even
// byte count - the in-band offsets span [0, 767], i.e. 10 bits. Byte
// order matches the device's u8->i16 bitcast as materialized on the
// (little-endian) host; semantics identical to lis_stream_feed_split on
// the unpacked arrays.
namespace {
inline int64_t packed_row_words(int64_t k) {
  return k / 2 + k / 2 + (k / 4 + 1) / 2;
}
}  // namespace

int lis_stream_feed_packed_strided(void* ctx, const int16_t* packed,
                                   int64_t row_stride_words,
                                   const int32_t* starts, int64_t nb,
                                   int64_t blk, int64_t k1, int64_t k2,
                                   int64_t n_groups, int64_t a_base) {
  if (!ctx || k1 + k2 > 64 || n_groups < 2 || k1 % 4 != 0 || k2 % 4 != 0)
    return 1;
  if (blk % 2 != 0) return 1;
  if (n_groups == 2 ? k2 != 0 : k2 % (n_groups - 2) != 0) return 1;
  const float* table = qual_u8_table();
  LisStream& st = *static_cast<LisStream*>(ctx);
  const int64_t k1_per_group = k1 / 2;
  const int64_t k2_per_group = (n_groups > 2) ? k2 / (n_groups - 2) : k2;
  const int64_t row1 = packed_row_words(k1);
  const int64_t row2 = packed_row_words(k2);
  const int64_t n1 = blk * row1;             // band-1 words per block
  const int64_t rowlen = n1 + (blk / 2) * row2;
  if (row_stride_words < rowlen) return 1;
  Cand cands[64];
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* base = starts + b * n_groups;
    const int16_t* prow = packed + b * row_stride_words;
    for (int64_t l = 0; l < blk; ++l) {
      int m = 0;
      const uint8_t* f1 =
          reinterpret_cast<const uint8_t*>(prow + l * row1);
      const uint8_t* lo1 = f1 + k1;
      const uint8_t* hi1 = f1 + 2 * k1;
      for (int64_t j = 0; j < k1; ++j) {
        if (f1[j]) {
          const int64_t off = lo1[j]
              | ((static_cast<int64_t>(hi1[j >> 2] >> (2 * (j & 3))) & 3)
                 << 8);
          cand_add(cands, m, base[j / k1_per_group] + off,
                   static_cast<double>(table[f1[j]]));
        }
      }
      if ((l & 1) == 0 && k2 > 0) {
        const uint8_t* f2 = reinterpret_cast<const uint8_t*>(
            prow + n1 + (l / 2) * row2);
        const uint8_t* lo2 = f2 + k2;
        const uint8_t* hi2 = f2 + 2 * k2;
        for (int64_t j = 0; j < k2; ++j) {
          if (f2[j]) {
            const int64_t off = lo2[j]
                | ((static_cast<int64_t>(hi2[j >> 2] >> (2 * (j & 3))) & 3)
                   << 8);
            cand_add(cands, m, base[2 + j / k2_per_group] + off,
                     static_cast<double>(table[f2[j]]));
          }
        }
      }
      if (!lis_frame(st, cands, m, a_base + b * blk + l)) return 1;
    }
  }
  return 0;
}

// contiguous-row convenience wrapper (rows exactly rowlen words apart)
int lis_stream_feed_packed(void* ctx, const int16_t* packed,
                           const int32_t* starts, int64_t nb, int64_t blk,
                           int64_t k1, int64_t k2, int64_t n_groups,
                           int64_t a_base) {
  const int64_t rowlen = blk * packed_row_words(k1)
                         + (blk / 2) * packed_row_words(k2);
  return lis_stream_feed_packed_strided(ctx, packed, rowlen, starts, nb,
                                        blk, k1, k2, n_groups, a_base);
}

// Feed from the COMPACT batch transport (matching.concat_chunks_compact):
// per-frame counts (c1 | c2 << 4; rescue counts on even frames only) and
// live-prefix slot planes - codes/lo bytes plus globally packed 2-bit
// offset highs (slot p's highs in byte p/4 at bit 2*(p%4)). Band-1 slots
// use band start group 0 (the two band-1 half-groups always share one
// start - asserted by the python caller) and rescue slots group 2, so
// n_groups must be 3 (the production N_TRACKS=2 shape). Semantics
// identical to lis_stream_feed_packed on the dense buffer.
int lis_stream_feed_compact(void* ctx, const uint8_t* counts,
                            const uint8_t* codes1, const uint8_t* lo1,
                            const uint8_t* hi1, int64_t budget1,
                            const uint8_t* codes2, const uint8_t* lo2,
                            const uint8_t* hi2, int64_t budget2,
                            const int32_t* starts, int64_t nb, int64_t blk,
                            int64_t n_groups, int64_t a_base) {
  if (!ctx || n_groups != 3 || blk % 2 != 0) return 1;
  const float* table = qual_u8_table();
  LisStream& st = *static_cast<LisStream*>(ctx);
  Cand cands[64];
  int64_t p1 = 0, p2 = 0;
  for (int64_t b = 0; b < nb; ++b) {
    const int32_t* base = starts + b * n_groups;
    for (int64_t l = 0; l < blk; ++l) {
      const uint8_t cb = counts[b * blk + l];
      const int c1 = cb & 15;
      const int c2 = cb >> 4;
      if (p1 + c1 > budget1 || p2 + c2 > budget2) return 2;
      if ((l & 1) && c2) return 3;        // odd frames carry no rescue
      int m = 0;
      for (int j = 0; j < c1; ++j, ++p1) {
        const int64_t off = lo1[p1]
            | ((static_cast<int64_t>(hi1[p1 >> 2] >> (2 * (p1 & 3))) & 3)
               << 8);
        cand_add(cands, m, base[0] + off,
                 static_cast<double>(table[codes1[p1]]));
      }
      for (int j = 0; j < c2; ++j, ++p2) {
        const int64_t off = lo2[p2]
            | ((static_cast<int64_t>(hi2[p2 >> 2] >> (2 * (p2 & 3))) & 3)
               << 8);
        cand_add(cands, m, base[2] + off,
                 static_cast<double>(table[codes2[p2]]));
      }
      if (!lis_frame(st, cands, m, a_base + b * blk + l)) return 1;
    }
  }
  return 0;
}

// number of candidates inserted so far (an upper bound on the path length,
// for sizing the finish() output buffers)
int64_t lis_stream_count(void* ctx) {
  return static_cast<int64_t>(static_cast<LisStream*>(ctx)->nodes.size()) - 1;
}

int lis_stream_finish(void* ctx, int64_t* out_video, int64_t* out_audio,
                      int64_t* out_len) {
  if (!ctx) return 1;
  LisStream& st = *static_cast<LisStream*>(ctx);
  int64_t cur = st.best.node[static_cast<size_t>(st.best.last())];
  int64_t m = 0;
  while (cur != 0) {
    out_video[m] = st.nodes[static_cast<size_t>(cur)].v;
    out_audio[m] = st.nodes[static_cast<size_t>(cur)].a;
    ++m;
    cur = st.nodes[static_cast<size_t>(cur)].prev;
  }
  for (int64_t i = 0; i < m / 2; ++i) {
    std::swap(out_video[i], out_video[m - 1 - i]);
    std::swap(out_audio[i], out_audio[m - 1 - i]);
  }
  *out_len = m;
  return 0;
}

int lis_from_match(const float* quals, const int16_t* voffs,
                   const int32_t* starts, int64_t nb, int64_t blk,
                   int64_t k, int64_t n_groups,
                   int64_t* out_video, int64_t* out_audio, int64_t* out_len) {
  // single-shot wrapper over the streaming API
  int64_t max_start = 0;
  for (int64_t i = 0; i < nb * n_groups; ++i) {
    if (starts[i] > max_start) max_start = starts[i];
  }
  void* ctx = lis_stream_new(max_start + 32767 + 2);
  if (!ctx) return 1;
  int rc = lis_stream_feed(ctx, quals, voffs, starts, nb, blk, k, n_groups,
                           0);
  if (rc == 0) rc = lis_stream_finish(ctx, out_video, out_audio, out_len);
  lis_stream_free(ctx);
  return rc;
}

// --------------------------------------------------------------------------
// pass-2 refinement DP
// --------------------------------------------------------------------------
// points are flattened per audio frame: for frame i, entries
// [offsets[i], offsets[i+1]) of (pj, pc, pq) = (video pos, cluster, qual),
// sorted by (video pos, cluster, qual) within the frame.
// out_path rows: (video, audio, cluster, qual, cum_qual). Returns 0 on ok.
int refine_dp(const double* pj, const int64_t* pc, const double* pq,
              const int64_t* offsets, int64_t num_audio,
              int64_t num_clusters, int64_t num_video,
              double* out_path, int64_t* out_len) {
  const double NEG_INF = -std::numeric_limits<double>::infinity();
  struct Node5 { double j, q, cum; int32_t i, c, prev; };  // 32 B
  std::vector<Node5> nodes;
  nodes.push_back({0, 0, 0, 0, -1, -1});  // sentinel

  // jump-entry frontier keyed by video position. Only (cum, node) are
  // ever read back, so entries carry nothing else (the reference's rows
  // hold whole points; the dead fields tripled the tree's payload).
  // A flat sorted vector was tried and measured 4x SLOWER on the
  // production-shaped microbench: the frontier grows to thousands of
  // live entries on multi-cluster media, and every insert's memmove
  // beats the tree's pointer walk.
  struct Entry { double cum; int64_t node; };
  std::multimap<double, Entry> best;
  best.insert({0.0, {0.0, 0}});

  struct ClusterBest { double j, i, cum; int64_t node; };
  std::vector<ClusterBest> clusters_best(
      static_cast<size_t>(num_clusters), {0, 0, -1000, 0});

  // prev_cache[video_int] = last node placed at that integer video
  // position; node < 0 marks unset. 32 B/entry - only the fields the
  // local-jump arbitration reads (the reference's cache rows carry the
  // whole point, but only j, i, cluster, cum, node are consumed).
  struct CacheEntry { double j; double cum; int32_t i, c, node; };
  std::vector<CacheEntry> prev_cache(
      static_cast<size_t>(num_video), {0, NEG_INF, 0, 0, -1});
  prev_cache[0] = {0, 0, 0, -1, 0};

  // forward_min[i] = min video pos among points at frames >= i
  std::vector<double> forward_min(static_cast<size_t>(num_audio) + 1,
                                  std::numeric_limits<double>::infinity());
  for (int64_t i = num_audio - 1; i >= 0; --i) {
    double mn = forward_min[i + 1];
    if (offsets[i] < offsets[i + 1]) mn = std::min(mn, pj[offsets[i]]);
    forward_min[i] = mn;
  }

  for (int64_t i = 0; i < num_audio; ++i) {
    for (int64_t t = offsets[i]; t < offsets[i + 1]; ++t) {
      const double j = pj[t];
      const int64_t cluster = pc[t];
      const double q = pq[t];

      auto it = best.upper_bound(j);
      auto prev = std::prev(it);            // last entry with key <= j
      double bcum = prev->second.cum;
      int64_t bnode = prev->second.node;

      const ClusterBest& cl = clusters_best[cluster];
      if (cl.cum >= bcum) {
        bcum = cl.cum;
        bnode = cl.node;
      }
      const int64_t ji = static_cast<int64_t>(j);
      for (int64_t p = std::max<int64_t>(0, ji - 2); p <= ji; ++p) {
        const CacheEntry node = prev_cache[static_cast<size_t>(p)];
        if (node.node < 0) continue;
        double cum = node.cum;
        if (cluster != static_cast<int64_t>(node.c)) {
          const double d = (j - node.j) - static_cast<double>(i - node.i);
          cum -= 100.0 + 100.0 * d * d;
        }
        if (node.i >= (i - 2) && node.j <= j && cum >= bcum) {
          bcum = cum;
          bnode = node.node;
        }
      }

      const double cum = bcum + q;
      nodes.push_back({j, q, cum, static_cast<int32_t>(i),
                       static_cast<int32_t>(cluster),
                       static_cast<int32_t>(bnode)});
      const int64_t node_id = static_cast<int64_t>(nodes.size()) - 1;
      prev_cache[static_cast<size_t>(ji)] =
          {j, cum, static_cast<int32_t>(i), static_cast<int32_t>(cluster),
           static_cast<int32_t>(node_id)};

      // NOTE: 'prev' stays valid below: erasures start at 'it' (> prev) and
      // insertion does not invalidate multimap iterators.
      const double prev_entry_cum = prev->second.cum;
      const double cum_jump = cum - 1000.0;
      if (prev_entry_cum < cum_jump) {
        while (it != best.end() && it->second.cum <= cum_jump) {
          it = best.erase(it);
        }
        best.insert(it, {j, {cum_jump, node_id}});
      }
      if (forward_min[i] == j && prev != best.begin()) {
        // prune entries strictly before the old last-<=-j entry (reference
        // 978-979 keeps that entry plus any newly inserted jump entry)
        best.erase(best.begin(), prev);
      }
      const double cum_cluster = cum - 50.0;
      if (cl.cum < cum_cluster) {
        clusters_best[cluster] = {j, static_cast<double>(i), cum_cluster,
                                  node_id};
      }
    }
  }

  // backtrace from the entry with the highest cum (map invariant: last)
  int64_t cur = best.rbegin()->second.node;
  std::vector<int64_t> chain;
  while (cur > 0) {
    chain.push_back(cur);
    cur = nodes[cur].prev;
  }
  int64_t m = static_cast<int64_t>(chain.size());
  for (int64_t k = 0; k < m; ++k) {
    const Node5& nd = nodes[chain[m - 1 - k]];
    out_path[k * 5 + 0] = nd.j;
    out_path[k * 5 + 1] = nd.i;
    out_path[k * 5 + 2] = nd.c;
    out_path[k * 5 + 3] = nd.q;
    out_path[k * 5 + 4] = nd.cum;
  }
  *out_len = m;
  return 0;
}

// --------------------------------------------------------------------------
// exact weighted 1-D fused lasso (TV) with L2 data term
// --------------------------------------------------------------------------
//   minimize  .5*sum_i w_i (theta_i - r_i)^2 + sum_k kappa_k |theta_{k+1}-theta_k|
//
// Johnson-style dynamic programming on the message derivative: f'_k(theta)
// is non-decreasing piecewise linear; each step clips it to
// [-kappa_k, +kappa_k] (recording clip positions for backtracking) and adds
// the next quadratic's derivative w*(theta - r). The derivative is stored
// explicitly as knots (x_j, f'(x_j)) with linear tails of slopes (sl, sr).
// O(N * knots) worst case - ample for the few-thousand-node fit paths.
// Replaces the reference's scipy linprog for the fused-lasso subproblems.
int tv1d_weighted(const double* r, const double* w, const double* kappa,
                  int64_t n, double* theta) {
  if (n <= 0) return 1;
  if (n == 1) { theta[0] = r[0]; return 0; }
  std::vector<double> xs, vs;     // knots of f'
  xs.reserve(2 * n); vs.reserve(2 * n);
  xs.push_back(r[0]); vs.push_back(0.0);
  double sl = w[0], sr = w[0];    // tail slopes
  std::vector<double> clip_lo(n - 1), clip_hi(n - 1);

  for (int64_t k = 0; k < n - 1; ++k) {
    const double kap = kappa[k];
    const int64_t m = static_cast<int64_t>(xs.size());
    // --- find x_lo: f'(x_lo) = -kap ------------------------------------
    double x_lo;
    int64_t first;  // first surviving knot index
    if (vs[0] >= -kap) {
      x_lo = (sl > 0) ? xs[0] - (vs[0] + kap) / sl : xs[0];
      first = 0;
    } else {
      int64_t j = 0;
      while (j + 1 < m && vs[j + 1] < -kap) ++j;
      if (j + 1 < m) {
        const double slope = (vs[j + 1] - vs[j]) / (xs[j + 1] - xs[j]);
        x_lo = (slope > 0) ? xs[j] + (-kap - vs[j]) / slope : xs[j + 1];
        first = j + 1;
      } else {  // whole knot range below -kap; crossing in right tail
        x_lo = (sr > 0) ? xs[m - 1] + (-kap - vs[m - 1]) / sr : xs[m - 1];
        first = m;
      }
    }
    // --- find x_hi: f'(x_hi) = +kap ------------------------------------
    double x_hi;
    int64_t last;  // last surviving knot index (exclusive)
    if (vs[m - 1] <= kap) {
      x_hi = (sr > 0) ? xs[m - 1] + (kap - vs[m - 1]) / sr : xs[m - 1];
      last = m;
    } else {
      int64_t j = m - 1;
      while (j - 1 >= 0 && vs[j - 1] > kap) --j;
      if (j - 1 >= 0) {
        const double slope = (vs[j] - vs[j - 1]) / (xs[j] - xs[j - 1]);
        x_hi = (slope > 0) ? xs[j - 1] + (kap - vs[j - 1]) / slope : xs[j - 1];
        last = j;
      } else {  // whole knot range above kap; crossing in left tail
        x_hi = (sl > 0) ? xs[0] - (vs[0] - kap) / sl : xs[0];
        last = 0;
      }
    }
    if (x_hi < x_lo) x_hi = x_lo;  // degenerate (kap == 0): single point
    clip_lo[k] = x_lo;
    clip_hi[k] = x_hi;

    // --- rebuild clipped f' + add w_{k+1} (theta - r_{k+1}) -------------
    const double wn = w[k + 1];
    const double rn = r[k + 1];
    std::vector<double> nxs, nvs;
    nxs.reserve(last - first + 2);
    nvs.reserve(last - first + 2);
    nxs.push_back(x_lo);
    nvs.push_back(-kap + wn * (x_lo - rn));
    for (int64_t j = first; j < last; ++j) {
      if (xs[j] > x_lo && xs[j] < x_hi) {
        nxs.push_back(xs[j]);
        nvs.push_back(vs[j] + wn * (xs[j] - rn));
      }
    }
    if (x_hi > x_lo) {
      nxs.push_back(x_hi);
      nvs.push_back(kap + wn * (x_hi - rn));
    }
    xs.swap(nxs);
    vs.swap(nvs);
    sl = wn;
    sr = wn;
  }

  // --- root of the final derivative ------------------------------------
  const int64_t m = static_cast<int64_t>(xs.size());
  double th;
  if (vs[0] >= 0) {
    th = (sl > 0) ? xs[0] - vs[0] / sl : xs[0];
  } else if (vs[m - 1] <= 0) {
    th = (sr > 0) ? xs[m - 1] - vs[m - 1] / sr : xs[m - 1];
  } else {
    int64_t j = 0;
    while (j + 1 < m && vs[j + 1] < 0) ++j;
    const double slope = (vs[j + 1] - vs[j]) / (xs[j + 1] - xs[j]);
    th = (slope > 0) ? xs[j] - vs[j] / slope : xs[j + 1];
  }
  theta[n - 1] = th;
  for (int64_t k = n - 2; k >= 0; --k) {
    th = std::min(std::max(th, clip_lo[k]), clip_hi[k]);
    theta[k] = th;
  }
  return 0;
}

// --------------------------------------------------------------------------
// per-segment position-anchored L1 slope refinement
// --------------------------------------------------------------------------
// Native twin of fit.l1_refine_segment_slopes (see its docstring for the
// model): within each fused slope-segment, split the nodes into runs at
// jump-like intervals, then IRLS-fit one common slope with free per-run L1
// intercepts (medians). The Python version pays thousands of small-array
// numpy calls when segments are many (the ~50%-similarity regime produces
// 70+ clusters); this is the same arithmetic in one pass. Medians match
// numpy exactly (partition + mean of the two mid elements); the weighted
// reductions are sequential f64 where numpy sums pairwise, so results can
// differ at ~1e-15 relative - far below the 1e-8 IRLS convergence tol and
// the ~1e-4 slope agreement the fit targets (tests/test_fit_stress.py).
//
// x, y: node coordinates (n); seg_id: per-interval segment index (n-1,
// non-decreasing); slopes: per-interval values, refined IN PLACE;
// jump_detect: interval position residual marking a run split (frames).
static double median_inplace(double* buf, int64_t m) {
  double* mid = buf + m / 2;
  std::nth_element(buf, mid, buf + m);
  if (m % 2) return *mid;
  const double lo = *std::max_element(buf, mid);
  return (lo + *mid) / 2.0;
}

int refine_segment_slopes(const double* x, const double* y,
                          int64_t n, const int64_t* seg_id,
                          double* slopes, int64_t iters,
                          double jump_detect) {
  if (n < 2) return 0;
  std::vector<int64_t> run_start, run_len;   // node-index runs (segment-local)
  std::vector<double> a, scratch;
  for (int64_t lo = 0; lo < n - 1;) {
    int64_t hi = lo + 1;
    while (hi < n - 1 && seg_id[hi] == seg_id[lo]) ++hi;
    const int64_t n_nodes = hi - lo + 1;
    if (n_nodes < 8) { lo = hi; continue; }
    double s = slopes[lo];
    // split nodes lo..hi (inclusive) into runs at jump-like intervals
    run_start.clear(); run_len.clear();
    int64_t cur_start = lo, max_len = 0;
    for (int64_t t = lo; t < hi; ++t) {
      const double xd = x[t + 1] - x[t];
      const double resid = std::abs((y[t + 1] - y[t]) / xd - s) * xd;
      if (resid > jump_detect) {
        const int64_t len = t + 1 - cur_start;
        if (len >= 2) { run_start.push_back(cur_start); run_len.push_back(len);
                        max_len = std::max(max_len, len); }
        cur_start = t + 1;
      }
    }
    {
      const int64_t len = hi + 1 - cur_start;
      if (len >= 2) { run_start.push_back(cur_start); run_len.push_back(len);
                      max_len = std::max(max_len, len); }
    }
    if (run_start.empty() || max_len < 4) { lo = hi; continue; }
    const size_t nruns = run_start.size();
    a.resize(nruns);
    scratch.resize(static_cast<size_t>(max_len));
    for (size_t j = 0; j < nruns; ++j) {
      const int64_t st = run_start[j], m = run_len[j];
      for (int64_t t = 0; t < m; ++t)
        scratch[t] = y[st + t] - s * x[st + t];
      a[j] = median_inplace(scratch.data(), m);
    }
    double s_prev = s;
    for (int64_t it = 0; it < iters; ++it) {
      double num = 0.0, den = 0.0;
      for (size_t j = 0; j < nruns; ++j) {
        const int64_t st = run_start[j], m = run_len[j];
        double sw = 0.0, sx = 0.0, sy = 0.0;
        for (int64_t t = 0; t < m; ++t) {
          const double res = y[st + t] - a[j] - s * x[st + t];
          const double w = 1.0 / std::max(std::abs(res), 1e-3);
          scratch[t] = w;
          sw += w; sx += w * x[st + t]; sy += w * y[st + t];
        }
        const double xw = sx / sw, yw = sy / sw;
        for (int64_t t = 0; t < m; ++t) {
          const double dx = x[st + t] - xw;
          num += scratch[t] * dx * (y[st + t] - yw);
          den += scratch[t] * dx * dx;
        }
      }
      if (den <= 0) break;
      s = num / den;
      for (size_t j = 0; j < nruns; ++j) {
        const int64_t st = run_start[j], m = run_len[j];
        for (int64_t t = 0; t < m; ++t)
          scratch[t] = y[st + t] - s * x[st + t];
        a[j] = median_inplace(scratch.data(), m);
      }
      if (std::abs(s - s_prev) < 1e-8) break;
      s_prev = s;
    }
    for (int64_t t = lo; t < hi; ++t) slopes[t] = s;
    lo = hi;
  }
  return 0;
}

}  // extern "C"

// --------------------------------------------------------------------------
// pass-2 cluster scoring
// --------------------------------------------------------------------------
// Vectorized twin of refine.build_points_flat's per-cluster dense scoring
// (reference describealign.py:934-944): for audio frames x in [x0, x1),
// y = slope*x + offset, the (nv, 3) scaled video features are linearly
// interpolated at y and
//   qual = sum_j (-0.5 - log10(1e-4 + |a[x,j] - v(y)_j|))
//          * clip(v(y)_0 + 2.5 - vmax, 0, 1)
//          + clip(a[x,0] + 2.5 - amax, 0, 1) * 0.1
// The three log10 terms collapse to one log10 of the product (exact in
// real arithmetic; ~1e-15 relative from the f64 rounding reorder), and
// log10 itself is a branchless atanh-series so the whole loop
// auto-vectorizes - this stage burned ~0.12 s/pair of scarce host CPU in
// numpy (transcendental-heavy) vs ~0.01 s here.

namespace {

// branchless f64 log10 for positive normals, ~1e-13 relative error
// (decision noise for the pass-2 DP whose penalties are 50..1000)
inline double log10_fast(double x) {
  uint64_t bits;
  std::memcpy(&bits, &x, 8);
  int e = static_cast<int>((bits >> 52) & 0x7FF) - 1023;
  uint64_t mbits = (bits & 0xFFFFFFFFFFFFFull) | (0x3FFull << 52);
  double m;
  std::memcpy(&m, &mbits, 8);
  const bool big = m > 1.4142135623730951;
  m = big ? m * 0.5 : m;
  e += big ? 1 : 0;
  const double t = (m - 1.0) / (m + 1.0);
  const double t2 = t * t;
  const double lnm = 2.0 * t * (1.0 + t2 * (1.0 / 3 + t2 * (1.0 / 5
      + t2 * (1.0 / 7 + t2 * (1.0 / 9 + t2 * (1.0 / 11 + t2 * (1.0 / 13
      + t2 * (1.0 / 15 + t2 / 17))))))));
  const double ln2 = 0.6931471805599453;
  const double inv_ln10 = 0.4342944819032518;
  return (e * ln2 + lnm) * inv_ln10;
}

}  // namespace

extern "C" {

int refine_score_cluster(const float* audio_scaled, int64_t na,
                         const float* video_scaled, int64_t nv,
                         double slope, double offset,
                         int64_t x0, int64_t x1,
                         double amax, double vmax,
                         double* out_quals) {
  if (x0 < 0 || x1 > na || x1 < x0 || nv < 2) return 1;
  const int64_t n = x1 - x0;
  constexpr int64_t BLK = 512;
  // SoA staging: the only irregular work (the two interp rows at
  // data-dependent lo) is a scalar 6-float copy per point; the f64 math
  // then runs as plain elementwise passes the auto-vectorizer handles.
  // Per-element expression order is unchanged, so outputs stay bit-equal.
  alignas(64) float vrow[6][BLK];
  alignas(64) float arow[3][BLK];
  alignas(64) double fracb[BLK];
  alignas(64) double prod[BLK], vclip[BLK], abump[BLK];
  for (int64_t b0 = 0; b0 < n; b0 += BLK) {
    const int64_t bn = (BLK < n - b0) ? BLK : (n - b0);
    for (int64_t i = 0; i < bn; ++i) {
      const int64_t x = x0 + b0 + i;
      const double y = slope * static_cast<double>(x) + offset;
      double fl = std::floor(y);
      int64_t lo = static_cast<int64_t>(fl);
      lo = lo < 0 ? 0 : (lo > nv - 2 ? nv - 2 : lo);
      fracb[i] = y - static_cast<double>(lo);
      const float* vp = video_scaled + lo * 3;
      const float* ap = audio_scaled + x * 3;
      for (int j = 0; j < 6; ++j) vrow[j][i] = vp[j];
      for (int j = 0; j < 3; ++j) arow[j][i] = ap[j];
    }
    for (int64_t i = 0; i < bn; ++i) prod[i] = 1.0;
    for (int j = 0; j < 3; ++j) {
      const float* v_lo = vrow[j];
      const float* v_hi = vrow[j + 3];
      const float* ap = arow[j];
      if (j == 0) {
        for (int64_t i = 0; i < bn; ++i) {
          const double frac = fracb[i];
          const double v = static_cast<double>(v_lo[i]) * (1.0 - frac)
                           + static_cast<double>(v_hi[i]) * frac;
          const double d = 1e-4
              + std::fabs(static_cast<double>(ap[i]) - v);
          prod[i] *= d;
          double vc = v + 2.5 - vmax;
          vclip[i] = vc < 0.0 ? 0.0 : (vc > 1.0 ? 1.0 : vc);
          // the audio bump stays in f32 exactly like the numpy expression
          // (f32 array + weak python scalars keeps f32 under NumPy 2)
          float ac = (ap[i] + 2.5f) - static_cast<float>(amax);
          ac = ac < 0.f ? 0.f : (ac > 1.f ? 1.f : ac);
          abump[i] = static_cast<double>(ac * 0.1f);
        }
      } else {
        for (int64_t i = 0; i < bn; ++i) {
          const double frac = fracb[i];
          const double v = static_cast<double>(v_lo[i]) * (1.0 - frac)
                           + static_cast<double>(v_hi[i]) * frac;
          prod[i] *= 1e-4 + std::fabs(static_cast<double>(ap[i]) - v);
        }
      }
    }
    for (int64_t i = 0; i < bn; ++i) {
      out_quals[b0 + i] = (-1.5 - log10_fast(prod[i])) * vclip[i]
                          + abump[i];
    }
  }
  return 0;
}

// The sub-frame offset-correction statistics (reference 916-930): one pass
// computes, over valid rows (mean err < 0.1), the 1-column lstsq of
// err ~ vdiff and its residual. Returns counts and sums; the caller
// applies the reference's acceptance rule. err/vdiff use rows 1..n-2 of
// the interpolated window exactly like the numpy path.
int refine_offset_stats(const float* audio_scaled, int64_t na,
                        const float* video_scaled, int64_t nv,
                        double slope, double offset,
                        int64_t x0, int64_t x1,
                        int64_t* out_valid, double* out_num,
                        double* out_den, double* out_sq) {
  if (x0 < 0 || x1 > na || x1 < x0 || nv < 2) return 1;
  const int64_t n = x1 - x0;
  if (n < 3) {
    *out_valid = 0;
    *out_num = *out_den = *out_sq = 0.0;
    return 0;
  }
  int64_t valid = 0;
  double num = 0.0, den = 0.0, sq = 0.0;
  // v(y) at rows i-1, i, i+1 is recomputed per row; the interp is cheap
  // next to the division the numpy path needs anyway
  for (int64_t i = 1; i < n - 1; ++i) {
    const int64_t x = x0 + i;
    double err[3], vd[3];
    double mean_err = 0.0;
    for (int j = 0; j < 3; ++j) {
      const float* ap = audio_scaled + x * 3;
      auto interp = [&](int64_t xx) {
        const double y = slope * static_cast<double>(xx) + offset;
        int64_t lo = static_cast<int64_t>(std::floor(y));
        lo = lo < 0 ? 0 : (lo > nv - 2 ? nv - 2 : lo);
        const double frac = y - static_cast<double>(lo);
        const float* vp = video_scaled + lo * 3 + j;
        return static_cast<double>(vp[0]) * (1.0 - frac)
               + static_cast<double>(vp[3]) * frac;
      };
      const double v_mid = interp(x);
      err[j] = static_cast<double>(audio_scaled[x * 3 + j]) - v_mid;
      vd[j] = (interp(x + 1) - interp(x - 1)) * 0.5;
      mean_err += err[j];
    }
    if (mean_err / 3.0 < 0.1) {
      ++valid;
      for (int j = 0; j < 3; ++j) {
        num += vd[j] * err[j];
        den += vd[j] * vd[j];
        sq += err[j] * err[j];
      }
    }
  }
  *out_valid = valid;
  *out_num = num;
  *out_den = den;
  *out_sq = sq;
  return 0;
}

// defined in features.cpp (same shared library)
int conv_f64(const double* x, int64_t n, const double* taps, int64_t t,
             int np_mode, double* out);

// Fused pass-1 continuity filter (alignment/continuity.py semantics,
// reference describealign.py:702-731): forward/backward half-hann local
// linear fits, per-point distance to the better line, keep err <
// threshold. One call replaces 4 conv calls + ~10 media-length numpy
// passes + 2 fancy-index compactions; every element follows the numpy
// expression order exactly (same conv kernel, same divide/multiply/
// subtract sequence), so outputs are bit-equal to the python path using
// native convs.
//   x, y: (n,) f64 match path; taps: the HALF-hann kernel (t entries,
//   forward order); half: the slope baseline spacing (10); threshold:
//   the keep gate. out_x/out_y: caller buffers of capacity n.
int continuity_filter_f64(const double* x, const double* y, int64_t n,
                          const double* taps, int64_t t, int64_t half,
                          double threshold, double* out_x, double* out_y,
                          int64_t* out_n) {
  const int64_t fd = t + half - 1;          // _FIT_DELAY (29 for t=20)
  if (t < 1 || half < 1 || n < fd + 2) return 1;
  const int64_t m = n - t + 1;              // 'valid' conv length
  if (m <= half) return 1;
  std::vector<double> xf(m), yf(m), xp(m), yp(m), rtaps(t);
  for (int64_t k = 0; k < t; ++k) rtaps[static_cast<size_t>(k)] =
      taps[t - 1 - k];
  if (conv_f64(x, n, taps, t, 0, xf.data()) != 0) return 1;
  if (conv_f64(y, n, taps, t, 0, yf.data()) != 0) return 1;
  if (conv_f64(x, n, rtaps.data(), t, 0, xp.data()) != 0) return 1;
  if (conv_f64(y, n, rtaps.data(), t, 0, yp.data()) != 0) return 1;

  const int64_t ms = m - half;              // slope/offset vector length
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    double err = std::numeric_limits<double>::infinity();
    if (i < n - fd) {
      // forward fit: slopes_fut[i] * x[i] + offsets_fut[i] - y[i]
      const double sf = (yf[static_cast<size_t>(i + half)]
                         - yf[static_cast<size_t>(i)])
                        / (xf[static_cast<size_t>(i + half)]
                           - xf[static_cast<size_t>(i)]);
      const double of = yf[static_cast<size_t>(i)]
                        - xf[static_cast<size_t>(i)] * sf;
      err = std::fabs(sf * x[i] + of - y[i]);
    }
    if (i >= fd) {
      const int64_t k = i - fd;             // index into the past vectors
      if (k < ms) {
        const double sp = (yp[static_cast<size_t>(k + half)]
                           - yp[static_cast<size_t>(k)])
                          / (xp[static_cast<size_t>(k + half)]
                             - xp[static_cast<size_t>(k)]);
        const double op = yp[static_cast<size_t>(k + half)]
                          - xp[static_cast<size_t>(k + half)] * sp;
        const double e2 = std::fabs(sp * x[i] + op - y[i]);
        err = e2 < err ? e2 : err;
      }
    }
    if (err < threshold) {
      out_x[w] = x[i];
      out_y[w] = y[i];
      ++w;
    }
  }
  *out_n = w;
  return 0;
}

}  // extern "C"


// Top-N thresholds by multisection, one thread-block cluster an item, sm_90a.
//
// Replaces the TPU kernels of rsuper_tpu/ops/pallas_topn.py:
//   rsuper_topn_threshold_multi          <- pallas_topn_threshold_multi
//                                           (_bisect_kernel)
//   rsuper_topn_threshold_multi_batched  <- pallas_topn_threshold_multi_batched
//                                           (_bisect_kernel_batched)
//
// For every item b (a flattened volume of V values) and every target
// n = ns[b, k]: hi = max(x[b]), lo = 0; `iters` times mid = 0.5f * (lo + hi),
// cnt = #{x[b] >= mid}, ok = (float)cnt >= n, lo = ok ? mid : lo,
// hi = ok ? hi : mid; the result is lo. Counts are integers, so the result is
// bit-equal to the plain PyTorch bisection whatever the summing order.
//
// Bound: bytes. The function reads V values once (3.5 MB at 96^3 float32,
// about 1 us of the card's memory rate) and writes K floats; the arithmetic
// is a few compares a value. What it costs is the chain of dependent
// whole-item reductions, iters + 1 of them in a plain bisection. Two things
// cut that chain:
//
// * Multisection. One counting pass takes r bisection levels at once. From
//   (lo, hi) the same float32 recursion gives the 2^r - 1 mids of the next r
//   levels (an implicit tree; in order they are sorted, ascending when
//   lo <= hi and descending when the item's maximum is negative), stored
//   sorted in shared memory. A value's bin is the number of mids <= it;
//   count(x >= the mid at sorted position p) is the number of values whose
//   bin is > p, a suffix sum of the bins' histogram. Each target then walks
//   its r levels through those counts with the sequential test, so it
//   visits exactly the mids the bisection would. Every target starts at
//   [0, max], so the first pass has one tree and one histogram for all K
//   targets. Histograms are int32 (integer atomics: the sums do not depend
//   on their order). With r = 9 the 26 steps take 3 passes, and the chain is
//   4 reductions long: the maximum and the 3 passes.
// * The scan. A vector none of whose values reaches the lowest mid of any
//   tree in any lane of the warp costs one test (most voxels of the Ball
//   Loss's masked volume are exactly 0); a value at or above every tree's
//   highest mid adds to a register count (the top bin). The few values
//   between are queued by ballot and binned after the scan by every thread
//   of the CTA, so that the warps whose values fall inside the trees do not
//   serialise them; a bin is guessed from the mids' even spacing and
//   checked, with a binary search where the guess fails.
// * One thread-block cluster an item (grid (C, B), cluster (C, 1, 1), C up
//   to 16, a power of two). The CTAs of a cluster exchange their maxima and
//   counts through distributed shared memory: each CTA writes its maximum
//   into every CTA; each CTA owns 1/C of every tree's bins and the others
//   add their nonzero counts into its share (remote atomics); after one
//   cluster barrier a pass every CTA gathers all the shares, takes their
//   suffix sums and walks the same counts. No global scratch, no grid-wide
//   barrier, so any number of items runs in one launch. The shares are
//   used by the passes in turn from three buffers, so that a buffer is
//   cleared only after every CTA has read it; a last barrier keeps every
//   CTA's shared memory alive until the others have read it.
//
// The volume is read from device memory once, as 16-byte vectors where
// aligned (single elements at the head and the tail). A thread keeps its
// first `cache_slots` vectors (the wrapper's plan: as many as shared memory
// holds beside the histograms) in shared memory and reads any further ones
// again from L2 in each pass. float32, bfloat16 and float16 input; every
// value is converted to float32 where it is compared.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 8;       // targets of one launch
constexpr int RMAX = 13;      // bisection levels of one pass
constexpr int CLUSTER_MAX = 16;
constexpr int SMEM_MAX = 232448 - 1024;  // dynamic shared memory of a CTA
constexpr int STAGE = 4;        // vectors in flight a thread
constexpr int QUEUE = 1024;     // vectors a pass queues for binning
constexpr int WQUEUE = QUEUE / WARPS;  // the part of one warp
constexpr int GATHER = 4;       // remote counts in flight a thread
constexpr int TL_LAST = 31;     // the timeline's slot of the kernel's end
constexpr unsigned FULL = 0xffffffffu;

// With -DTOPN_TIMELINE thread 0 of each CTA of item 0 records clock64() at
// the phases of the kernel (tools/topn_variants.py reads them back); the
// shipped build records nothing.
#ifdef TOPN_TIMELINE
constexpr int TL_SLOTS = 32;
__device__ long long g_timeline[CLUSTER_MAX][TL_SLOTS];
#define TIMELINE(n)                                                   \
  do {                                                                \
    if (blockIdx.y == 0 && threadIdx.x == 0 && (n) < TL_SLOTS)        \
      g_timeline[blockIdx.x][(n)] = clock64();                        \
  } while (0)
#else
#define TIMELINE(n) \
  do {              \
  } while (0)
#endif

// the 16-byte vector's values, converted to float32, through f
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  template <typename F>
  __device__ __forceinline__ static void each(const uint4& q, F&& f) {
    f(__uint_as_float(q.x)); f(__uint_as_float(q.y));
    f(__uint_as_float(q.z)); f(__uint_as_float(q.w));
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static float top(const uint4& q) {
    return fmaxf(fmaxf(__uint_as_float(q.x), __uint_as_float(q.y)),
                 fmaxf(__uint_as_float(q.z), __uint_as_float(q.w)));
  }
  __device__ __forceinline__ static float at(const uint4& q, int i) {
    return __uint_as_float(i < 2 ? (i == 0 ? q.x : q.y) : (i == 2 ? q.z : q.w));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  template <typename F>
  __device__ __forceinline__ static void each(const uint4& q, F&& f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f(__uint_as_float(w[i] << 16));
      f(__uint_as_float(w[i] & 0xffff0000u));
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float top(const uint4& q) {
    float m = -CUDART_INF_F;
    each(q, [&](float v) { m = fmaxf(m, v); });
    return m;
  }
  __device__ __forceinline__ static float at(const uint4& q, int i) {
    const unsigned u = __float_as_uint(Vec<float>::at(q, i >> 1));
    return __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  // the 16 bits of a value that came from this type
  __device__ __forceinline__ static unsigned bits(float v) {
    return __float_as_uint(v) >> 16;
  }
};
template <>
struct Vec<__half> {
  static constexpr int E = 8;
  template <typename F>
  __device__ __forceinline__ static void each(const uint4& q, F&& f) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f(__half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu))));
      f(__half2float(__ushort_as_half((unsigned short)(w[i] >> 16))));
    }
  }
  __device__ __forceinline__ static float one(const __half* p) {
    return __half2float(*p);
  }
  __device__ __forceinline__ static float top(const uint4& q) {
    float m = -CUDART_INF_F;
    each(q, [&](float v) { m = fmaxf(m, v); });
    return m;
  }
  __device__ __forceinline__ static float at(const uint4& q, int i) {
    const unsigned u = __float_as_uint(Vec<float>::at(q, i >> 1));
    return __half2float(__ushort_as_half(
        (unsigned short)((i & 1) ? (u >> 16) : (u & 0xffffu))));
  }
  // the 16 bits of a value that came from this type
  __device__ __forceinline__ static unsigned bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

// A value between the lowest and the highest mid of some tree: for each of
// the `trees` trees whose range holds it, its bin (the number of the tree's
// sorted mids <= v; the top bin 2^rp - 1 at or above its highest) counted
// in the histogram. The mids of a tree are close to evenly spaced, so the
// bin is guessed from v's place between the lowest and the highest mid and
// moved at most three times; where that does not reach the bin (ties,
// subnormal spans) an rp-step binary search finds it.
__device__ __forceinline__ void bin_value(float v, const float* keys, int* hist,
                                       int trees, int HB, int rp) {
  const int mk = (1 << rp) - 1;
  for (int t = 0; t < trees; ++t) {
    const float* kt = keys + t * HB;
    const float k0 = kt[0], k1 = kt[mk - 1];
    if (!(v >= k0)) continue;
    int pos = mk;
    if (v < k1) {  // kt[pos - 1] <= v < kt[pos], pos in [1, mk - 1]
      const float f = (v - k0) * __fdividef((float)(mk - 1), k1 - k0);
      pos = min(mk - 1, max(1, (int)f + 1));
      for (int c = 0; c < 3; ++c) {
        if (kt[pos - 1] > v) --pos;
        else if (kt[pos] <= v) ++pos;
        else break;
      }
      if (!(kt[pos - 1] <= v && v < kt[pos])) {
        pos = 0;
        for (int h = 1 << (rp - 1); h > 0; h >>= 1)
          if (kt[pos + h - 1] <= v) pos += h;
      }
    }
    atomicAdd(&hist[t * HB + pos], 1);
  }
}

// Sorted position of the mid at in-order index j (1-based) of a tree of m.
__device__ __forceinline__ int sorted_pos(int j, int m, bool rev) {
  return rev ? m - j : j - 1;
}

// One vector, for a warp some lane of which has a value that reaches gmin
// (the whole warp calls it together): its values at or above gmax add to
// `above` (st.x); a vector with a value in [gmin, gmax) goes into the warp's
// queue (wqueue, st.y vectors so far, the same in every lane), by ballot, or
// where the queue is full has those values binned at once.
template <typename T>
__device__ __forceinline__ int2 count_vector(const uint4& q, float gmin,
                                             float gmax, int2 st, uint4* wqueue,
                                             const float* keys, int* hist,
                                             int trees, int HB, int rp) {
  bool in = false;
  Vec<T>::each(q, [&](float v) {
    st.x += v >= gmax ? 1 : 0;
    in |= v >= gmin && v < gmax;
  });
  const unsigned m = __ballot_sync(FULL, in);
  const int at = st.y + __popc(m & ((1u << (threadIdx.x & 31)) - 1));
  if (in) {
    if (at < WQUEUE) {
      wqueue[at] = q;
    } else {
      Vec<T>::each(q, [&](float v) {
        if (v >= gmin && v < gmax) bin_value(v, keys, hist, trees, HB, rp);
      });
    }
  }
  st.y += __popc(m);
  return st;
}

// grid (C, B), cluster (C, 1, 1): CTA `rank` of the cluster of item b.
// Dynamic shared memory: [cache: cache_slots x THREADS uint4] [hist K x HB
// int] [total K x HB int] [keys K x HB float] [queue QUEUE uint4] [chunks
// K x HB / 32 int] [share 3 x K x W int], HB = max(4, 2^r, C), W = HB / C.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
multisect_kernel(const T* __restrict__ x, const float* __restrict__ ns,
                 float* __restrict__ out, long long V, int K, int iters, int r,
                 int cache_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sh_max[WARPS];
  __shared__ float sh_maxes[CLUSTER_MAX];  // every CTA's maximum
  __shared__ float sh_lo[KMAX], sh_hi[KMAX], sh_n[KMAX];
  __shared__ int sh_queued[WARPS];  // values each warp queued

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int E = Vec<T>::E;
  const int HB = max(max(4, 1 << r), C);  // a power of two
  const int CH = min(32, HB);     // bins of a chunk of the suffix scan
  uint4* cache = reinterpret_cast<uint4*>(smem);
  int* hist = reinterpret_cast<int*>(cache + (size_t)cache_slots * THREADS);
  const int W = HB / C;        // bins of a tree that each CTA sums
  int* total = hist + K * HB;  // the cluster's counts of a pass
  float* keys = reinterpret_cast<float*>(total + K * HB);
  uint4* queue = reinterpret_cast<uint4*>(keys + K * HB);
  int* chunks = reinterpret_cast<int*>(queue + QUEUE);
  int* share = chunks + K * (HB / CH);  // three buffers, used in turn

  // the item: `head` single values up to a 16-byte boundary, nvec vectors,
  // then single values again
  const T* xb = x + (size_t)b * (size_t)V;
  long long head = (long long)((16 - (reinterpret_cast<size_t>(xb) & 15)) & 15)
                   / (long long)sizeof(T);
  head = head < V ? head : V;
  const long long nvec = (V - head) / E;
  const uint4* xv = reinterpret_cast<const uint4*>(xb + head);
  const int nsingle = (int)(V - nvec * E);  // head and tail, < 2E
  const long long TC = (long long)C * THREADS, tc = (long long)rank * THREADS + tid;
  const long long tail0 = head + nvec * E;
  auto single_at = [&](int i) -> long long {
    return i < head ? (long long)i : tail0 + (i - head);
  };

  // ---- the only read from device memory, and the item's maximum: a
  // thread's first cache_slots vectors go to shared memory, STAGE vectors in
  // flight at a time; the rest it reads again from L2 in every pass.
  // A vector this thread does not have reads as NONE: NaN in every type,
  // which no compare takes, so that every lane of a warp makes the same
  // calls (the count's ballots need them all).
  TIMELINE(0);
  if (tid < K) sh_n[tid] = ns[(size_t)b * K + tid];
  // the share buffers are zero before any CTA adds to them
  for (int i = tid; i < 3 * K * W; i += THREADS) share[i] = 0;
  const uint4 NONE = make_uint4(~0u, ~0u, ~0u, ~0u);
  // Slot s of this thread is its vector s * TC + tc. `positive` marks the
  // slots below 64 with a value above 0 (in some lane of the warp, below):
  // a pass whose lowest mid is above 0 skips the others unread.
  float m = -CUDART_INF_F;
  unsigned long long positive = 0;
  auto take_max = [&](const uint4& q, int s) {
    const float top = Vec<T>::top(q);
    m = fmaxf(m, top);
    if (s < 64 && top > 0.0f) positive |= 1ull << s;
  };
  const int slots = (int)((nvec + TC - 1) / TC);  // of the CTA's threads
  auto fetch = [&](uint4* q, int s0) {  // the vectors of slots s0.. (STAGE)
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      const long long vi = (s0 + u) * TC + tc;
      q[u] = s0 + u < slots && vi < nvec ? xv[vi] : NONE;
    }
  };
  for (int s0 = 0; s0 < cache_slots; s0 += STAGE) {
    uint4 q[STAGE];
    fetch(q, s0);
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      if (s0 + u < cache_slots) cache[(size_t)(s0 + u) * THREADS + tid] = q[u];
      take_max(q[u], s0 + u);
    }
  }
  // the slots no shared memory holds, from L2, STAGE at a time: rest(fv, q,
  // skip) passes the batch in q (already fetched) and the later ones to fv,
  // but for the batches skip(s0) says no lane needs
  uint4 batch[STAGE];
  auto rest = [&](auto&& fv, auto&& skip) {
    for (int s0 = cache_slots; s0 < slots; s0 += STAGE) {
      if (skip(s0)) continue;
      if (s0 > cache_slots) fetch(batch, s0);
#pragma unroll
      for (int u = 0; u < STAGE; ++u) fv(batch[u], s0 + u);
    }
  };
  if (cache_slots < slots) fetch(batch, cache_slots);
  rest(take_max, [](int) { return false; });
  const float single = tc < nsingle ? Vec<T>::one(xb + single_at((int)tc))
                                    : __uint_as_float(~0u);
  m = warp_max(fmaxf(m, single));
  positive = ((unsigned long long)__reduce_or_sync(FULL, (unsigned)(positive >> 32)) << 32) |
             __reduce_or_sync(FULL, (unsigned)positive);
  TIMELINE(1);
  if (lane == 0) sh_max[warp] = m;
  __syncthreads();
  if (warp == 0) {  // this CTA's maximum, written into every CTA of the item
    m = warp_max(lane < WARPS ? sh_max[lane] : -CUDART_INF_F);
    if (lane < C) *cluster.map_shared_rank(&sh_maxes[rank], lane) = m;
  }
  cluster.sync();
  if (warp == 0) {
    m = warp_max(lane < C ? sh_maxes[lane] : -CUDART_INF_F);
    if (lane < KMAX) {
      sh_lo[lane] = 0.0f;
      sh_hi[lane] = m;
    }
  }
  __syncthreads();
  TIMELINE(2);

  // ---- the passes: r levels each, the first shared by every target
  for (int done = 0, p = 0; done < iters; done += r, ++p) {
    const int rp = min(r, iters - done), mk = (1 << rp) - 1;
    const int trees = p == 0 ? 1 : K;
    for (int i = tid; i < trees * HB; i += THREADS) hist[i] = 0;
    // the share buffer of the next pass, last read in pass p - 2: the others
    // read it before the barrier of pass p - 1, add to it after that of p
    if (p > 0)
      for (int i = tid; i < K * W; i += THREADS) share[((p + 1) % 3) * K * W + i] = 0;
    // the sorted mids of every tree, by the bisection's own recursion: a
    // thread walks from the root to one leaf (odd in-order index) and writes
    // every mid on the way; the leaves that share a mid write it alike
    for (int i = tid; i < trees << (rp - 1); i += THREADS) {
      const int t = i >> (rp - 1), leaf = 2 * (i & ((1 << (rp - 1)) - 1)) + 1;
      float lo = sh_lo[t], hi = sh_hi[t];
      const bool rev = lo > hi;
      int idx = 1 << (rp - 1), step = idx >> 1;
      for (int l = 0; l < rp; ++l) {
        const float md = 0.5f * (lo + hi);
        keys[t * HB + sorted_pos(idx, mk, rev)] = md;
        if (leaf > idx) { lo = md; idx += step; }
        else { hi = md; idx -= step; }
        step >>= 1;
      }
    }
    __syncthreads();
    TIMELINE(3 + 8 * p);

    float gmin = CUDART_INF_F, gmax = -CUDART_INF_F;
    for (int t = 0; t < trees; ++t) {
      gmin = fminf(gmin, keys[t * HB]);
      gmax = fmaxf(gmax, keys[t * HB + mk - 1]);
    }
    // A value below every tree's lowest mid counts for nothing, one at or
    // above every tree's highest goes to a register count; the rest (rare)
    // are binned after the scan by every thread of the CTA, so that the
    // warps whose values fall inside the trees do not serialise them: each
    // warp queues them in its part of the queue, by ballot, where it has
    // room, and bins them itself where it has not.
    int2 st = make_int2(0, 0);  // above, queued (the same in every lane)
    uint4* wqueue = queue + warp * WQUEUE;
    // a vector none of whose values reaches gmin in any lane costs one test;
    // where gmin > 0 a slot with no value above 0 in the warp is not read
    auto count = [&](const uint4& q, int) {
      if (__any_sync(FULL, Vec<T>::top(q) >= gmin))
        st = count_vector<T>(q, gmin, gmax, st, wqueue, keys, hist, trees, HB,
                             rp);
    };
    const bool sparse = gmin > 0.0f;
    auto unread = [&](int s0) {  // batch s0.. of the L2 slots
      return sparse && s0 + STAGE <= 64 &&
             !((positive >> s0) & ((1ull << STAGE) - 1));
    };
    if (cache_slots < slots && !unread(cache_slots))
      fetch(batch, cache_slots);  // in flight during the cached slots
#pragma unroll 2
    for (int s = 0; s < cache_slots; ++s)
      if (!sparse || s >= 64 || ((positive >> s) & 1))
        count(s * TC + tc < nvec ? cache[(size_t)s * THREADS + tid] : NONE, s);
    rest(count, unread);
    if (__any_sync(FULL, single >= gmin)) {  // the head and tail values
      // queued as a vector of T: the single value and NaN
      uint4 q = NONE;
      if constexpr (E == 4) q.x = __float_as_uint(single);
      else q.x = 0xffff0000u | Vec<T>::bits(single);
      st = count_vector<T>(q, gmin, gmax, st, wqueue, keys, hist, trees, HB,
                           rp);
    }
    TIMELINE(4 + 8 * p);
    const int above = __reduce_add_sync(FULL, st.x);
    if (lane == 0) {
      if (above)
        for (int t = 0; t < trees; ++t) atomicAdd(&hist[t * HB + mk], above);
      sh_queued[warp] = min(st.y, WQUEUE);
    }
    __syncthreads();
    // the queued vectors' values, one a thread: vector e of the warps'
    // queues laid end to end is entry e - (entries of the warps before) of
    // warp w
    int queued = 0;
    for (int w = 0; w < WARPS; ++w) queued += sh_queued[w];
    for (int ev = tid; ev < queued * E; ev += THREADS) {
      const int e = ev / E;
      int w = 0, first = 0;
      while (e >= first + sh_queued[w]) first += sh_queued[w++];
      const float v = Vec<T>::at(queue[w * WQUEUE + e - first], ev - e * E);
      if (v >= gmin && v < gmax) bin_value(v, keys, hist, trees, HB, rp);
    }
    __syncthreads();
    TIMELINE(5 + 8 * p);

    // Each CTA owns W bins of every tree; this CTA's counts are added into
    // their owners' `share` of this pass (distributed shared memory, integer
    // atomics: the sums do not depend on their order; a bin that counted
    // nothing adds nothing). After one cluster barrier every CTA gathers all
    // the shares into `total`.
    int* sh = share + (p % 3) * K * W;
    for (int i = tid; i < trees * HB; i += THREADS) {
      const int c = hist[i];
      if (c) {
        const int t = i / HB, bin = i - t * HB;
        atomicAdd(cluster.map_shared_rank(sh + t * W + bin % W, bin / W), c);
      }
    }
    TIMELINE(6 + 8 * p);
    cluster.sync();
    TIMELINE(7 + 8 * p);
    for (int i0 = 0; i0 < trees * HB; i0 += GATHER * THREADS) {
      int v[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int i = i0 + u * THREADS + tid, t = i / HB, bin = i - t * HB;
        v[u] = i < trees * HB
                   ? *cluster.map_shared_rank(sh + t * W + bin % W, bin / W)
                   : 0;
      }
#pragma unroll
      for (int u = 0; u < GATHER; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < trees * HB) total[i] = v[u];
      }
    }
    TIMELINE(8 + 8 * p);

    // suffix sums of the summed counts: within chunks of CH bins by the lanes
    // of a warp, in place, then the chunks' totals per tree by warp t
    for (int i0 = 0; i0 < trees * HB; i0 += THREADS) {
      const int i = i0 + tid;
      int v = i < trees * HB ? total[i] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_down_sync(FULL, v, o, CH);
        if ((lane & (CH - 1)) + o < CH) v += u;
      }
      if (i < trees * HB) total[i] = v;
    }
    __syncthreads();
    if (warp < trees) {  // chunks[t][c] = the counts of tree t's chunks above c
      const int t = warp, nch = HB / CH;
      int carry = 0;
      for (int c0 = nch - 32; c0 > -32; c0 -= 32) {  // 32 chunks at a time, top down
        const int c = c0 + lane;
        const int own = c >= 0 ? total[t * HB + c * CH] : 0;
        int incl = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_down_sync(FULL, incl, o);
          if (lane + o < 32) incl += u;
        }
        if (c >= 0) chunks[t * (HB / CH) + c] = carry + incl - own;
        carry += __shfl_sync(FULL, incl, 0);
      }
    }
    __syncthreads();
    for (int i = tid; i < trees * HB; i += THREADS)
      total[i] += chunks[i / CH];  // total[t][bin] = #{values in bins >= bin}
    __syncthreads();
    TIMELINE(9 + 8 * p);

    // target k walks its r levels: count(x >= the mid at sorted position
    // pos) = #{bin > pos}
    if (tid < K) {
      const int t = p == 0 ? 0 : tid;
      float lo = sh_lo[tid], hi = sh_hi[tid];
      const bool rev = lo > hi;
      const float n = sh_n[tid];
      int j = 1 << (rp - 1), step = j >> 1;
      for (int l = 0; l < rp; ++l) {
        const int cnt = total[t * HB + sorted_pos(j, mk, rev) + 1];
        const float md = 0.5f * (lo + hi);
        const bool ok = (float)cnt >= n;
        lo = ok ? md : lo;
        hi = ok ? hi : md;
        j = ok ? j + step : j - step;
        step >>= 1;
      }
      sh_lo[tid] = lo;
      sh_hi[tid] = hi;
    }
    __syncthreads();
    TIMELINE(10 + 8 * p);
  }
  cluster.sync();  // no CTA leaves while another may still read its share
  TIMELINE(TL_LAST);
  if (rank == 0 && tid < K) out[(size_t)b * K + tid] = sh_lo[tid];
}

template <typename T>
const void* kernel_ptr() {
  return (const void*)multisect_kernel<T>;
}

const void* kernel_of(int dtype) {
  switch (dtype) {
    case 0: return kernel_ptr<float>();
    case 1: return kernel_ptr<__nv_bfloat16>();
    case 2: return kernel_ptr<__half>();
    default: return nullptr;
  }
}

// The kernel's attributes, once for each dtype and device.
cudaError_t prepare(int dtype, const void* fn) {
  static bool done[3][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dtype][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess && dev < 64) done[dtype][dev] = true;
  return e;
}

int launch(const void* x, const float* ns, float* out, long long B,
           long long V, int K, int iters, int r, int cache_slots, int cluster,
           int dtype, cudaStream_t stream) {
  const void* fn = kernel_of(dtype);
  if (fn == nullptr || K < 1 || K > KMAX || B < 1 || B > 65535 || V < 1 ||
      V > 0x7fffffffLL || iters < 0 || r < 1 || r > RMAX || cache_slots < 0 ||
      cluster < 1 || cluster > CLUSTER_MAX || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int HB = std::max(std::max(4, 1 << r), cluster);
  const long long smem =
      (long long)cache_slots * THREADS * 16 + 12LL * K * HB + 16LL * QUEUE +
      4LL * K * (HB / std::min(32, HB)) + 12LL * K * (HB / cluster);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = prepare(dtype, fn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&x, (void*)&ns, (void*)&out, (void*)&V,
                  (void*)&K, (void*)&iters, (void*)&r, (void*)&cache_slots};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// The largest cluster the current device schedules for the kernel at the
// most shared memory a launch asks for: 16 where cudaOccupancyMaxActiveClusters
// finds room for one, else 8; *active gets how many such clusters the device
// holds at once. A negative CUDA error code on failure.
#ifdef TOPN_TIMELINE
// The clocks of the last launch's item 0: host[CLUSTER_MAX][TL_SLOTS].
extern "C" int rsuper_topn_timeline(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_timeline, sizeof(g_timeline));
}
#endif

extern "C" int rsuper_topn_max_cluster(int dtype, int* active) {
  const void* fn = kernel_of(dtype);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t e = prepare(dtype, fn);
  if (e != cudaSuccess) return -(int)e;
  for (int c = CLUSTER_MAX; c >= 8; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)c, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM_MAX;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
    if (e != cudaSuccess) {
      cudaGetLastError();
      if (c == 8) return -(int)e;
      continue;
    }
    if (n > 0) {
      *active = n;
      return c;
    }
  }
  return -(int)cudaErrorInvalidConfiguration;
}

// One volume: x[V] in `dtype` (0 float32, 1 bfloat16, 2 float16), ns[K] and
// out[K] float32. r levels a pass, cache_slots 16-byte vectors a thread held
// on chip, `cluster` CTAs.
extern "C" int rsuper_topn_threshold_multi(
    const void* x, const float* ns, float* out, long long V, int K, int iters,
    int r, int cache_slots, int cluster, int dtype, cudaStream_t stream) {
  return launch(x, ns, out, 1, V, K, iters, r, cache_slots, cluster, dtype,
                stream);
}

// B volumes: x[B][V], ns[B][K] and out[B][K]; one cluster an item.
extern "C" int rsuper_topn_threshold_multi_batched(
    const void* x, const float* ns, float* out, long long B, long long V, int K,
    int iters, int r, int cache_slots, int cluster, int dtype,
    cudaStream_t stream) {
  return launch(x, ns, out, B, V, K, iters, r, cache_slots, cluster, dtype,
                stream);
}

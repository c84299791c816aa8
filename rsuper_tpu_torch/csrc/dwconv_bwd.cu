// Backward of the depthwise SAME 3x3x3 convolution on channels-last
// operands: dx and dw in one kernel. CUDA C++ for sm_90a.
//
// Replaces the TPU kernel of rsuper_tpu/ops/dwconv.py: _dw_bwd_pallas
// (_bwd_kernel), reached from the VJP of depthwise_conv3x3x3. As there, one
// kernel produces dx and dw from the same staged dy planes.
//
//   x, dy   (B, D, H, W, C)   float or bf16
//   w       (27, C)           float32; rounded here to x's type
//   dx      (B, D, H, W, C)   x's type
//   dw      (27, C)           float32 (rounded to x's type when round_dw)
//   partial (G + NG, 27, C)   float32 scratch, G = blocks per channel chunk,
//                             NG = ceil(G / GROUP) group sums
//   counter (n_chunks, NG + 1) int32, zero before the call and after it
//
//   dx[q] = sum_k w[k] * dy[q - (k - 1)]   (w rounded to x's type; the flip
//           of the taps is an index here), rounded once to x's type;
//   dw[k] = sum_q x[q] * dy[q - (k - 1)]   in float32
//   (k - 1 is the tap's offset in depth, row and column; dy is 0 outside).
//
// What bounds it: one read of x and of dy and one write of dx, against 54
// FMAs per element (27 for dx, 27 for dw): in bf16 about as many instruction
// slots as bytes at the card's rates, so neither may be wasted.
//
// Design: the tiles, chunks and depth runs of the forward (dwconv.cu,
// ops/dwconv.py:_dw_plan). A block walks the depths d of its run; for each it
// has the halo'd dy planes d - 1, d, d + 1 staged in a ring of DY_RING
// shared-memory buffers and the x plane d (no halo) in a ring of X_RING,
// DY_RING - 2 planes ahead. On the wide route one thread stages both with
// two TMA copies (zero fill outside the volume, one mbarrier); on the
// narrow route the threads copy element by element. A thread owns a
// channel pair (bf16; one float channel), a row of the tile and a W strip of
// SW = 6 positions. For each of the 9 (kd, kh) dy rows it needs it converts
// SW + 2 values to float once; each value feeds the dx taps (times w) and the
// dw taps (times the thread's 6 staged x values). dx of depth d is then
// complete and stored. The weights, rounded to x's type, are staged in x's
// type, so a lane reads a tap's pair as one 4-byte word (in float32 they
// would take two 128-byte wavefronts of shared memory a tap and warp).
//
// dw without atomics: the thread keeps its 27 x 2 float32 dw sums in
// registers for the whole run (not 27 x 8: a lane owns 2 channels, not a
// 16-byte vector). At the end of the run the warps add theirs into a
// 27 x chunk float32 table in shared memory one warp after the other, and
// the block writes it to partial[g]. Integer arrival counters (after
// __threadfence) then pick, in each group of GROUP blocks of a channel
// chunk, the last to finish: it sums its group's partials in index order,
// and the last of the chunk's group summers sums the group sums in index
// order into dw and resets the counters. Every sum is taken in a fixed
// order, so dw is the same from run to run. One launch a call.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int SW = 6;             // W outputs a thread owns
constexpr int ROW = SW + 2;       // staged W positions it reads a row
constexpr int DY_RING = 5;        // staged dy planes: d - 1, d, d + 1 and two ahead
constexpr int X_RING = 3;         // staged x planes
constexpr int LANES = 32;         // one warp across a channel chunk
constexpr int CHUNK_BYTES = 128;  // channels of a block, in bytes
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB a block
constexpr int GROUP = 16;         // partials summed by the last block of a group
constexpr int BATCH = 8;          // partial rows a thread loads at once when summing

template <typename T> struct Lane;  // channels a lane owns
template <> struct Lane<float> { static constexpr int N = 1; };
template <> struct Lane<__nv_bfloat16> { static constexpr int N = 2; };

struct Geo {
  int B, D, H, W, C;
  int rows, strips, depth_run;
  int n_chunks, tiles_h, tiles_w, runs;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void lds(const float* p, float (&o)[1]) { o[0] = *p; }
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = f.x;
  o[1] = f.y;
}

template <bool WIDE>
__device__ __forceinline__ void stg(float* p, const float (&v)[1], int left) {
  if (WIDE || left > 0) p[0] = v[0];
}
template <bool WIDE>
__device__ __forceinline__ void stg(__nv_bfloat16* p, const float (&v)[2], int left) {
  if constexpr (WIDE) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    if (left > 0) p[0] = __float2bfloat16_rn(v[0]);
    if (left > 1) p[1] = __float2bfloat16_rn(v[1]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// As in dwconv.cu: an mbarrier a group (one arrival plus the copies' bytes),
// TMA copies of boxes of a tensor map (zeros outside), a bounded wait.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c, int w, int h,
                                        int z, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h),
         "r"(z), "r"(b), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1 << 24)) __trap();
  }
}

// The narrow route's staging: the ph x pw positions from (oh, ow) of plane z
// of item b, channels [c0, c0 + CH), into buf ([ph][pw][CH]), element by
// element; zeros outside the volume and past C.
template <typename T>
__device__ __forceinline__ void stage_narrow(T* buf, const T* __restrict__ src, int b, int z,
                                             int oh, int ow, int ph, int pw, int c0,
                                             const Geo& g) {
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  const bool zin = z >= 0 && z < g.D;
  const T* plane = src + (zin ? ((size_t)b * g.D + z) * g.H * g.W * g.C : 0);
  for (int i = threadIdx.x; i < ph * pw * CH; i += blockDim.x) {
    const int c = c0 + i % CH, pos = i / CH;
    const int hh = oh + pos / pw, ww = ow + pos % pw;
    const bool ok = zin && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W && c < g.C;
    buf[i] = ok ? plane[((size_t)hh * g.W + ww) * g.C + c] : zero<T>();
  }
}

// out[k, c] = rows[0][k, c] + rows[1][k, c] + ... over n rows of (27, C)
// floats, in that order, for the chunk's channels [c0, c0 + CH); rounded to
// x's type when `round`. Wide: 16-byte loads (C is a multiple of 4 there).
template <typename T, bool WIDE>
__device__ __forceinline__ void sum_rows(const float* rows, int n, float* out, int c0,
                                         const Geo& g, int round) {
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  constexpr int V = WIDE ? 4 : 1;
  const size_t stride = (size_t)27 * g.C;
  for (int i = threadIdx.x; i < 27 * CH / V; i += blockDim.x) {
    const int k = i / (CH / V), cc = c0 + (i % (CH / V)) * V;
    if (cc >= g.C) continue;
    const float* p = rows + (size_t)k * g.C + cc;
    float a[V];
#pragma unroll
    for (int v = 0; v < V; ++v) a[v] = 0.f;
    for (int q0 = 0; q0 < n; q0 += BATCH) {  // BATCH loads in flight, added in order
      float t[BATCH][V];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (q0 + u >= n) break;
        if constexpr (WIDE) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(p + (q0 + u) * stride));
          t[u][0] = f.x;
          t[u][1] = f.y;
          t[u][2] = f.z;
          t[u][3] = f.w;
        } else {
          t[u][0] = __ldcg(p + (q0 + u) * stride);
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (q0 + u >= n) break;
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] += t[u][v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (round) a[v] = round_to<T>(a[v]);
    if constexpr (WIDE)
      *reinterpret_cast<float4*>(out + (size_t)k * g.C + cc) = make_float4(a[0], a[1], a[2], a[3]);
    else
      out[(size_t)k * g.C + cc] = a[0];
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS, 2)
dw3_bwd_kernel(const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap x_map, const T* __restrict__ x,
               const float* __restrict__ w, const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ dw, float* __restrict__ partial, int* __restrict__ counter,
               const Geo g, const int round_dw) {
  constexpr int N = Lane<T>::N;
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  // from a 128-byte boundary (TMA's destination alignment)
  unsigned char* smem = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  const int tw = SW * g.strips, ph = g.rows + 2, pw = tw + 2;
  const int plane = ph * pw * CH, xplane = g.rows * tw * CH;  // elements
  T* dy_ring = reinterpret_cast<T*>(smem);
  T* x_ring = dy_ring + (size_t)DY_RING * plane;
  T* ws = x_ring + (size_t)X_RING * xplane;                 // [27][CH] weights
  float* red = reinterpret_cast<float*>(ws + 27 * CH);      // [27][CH] dw sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 27 * CH);  // one a group in flight

  int bid = blockIdx.x;
  const int chunk = bid % g.n_chunks;
  bid /= g.n_chunks;
  const int tile_w = bid % g.tiles_w;
  bid /= g.tiles_w;
  const int tile_h = bid % g.tiles_h;
  bid /= g.tiles_h;
  const int run = bid % g.runs, b = bid / g.runs;
  const int c0 = chunk * CH, h0 = tile_h * g.rows, w0 = tile_w * tw;
  const int d0 = run * g.depth_run, d1 = min(d0 + g.depth_run, g.D);
  const int n_groups = d1 - d0 + 2;  // group j: dy plane d0 - 1 + j, x plane d0 - 2 + j

  if (WIDE && threadIdx.x == 0) {
    for (int k = 0; k < DY_RING; ++k) bar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int j) {  // group j into dy buffer j % DY_RING, x buffer j % X_RING
    if (j >= n_groups) return;
    if constexpr (WIDE) {
      if (threadIdx.x == 0) {
        uint64_t* bar = bars + j % DY_RING;
        bar_expect(bar, (plane + (j >= 2 ? xplane : 0)) * sizeof(T));
        tma_box(dy_ring + (j % DY_RING) * plane, &dy_map, c0, w0 - 1, h0 - 1, d0 - 1 + j, b,
                bar);
        if (j >= 2)
          tma_box(x_ring + (j % X_RING) * xplane, &x_map, c0, w0, h0, d0 - 2 + j, b, bar);
      }
    } else {
      stage_narrow<T>(dy_ring + (j % DY_RING) * plane, dy, b, d0 - 1 + j, h0 - 1, w0 - 1, ph,
                      pw, c0, g);
      if (j >= 2)
        stage_narrow<T>(x_ring + (j % X_RING) * xplane, x, b, d0 - 2 + j, h0, w0, g.rows, tw,
                        c0, g);
    }
  };
  auto landed = [&](int j) {  // wait for group j
    if constexpr (WIDE) bar_wait(bars + j % DY_RING, (j / DY_RING) & 1);
  };
  for (int j = 0; j < DY_RING - 1; ++j) fetch(j);
  for (int i = threadIdx.x; i < 27 * CH; i += blockDim.x) {
    const int c = c0 + i % CH;
    ws[i] = c < g.C ? from_f<T>(w[(size_t)(i / CH) * g.C + c]) : zero<T>();
  }

  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int r = warp / g.strips, s = warp % g.strips;
  const int h = h0 + r, wb = w0 + s * SW, c = c0 + lane * N;
  const bool mine = h < g.H && c < g.C;
  const T* wl = ws + lane * N;
  float gw[27][N];  // this thread's dw sums
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int n = 0; n < N; ++n) gw[k][n] = 0.f;

  landed(0);
  landed(1);
  for (int i = 0; i < d1 - d0; ++i) {  // depth d = d0 + i needs groups <= i + 2
    landed(i + 2);
    __syncthreads();          // every thread is past step i - 1: its buffers are free
    fetch(i + DY_RING - 1);

    float xv[SW][N];
    const T* xp = x_ring + ((i + 2) % X_RING) * xplane + (size_t)(r * tw + s * SW) * CH + lane * N;
#pragma unroll
    for (int j = 0; j < SW; ++j) lds(xp + (size_t)j * CH, xv[j]);
    float gx[SW][N];
#pragma unroll
    for (int j = 0; j < SW; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n) gx[j][n] = 0.f;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {  // dy plane d + 1 - kd is group i + 2 - kd
      const T* pl = dy_ring + ((i + 2 - kd) % DY_RING) * plane +
                    (size_t)(r * pw + s * SW) * CH + lane * N;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {  // dy row h + 1 - kh is staged row r + 2 - kh
        float v[ROW][N];
#pragma unroll
        for (int q = 0; q < ROW; ++q) lds(pl + (size_t)((2 - kh) * pw + q) * CH, v[q]);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {  // dy column w + 1 - kw is v[j + 2 - kw]
          const int k = (kd * 3 + kh) * 3 + kw;
          float wv[N];  // one 4-byte word: the weights are staged in x's type
          lds(wl + k * CH, wv);
#pragma unroll
          for (int j = 0; j < SW; ++j)
#pragma unroll
            for (int n = 0; n < N; ++n) {
              const float t = v[j + 2 - kw][n];
              gx[j][n] = fmaf(wv[n], t, gx[j][n]);
              gw[k][n] = fmaf(xv[j][n], t, gw[k][n]);
            }
        }
      }
    }
    if (mine) {
      T* out = dx + ((((size_t)b * g.D + d0 + i) * g.H + h) * g.W) * g.C + c;
#pragma unroll
      for (int j = 0; j < SW; ++j)
        if (wb + j < g.W) stg<WIDE>(out + (size_t)(wb + j) * g.C, gx[j], g.C - c);
    }
  }

  // the block's dw: the warps' sums added one warp after the other
  const int nwarps = blockDim.x / LANES;
  for (int q = 0; q < nwarps; ++q) {
    if (warp == q) {
#pragma unroll
      for (int k = 0; k < 27; ++k)
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float* t = red + k * CH + lane * N + n;
          *t = q == 0 ? gw[k][n] : *t + gw[k][n];
        }
    }
    __syncthreads();
  }
  const int G = gridDim.x / g.n_chunks, gi = blockIdx.x / g.n_chunks;
  for (int i = threadIdx.x; i < 27 * CH; i += blockDim.x) {
    const int cc = c0 + i % CH;
    if (cc < g.C) partial[((size_t)gi * 27 + i / CH) * g.C + cc] = red[i];
  }
  // the chunk's G partials, summed in two fixed-order levels: the last block
  // of each group of GROUP sums its group, the last group summer the groups
  const int NG = (G + GROUP - 1) / GROUP, grp = gi / GROUP;
  int* cnt = counter + (size_t)chunk * (NG + 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt + grp, 1) == min(GROUP, G - grp * GROUP) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t row = (size_t)27 * g.C;
  if (NG == 1) {
    sum_rows<T, WIDE>(partial, G, dw, c0, g, round_dw);
    if (threadIdx.x == 0) cnt[0] = 0;
    return;
  }
  sum_rows<T, WIDE>(partial + grp * GROUP * row, min(GROUP, G - grp * GROUP),
                    partial + (G + grp) * row, c0, g, false);
  if (threadIdx.x == 0) cnt[grp] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt + NG, 1) == NG - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows<T, WIDE>(partial + G * row, NG, dw, c0, g, round_dw);
  if (threadIdx.x == 0) cnt[NG] = 0;
}

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so that
// the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 5-D map over (C, W, H, D, B), innermost first, with a box of CH channels
// x bw x bh positions of one plane.
template <typename T>
bool plane_map(CUtensorMap* map, const void* base, const Geo& g, int bw, int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[5] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H,
                              (cuuint64_t)g.D, (cuuint64_t)g.B};
  const cuuint64_t strides[4] = {g.C * es, (cuuint64_t)g.W * g.C * es,
                                 (cuuint64_t)g.H * g.W * g.C * es,
                                 (cuuint64_t)g.D * g.H * g.W * g.C * es};
  const cuuint32_t box[5] = {(cuuint32_t)(CHUNK_BYTES / sizeof(T)), (cuuint32_t)bw,
                             (cuuint32_t)bh, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                5, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool WIDE>
int launch(const void* x, const float* w, const void* dy, void* dx, float* dw, float* partial,
           int* counter, const Geo& g, int round_dw, cudaStream_t stream) {
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  const int tw = SW * g.strips;
  const size_t smem = (size_t)DY_RING * (g.rows + 2) * (tw + 2) * CHUNK_BYTES +
                      (size_t)X_RING * g.rows * tw * CHUNK_BYTES + 27 * CHUNK_BYTES +
                      27 * CH * 4 + DY_RING * 8 + 128;
  const int threads = LANES * g.rows * g.strips;
  const long long blocks = (long long)g.n_chunks * g.tiles_h * g.tiles_w * g.runs * g.B;
  if (smem > MAX_SMEM || threads > MAX_THREADS || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dy_map, x_map;
  memset(&dy_map, 0, sizeof(dy_map));
  memset(&x_map, 0, sizeof(x_map));
  if (WIDE && !(plane_map<T>(&dy_map, dy, g, tw + 2, g.rows + 2) &&
                plane_map<T>(&x_map, x, g, tw, g.rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // opt in (per device, so on every such call)
    cudaError_t e = cudaFuncSetAttribute(dw3_bwd_kernel<T, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dw3_bwd_kernel<T, WIDE><<<(unsigned)blocks, threads, smem, stream>>>(
      dy_map, x_map, static_cast<const T*>(x), w, static_cast<const T*>(dy), static_cast<T*>(dx),
      dw, partial, counter, g, round_dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wide != 0 selects the TMA staging (the
// caller checks C and the pointers). rows, strips and depth_run are the
// plan of ops/dwconv.py:_dw_plan; partial holds (G + NG) * 27 * C floats
// with G the grid's blocks per channel chunk and NG = ceil(G / GROUP),
// counter n_chunks * (NG + 1) zeros. round_dw != 0 writes dw rounded to x's
// type. device is the operands' card, made current first (as in dwconv.cu:
// cuTensorMapEncodeTiled needs it, and autograd calls this from its own
// threads). Returns a CUDA error code.
extern "C" int rsuper_dw3_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                              void* partial, void* counter, int B, int D, int H, int W, int C,
                              int dtype, int wide, int rows, int strips, int depth_run,
                              int round_dw, int device, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows < 1 || strips < 1 || depth_run < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * D * H * W * C == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ch = dtype == 0 ? CHUNK_BYTES / 4 : CHUNK_BYTES / 2;
  Geo g{B, D, H, W, C, rows, strips, depth_run, (C + ch - 1) / ch, (H + rows - 1) / rows,
        (W + SW * strips - 1) / (SW * strips), (D + depth_run - 1) / depth_run};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(partial);
  int* cnt = static_cast<int*>(counter);
  if (dtype == 0)
    return wide ? launch<float, true>(x, wf, dy, dx, dwf, pf, cnt, g, round_dw, s)
                : launch<float, false>(x, wf, dy, dx, dwf, pf, cnt, g, round_dw, s);
  return wide ? launch<__nv_bfloat16, true>(x, wf, dy, dx, dwf, pf, cnt, g, round_dw, s)
              : launch<__nv_bfloat16, false>(x, wf, dy, dx, dwf, pf, cnt, g, round_dw, s);
}

// Depthwise SAME 3x3x3 convolution on channels-last operands, forward.
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel of rsuper_tpu/ops/dwconv.py: _dw_pallas
// (_fwd_kernel), reached through depthwise_conv3x3x3.
//
//   x (B, D, H, W, C)  float or bf16
//   w (27, C)          float32; rounded here to x's type
//   y (B, D, H, W, C)  x's type
//
//   y[b,d,h,w,c] = sum_k w[k,c] * x[b, d+kd-1, h+kh-1, w+kw-1, c] in float32,
//   zero outside the volume, rounded once to x's type.
//
// What bounds it: 27 multiply-adds per element and no channel contraction.
// In bf16 that is about 14 operations per byte moved, under the card's
// float32 balance point (20): memory bounds it, one read of x and one write
// of y, but the multiply-adds are close behind, so the inner loop has to be
// almost nothing but FMAs.
//
// Design: a depth-marching stencil (2.5-D blocking). A block owns a chunk of
// 128 bytes of channels (64 bf16 or 32 float), a tile of rows x (6 * strips)
// positions of one (H, W) plane of one batch item, and a run of depths. It
// walks the depths of its run from d0 - 1 to d1, staging each input plane of
// the tile with its 1-voxel halo into a ring of RING shared-memory buffers,
// RING - 1 planes ahead of the one it computes. On the wide route one thread
// stages a whole plane with one TMA copy (cp.async.bulk.tensor, 5-D tensor
// map over (C, W, H, D, B)); the copy fills with zeros what lies outside the
// volume or past C, so padding is free and no tap checks a bound, and the
// other threads spend no instruction on staging. Each staged plane z feeds
// the three output depths it touches (z + 1, z, z - 1): a thread keeps
// their sums in registers, and when plane z is done depth z - 1 is complete
// and stored. So every input byte is read from device memory about once,
// plus the halo, which mostly hits L2.
//
// A warp spans the chunk's channels: lane l owns 2 bf16 channels (or 1
// float), so shared-memory reads are conflict-free 4-byte words and the
// stores of a warp are 128 contiguous bytes. Warp (r, s) of the block owns
// row r of the tile and the W strip s of SW = 6 positions; for each of the 3
// staged rows it needs it converts the SW + 2 values to float once and uses
// them for the 3 kw taps of the 3 depths: 24 loads and 48 conversions per
// 324 FMAs, with no branch in between. The weights of the chunk, rounded to
// x's type, sit in shared memory as float32 (in registers they spill).
//
// Any C and any alignment: when C * sizeof(T) is not a multiple of 16 or a
// pointer is not 16-byte aligned (ops/dwconv.py:dw_route), the same kernel
// stages element by element with ordinary loads and stores per element.
// The tile, the depth run and the grid come from ops/dwconv.py:_dw_plan.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int SW = 6;             // W outputs a thread owns
constexpr int ROW = SW + 2;       // staged W positions it reads a row
constexpr int RING = 3;           // staged input planes (faster than 4 on an H100)
constexpr int LANES = 32;         // one warp across a channel chunk
constexpr int CHUNK_BYTES = 128;  // channels of a block, in bytes
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB a block

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

// w rounded to x's type, as a float
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A lane's N staged channels as floats (one 4-byte shared-memory word).
__device__ __forceinline__ void lds(const float* p, float (&o)[1]) { o[0] = *p; }
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = f.x;
  o[1] = f.y;
}

// A lane's N outputs: one 4-byte store on the wide route, else one store per
// channel below C (`left` = C - first channel).
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

// The ring's mbarriers: one arrival (the thread that starts the copy) plus
// the copy's bytes complete a phase.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bar)) : "memory");
}

// One TMA copy of a box of the tensor map (coordinates innermost first:
// channel, w, h, z, b; negative or past the end fills zeros) into dst,
// completing on bar, which expects `bytes`.
__device__ __forceinline__ void tma_plane(void* dst, const CUtensorMap* map, int c, int w,
                                          int h, int z, int b, uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h),
         "r"(z), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of bar with this parity. A copy that never lands makes
// the launch fail (trap) instead of hanging the card.
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

// acc[j] += w[kw] * v[j + kw] over the 3 kw taps of one (kd, kh) row; with
// FIRST, the row's first tap sets acc instead (the sums start there).
template <int N, bool FIRST = false>
__device__ __forceinline__ void taps(float (&acc)[SW][N], const float (&v)[ROW][N],
                                     const float* wrow, int ch) {
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    float wv[N];
#pragma unroll
    for (int n = 0; n < N; ++n) wv[n] = wrow[kw * ch + n];
#pragma unroll
    for (int j = 0; j < SW; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n)
        acc[j][n] = FIRST && kw == 0 ? v[j][n] * wv[n] : fmaf(v[j + kw][n], wv[n], acc[j][n]);
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS, 2)
dw3_fwd_kernel(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
               const float* __restrict__ w, T* __restrict__ y, const Geo g) {
  constexpr int N = Lane<T>::N;
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  extern __shared__ unsigned char smem_raw[];
  // [RING planes][27 x CH float weights][RING mbarriers], from a 128-byte
  // boundary (TMA's destination alignment)
  unsigned char* smem = smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128);
  const int tw = SW * g.strips, ph = g.rows + 2, pw = tw + 2;
  const int plane = ph * pw * CH;  // elements of one staged plane
  T* ring = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(ring + (size_t)RING * plane);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ws + 27 * CH);

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
  const int n_planes = d1 - d0 + 2;  // z = d0 - 1 .. d1

  if (WIDE && threadIdx.x == 0) {
    for (int k = 0; k < RING; ++k) bar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto fetch = [&](int j) {  // stage plane j (z = d0 - 1 + j) into buffer j % RING
    if (j >= n_planes) return;
    if constexpr (WIDE) {
      if (threadIdx.x == 0)
        tma_plane(ring + (j % RING) * plane, &map, c0, w0 - 1, h0 - 1, d0 - 1 + j, b,
                  bars + j % RING, plane * sizeof(T));
    } else {
      stage_narrow<T>(ring + (j % RING) * plane, x, b, d0 - 1 + j, h0 - 1, w0 - 1, ph, pw, c0, g);
    }
  };
  for (int j = 0; j < RING - 1; ++j) fetch(j);
  for (int i = threadIdx.x; i < 27 * CH; i += blockDim.x) {
    const int c = c0 + i % CH;
    ws[i] = c < g.C ? round_to<T>(w[(size_t)(i / CH) * g.C + c]) : 0.f;
  }

  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int r = warp / g.strips, s = warp % g.strips;
  const int h = h0 + r, wb = w0 + s * SW, c = c0 + lane * N;
  const bool mine = h < g.H && c < g.C;
  unsigned wmask = 0;  // bit j: position wb + j lies in the volume
#pragma unroll
  for (int j = 0; j < SW; ++j) wmask |= (wb + j < g.W ? 1u : 0u) << j;
  const float* wl = ws + lane * N;
  // sums of depth z' in acc[(z' - d0 + 1) % 3]: plane p (z = d0 - 1 + p)
  // adds to depths z - 1, z, z + 1, and depth z - 1 is then complete
  float acc[3][SW][N];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < SW; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[a][j][n] = 0.f;

  auto step = [&](int p, float (&a_prev)[SW][N], float (&a_cur)[SW][N],
                  float (&a_next)[SW][N]) {
    if constexpr (WIDE) bar_wait(bars + p % RING, (p / RING) & 1);  // plane p has landed
    __syncthreads();  // every thread is past plane p - 1: its buffer is free
    fetch(p + RING - 1);

    // every plane adds to all three depths, without branches (sums for
    // depths outside the run are never stored); depth z + 1 starts here
    const int z = d0 - 1 + p;
    const T* pl = ring + (p % RING) * plane + (size_t)(r * pw + s * SW) * CH + lane * N;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[ROW][N];
#pragma unroll
      for (int i = 0; i < ROW; ++i) lds(pl + (size_t)(kh * pw + i) * CH, v[i]);
      taps<N>(a_prev, v, wl + (18 + kh * 3) * CH, CH);  // kd = 2
      taps<N>(a_cur, v, wl + (9 + kh * 3) * CH, CH);    // kd = 1
      if (kh == 0)
        taps<N, true>(a_next, v, wl, CH);               // kd = 0
      else
        taps<N>(a_next, v, wl + (kh * 3) * CH, CH);
    }
    if (z - 1 >= d0 && mine) {  // depth z - 1 is complete
      T* out = y + (((((size_t)b * g.D + z - 1) * g.H + h) * g.W) + wb) * g.C + c;
#pragma unroll
      for (int j = 0; j < SW; ++j, out += g.C)
        if (wmask & (1u << j)) stg<WIDE>(out, a_prev[j], g.C - c);
    }
  };
  // three planes an iteration, so that the roles of the sums rotate by name
  // and no register is copied
  for (int p0 = 0; p0 < n_planes; p0 += 3) {
    step(p0, acc[2], acc[0], acc[1]);
    if (p0 + 1 < n_planes) step(p0 + 1, acc[0], acc[1], acc[2]);
    if (p0 + 2 < n_planes) step(p0 + 2, acc[1], acc[2], acc[0]);
  }
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

template <typename T, bool WIDE>
int launch(const void* x, const float* w, void* y, const Geo& g, cudaStream_t stream) {
  constexpr int CH = CHUNK_BYTES / sizeof(T);
  const int tw = SW * g.strips;
  const size_t plane_bytes = (size_t)(g.rows + 2) * (tw + 2) * CHUNK_BYTES;
  const size_t smem = RING * plane_bytes + 27 * CH * 4 + RING * 8 + 128;
  const int threads = LANES * g.rows * g.strips;
  const long long blocks = (long long)g.n_chunks * g.tiles_h * g.tiles_w * g.runs * g.B;
  if (smem > MAX_SMEM || threads > MAX_THREADS || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (WIDE) {  // (C, W, H, D, B), innermost first; the box is one halo'd plane tile
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t es = sizeof(T);
    const cuuint64_t dims[5] = {(cuuint64_t)g.C, (cuuint64_t)g.W, (cuuint64_t)g.H,
                                (cuuint64_t)g.D, (cuuint64_t)g.B};
    const cuuint64_t strides[4] = {g.C * es, (cuuint64_t)g.W * g.C * es,
                                   (cuuint64_t)g.H * g.W * g.C * es,
                                   (cuuint64_t)g.D * g.H * g.W * g.C * es};
    const cuuint32_t box[5] = {(cuuint32_t)CH, (cuuint32_t)(tw + 2), (cuuint32_t)(g.rows + 2),
                               1, 1};
    const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
    const CUresult r = encode(
        &map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
        5, const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {  // opt in (per device, so on every such call)
    cudaError_t e = cudaFuncSetAttribute(dw3_fwd_kernel<T, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dw3_fwd_kernel<T, WIDE><<<(unsigned)blocks, threads, smem, stream>>>(
      map, static_cast<const T*>(x), w, static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. wide != 0 selects the TMA staging (the
// caller checks C and the pointers). rows, strips and depth_run are the plan
// of ops/dwconv.py:_dw_plan. device is the operands' card: it is made
// current first, since cuTensorMapEncodeTiled needs the card's context
// current in the calling thread (autograd's threads may not have it).
// Returns a CUDA error code (0 = launched).
extern "C" int rsuper_dw3(const void* x, const void* w, void* y, int B, int D, int H, int W,
                          int C, int dtype, int wide, int rows, int strips, int depth_run,
                          int device, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows < 1 || strips < 1 || depth_run < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)B * D * H * W * C == 0) return 0;
  const int ch = dtype == 0 ? CHUNK_BYTES / 4 : CHUNK_BYTES / 2;
  Geo g{B, D, H, W, C, rows, strips, depth_run, (C + ch - 1) / ch, (H + rows - 1) / rows,
        (W + SW * strips - 1) / (SW * strips), (D + depth_run - 1) / depth_run};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    return wide ? launch<float, true>(x, wf, y, g, s) : launch<float, false>(x, wf, y, g, s);
  return wide ? launch<__nv_bfloat16, true>(x, wf, y, g, s)
              : launch<__nv_bfloat16, false>(x, wf, y, g, s);
}

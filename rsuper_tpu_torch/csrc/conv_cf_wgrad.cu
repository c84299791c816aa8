// Weight gradient of the SAME 3x3x3 convolution on depth-major channel-first
// operands, plain and with the fused instance-norm + ReLU prologue. CUDA C++
// for sm_90a.
//
// Replaces the TPU kernels of rsuper_tpu/ops/conv_cf.py: _wgrad_pallas
// (_wgrad_kernel, _wgrad_kernel_d/_e/_f, _wgrad_kernel_ht, _wgrad_kernel_ht_d),
// reached from _conv3_cf_bwd and, with the stats operand, _in_relu_conv_bwd.
//
//   x       (B, D, Ci, H, W)   float or bf16
//   dy      (B, D, Co, H, W)   x's type
//   stats   (B, 2, Ci)         float32 or null: [:, 0] = 1/sigma, [:, 1] = -mu/sigma
//   partial (S, 27, Ci, Co)    float32 scratch, every element written
//                              (the stem: (S + ceil(S/16), 27, Co))
//   counter                    int32, the stem's arrival counters
//   dw      (27, Ci, Co)       float32
//
//   dw[kd,kh,kw,ci,co] = sum over b,d,h,w of
//       dy[b,d,co,h,w] * a[b,d+kd-1,ci,h+kh-1,w+kw-1]
//   a = x, or with stats a = relu(x*scale+shift) rounded to x's type; a is 0
//   outside the volume (the prologue is applied to in-volume values only, as
//   the forward kernel of conv_cf.cu stages them).
//
// What bounds it: the same 54 operations per channel pair and voxel as the
// forward, against one read of x and dy, so the card's arithmetic rate bounds
// it (bf16 tensor cores: 989 TFLOP/s). The stem (Ci = 1) does 54 operations
// per element of dy it reads: its reading of dy bounds it (3.35 TB/s).
//
// The sum runs over B*D*H*W positions, far more than one block can take,
// and blocks cannot carry a sum from one to the next as the TPU grid does.
// So the grid is (spatial split s of S, C_in tile x C_out tile): a block
// walks its share of the output tiles and keeps its sums; at the end it
// writes them to partial[s], and a second kernel sums the S partials in a
// fixed order, so dw is the same from run to run (no atomics); the stem's
// route sums them in the same launch. Three routes, chosen by the wrapper
// from (dtype, Ci) alone:
//
// route 1, tensor cores (bf16, Ci >= 16): per tap a GEMM with M = 16 input
// channels, N = 32 output channels, K = positions, on mma.sync.m16n8k16
// (bf16 in, float32 accumulate). A tile is 8 x 16 outputs of one depth row;
// tiles are numbered depth innermost and a block takes a contiguous run of
// them, so it walks down columns of tiles. Shared memory holds a ring of
// four planes of a (one-voxel halo, channels innermost, padded to 24 bf16)
// and two dy tiles ([co][h][w], padded). Along a column each tile needs one
// new plane of a and its own dy tile: both are loaded while the current
// tile's MMAs run (a through registers, with the prologue applied; dy by
// cp.async when W % 8 == 0). Each of the 9 warps owns one (kd, kh) and the
// three kw taps: a tap's A operand is the plane at ring slot (d + kd - 1)
// read at shifted row addresses (ldmatrix .trans), its B operand the dy
// tile (ldmatrix), so one staged plane serves nine taps. The MMAs sum one
// tile (8 k16 steps); each tile's sums are then added in float32 to the
// thread's own slots in shared memory: MMA accumulation over a whole
// block's share strayed from a float64 sum much further than float32 sums
// do (chip_smoke.py records both distances for every bf16 wgrad shape).
//
// route 2, the stem (bf16, Ci = 1; the JAX package's form "f",
// _wgrad_kernel_f): dwT (Co x 32 taps) += dy (Co x positions) x patch
// (positions x 32 taps), taps 27..31 zero, on mma.sync. Blocks march down
// columns of 8 x 32 output tiles through a ring of input planes staged at
// the three kw shifts (one plane a tile) and two dy tiles, the next loaded
// by cp.async during the current tile's MMAs (a third tile in flight
// measured no faster); both operands go to the MMA by ldmatrix. Each
// tile row's MMA sums (two k16 steps) are added to float32 sums in
// registers. One launch: each block writes a (27, Co) partial, and integer
// arrival counters pick the last block of each group of 16, then the last
// group summer, to sum them in index order (as dwconv_bwd.cu does).
//
// route 0, CUDA cores (float32, and bf16 with 2 <= Ci <= 15): 4x16 output tiles,
// tile t = s, s+S, ...; for each it stages the dy tile (32 output channels)
// and the three depth planes of the a tile with a one-voxel halo (16 input
// channels, or 4 for the stem) in shared memory, channel innermost. A thread
// owns one (kd, kh), 4 input and 4 output channels: 3 taps x 4 x 4 float32
// accumulators. Along a tile row it reads one float4 of dy and one new
// float4 of a per position (the other two kw columns slide in registers)
// for 48 multiply-adds.
//
// The tensor-core prologue rounds a * scale before adding shift, as the
// plain version does; the CUDA-core route keeps its fused multiply-add.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TH = 4;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int TCO = 32;  // output channels per block
constexpr int KK = 9;    // (kd, kh) pairs, one per thread group
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int PCO = TCO + 4;  // padded channel stride (keeps 16-byte alignment)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void fma44(float (&acc)[4][4], const float4& a, const float4& g) {
  acc[0][0] = fmaf(a.x, g.x, acc[0][0]);
  acc[0][1] = fmaf(a.x, g.y, acc[0][1]);
  acc[0][2] = fmaf(a.x, g.z, acc[0][2]);
  acc[0][3] = fmaf(a.x, g.w, acc[0][3]);
  acc[1][0] = fmaf(a.y, g.x, acc[1][0]);
  acc[1][1] = fmaf(a.y, g.y, acc[1][1]);
  acc[1][2] = fmaf(a.y, g.z, acc[1][2]);
  acc[1][3] = fmaf(a.y, g.w, acc[1][3]);
  acc[2][0] = fmaf(a.z, g.x, acc[2][0]);
  acc[2][1] = fmaf(a.z, g.y, acc[2][1]);
  acc[2][2] = fmaf(a.z, g.z, acc[2][2]);
  acc[2][3] = fmaf(a.z, g.w, acc[2][3]);
  acc[3][0] = fmaf(a.w, g.x, acc[3][0]);
  acc[3][1] = fmaf(a.w, g.y, acc[3][1]);
  acc[3][2] = fmaf(a.w, g.z, acc[3][2]);
  acc[3][3] = fmaf(a.w, g.w, acc[3][3]);
}

template <typename T, int TCI, bool FUSE>
__global__ void __launch_bounds__(KK * (TCI / 4) * (TCO / 4))
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ stats, float* __restrict__ partial, int B, int D,
             int Ci, int Co, int H, int W, int tiles_h, int tiles_w, int co_tiles, int S) {
  constexpr int PCI = TCI + 4;
  constexpr int CIG = TCI / 4;
  constexpr int COG = TCO / 4;
  __shared__ __align__(16) float xs[3][IH][IW][PCI];
  __shared__ __align__(16) float dys[TH][TW][PCO];

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int ci0 = (blockIdx.y / co_tiles) * TCI;
  const int co0 = (blockIdx.y % co_tiles) * TCO;
  const int cog = tid % COG;
  const int cig = (tid / COG) % CIG;
  const int kk = tid / (COG * CIG);
  const int kd = kk / 3, kh = kk % 3;

  float acc[3][4][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][i][j] = 0.f;

  const size_t HW = (size_t)H * W;
  const long long ntiles = (long long)B * D * tiles_h * tiles_w;
  for (long long t = s; t < ntiles; t += S) {
    const int w0 = (int)(t % tiles_w) * TW;
    long long u = t / tiles_w;
    const int h0 = (int)(u % tiles_h) * TH;
    u /= tiles_h;
    const int d = (int)(u % D);
    const int b = (int)(u / D);

    for (int i = tid; i < 3 * TCI * IH * IW; i += blockDim.x) {
      const int col = i % IW;
      int q = i / IW;
      const int row = q % IH;
      q /= IH;
      const int c = q % TCI;
      const int pd = q / TCI;
      const int dd = d + pd - 1, hh = h0 + row - 1, ww = w0 + col - 1;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < Ci && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        v = to_f(x[(((size_t)b * D + dd) * Ci + ci) * HW + (size_t)hh * W + ww]);
        if (FUSE) {
          const float scale = stats[((size_t)b * 2) * Ci + ci];
          const float shift = stats[((size_t)b * 2 + 1) * Ci + ci];
          v = to_f(from_f<T>(fmaxf(fmaf(v, scale, shift), 0.f)));
        }
      }
      xs[pd][row][col][c] = v;
    }
    for (int i = tid; i < TCO * TH * TW; i += blockDim.x) {
      const int col = i % TW;
      int q = i / TW;
      const int row = q % TH;
      const int c = q / TH;
      const int hh = h0 + row, ww = w0 + col, co = co0 + c;
      float v = 0.f;
      if (co < Co && hh < H && ww < W)
        v = to_f(dy[(((size_t)b * D + d) * Co + co) * HW + (size_t)hh * W + ww]);
      dys[row][col][c] = v;
    }
    __syncthreads();

    const int dd = d + kd - 1;
    if (dd >= 0 && dd < D) {  // else this thread's plane of a is all zero
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const float* xrow = &xs[kd][r + kh][0][cig * 4];
        float4 a0 = *reinterpret_cast<const float4*>(xrow);
        float4 a1 = *reinterpret_cast<const float4*>(xrow + PCI);
#pragma unroll 4
        for (int c = 0; c < TW; ++c) {
          const float4 a2 = *reinterpret_cast<const float4*>(xrow + (c + 2) * PCI);
          const float4 g = *reinterpret_cast<const float4*>(&dys[r][c][cog * 4]);
          fma44(acc[0], a0, g);
          fma44(acc[1], a1, g);
          fma44(acc[2], a2, g);
          a0 = a1;
          a1 = a2;
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + (size_t)s * 27 * Ci * Co;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + cig * 4 + i;
      if (ci >= Ci) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + cog * 4 + j;
        if (co < Co) out[((size_t)(kk * 3 + kw) * Ci + ci) * Co + co] = acc[kw][i][j];
      }
    }
}

// dw[i] = partial[0][i] + partial[1][i] + ... in that order.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                    int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += partial[(size_t)s * n + i];
  dw[i] = acc;
}

template <typename T, int TCI>
void launch(const void* x, const void* dy, const float* stats, float* partial, int B, int D,
            int Ci, int Co, int H, int W, int S, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int ci_tiles = (Ci + TCI - 1) / TCI;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const dim3 grid(S, ci_tiles * co_tiles);
  const dim3 block(KK * (TCI / 4) * (TCO / 4));
  if (stats != nullptr) {
    wgrad_kernel<T, TCI, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), stats, partial, B, D, Ci, Co, H,
        W, tiles_h, tiles_w, co_tiles, S);
  } else {
    wgrad_kernel<T, TCI, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), nullptr, partial, B, D, Ci, Co,
        H, W, tiles_h, tiles_w, co_tiles, S);
  }
}

template <typename T>
void launch_t(const void* x, const void* dy, const float* stats, float* partial, int B, int D,
              int Ci, int Co, int H, int W, int S, cudaStream_t stream) {
  if (Ci <= 4)
    launch<T, 4>(x, dy, stats, partial, B, D, Ci, Co, H, W, S, stream);
  else
    launch<T, 16>(x, dy, stats, partial, B, D, Ci, Co, H, W, S, stream);
}

// ------------------------------------------------------------ tensor cores
namespace tc {

constexpr int TH = 8, TW = 16;     // outputs of a tile: one k16 step a tile row
constexpr int TCI = 16, TCO = 32;  // channels of a block: one m16, four n8 fragments
constexpr int CKP = TCI + 8;       // padded channel stride of a staged voxel of a (48 bytes)
constexpr int IH = TH + 2, IW = TW + 2;
constexpr int NP = IH * IW;        // voxels of a staged plane of a
constexpr int TP = TH * TW;        // outputs of a tile
constexpr int DYP = TP + 8;        // padded position stride of a staged dy channel (272 bytes)
constexpr int WARPS = 9;           // one (kd, kh) each
constexpr int THREADS = 32 * WARPS;
constexpr int SLOTS = 4;           // ring of a planes: three in use, one being filled
constexpr int PLANE = NP * CKP;    // bf16 of a staged plane of a
constexpr int DYBUF = TCO * DYP;   // bf16 of a staged dy tile
constexpr int NACC = 3 * 4;        // float4 sums of a thread: 3 taps x 4 n-fragments
static_assert(NP <= THREADS, "one voxel of a plane per thread");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float bf_lo(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {  // round to nearest even
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// relu(x * scale + shift), the product rounded before the sum as the plain
// version rounds it (an fma would round the bf16 activation differently)
__device__ __forceinline__ float norm_relu(float x, float scale, float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(x, scale), shift), 0.f);
}

// Tiles are numbered depth innermost, and block s takes the contiguous run
// [T s / S, T (s + 1) / S): along a column of tiles the next tile needs one
// new plane of a (ring slot dd & 3) and its own dy tile, both loaded while
// the current tile's MMAs run. dy goes by cp.async in its own layout,
// [co][h][w], when W % 8 == 0 (vec), else through registers.
template <bool FUSE>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_tc_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
                const float* __restrict__ stats, float* __restrict__ partial, int B, int D,
                int Ci, int Co, int H, int W, int tiles_h, int tiles_w, int co_tiles, int S,
                int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [SLOTS][IH][IW][CKP]
  __nv_bfloat16* ds = as + SLOTS * PLANE;                           // [2][TCO][DYP]
  float4* sacc = reinterpret_cast<float4*>(ds + 2 * DYBUF);         // [WARPS][NACC][32]
  float* sst = reinterpret_cast<float*>(sacc + WARPS * NACC * 32);  // [B][2][TCI]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kd = warp / 3, kh = warp % 3;
  const int s = blockIdx.x;
  const int ci0 = (blockIdx.y / co_tiles) * TCI;
  const int co0 = (blockIdx.y % co_tiles) * TCO;
  const size_t HW = (size_t)H * W;

  if (FUSE) {  // padded channels get scale = shift = 0, so they stay 0
    for (int i = tid; i < B * 2 * TCI; i += THREADS) {
      const int c = i % TCI;
      sst[i] = ci0 + c < Ci ? stats[(size_t)(i / TCI) * Ci + ci0 + c] : 0.f;
    }
    __syncthreads();
  }

  // The MMAs sum one tile (128 positions) in acc; each tile's acc is then
  // added in float32 to the thread's own slots in shared memory, so no MMA
  // accumulator runs over more than 8 k16 steps.
  float4* mine = sacc + warp * NACC * 32 + lane;
#pragma unroll
  for (int k = 0; k < NACC; ++k) mine[k * 32] = make_float4(0.f, 0.f, 0.f, 0.f);

  // a: one voxel of a plane per thread, 16 channels
  const int prow = tid / IW, pcol = tid % IW;
  unsigned xv[TCI];
  bool xin = false;
  auto load_plane = [&](int b, int dd, int h0, int w0) {
    const int hh = h0 + prow - 1, ww = w0 + pcol - 1;
    xin = tid < NP && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const unsigned short* src =
        x + (xin ? (((size_t)b * D + dd) * Ci + ci0) * HW + (size_t)hh * W + ww : 0);
#pragma unroll
    for (int c = 0; c < TCI; ++c)
      xv[c] = xin && ci0 + c < Ci ? __ldg(src + (size_t)c * HW) : 0u;
  };
  auto store_plane = [&](int b, int dd) {
    if (tid >= NP) return;
    unsigned v[TCI / 2];
#pragma unroll
    for (int j = 0; j < TCI / 2; ++j) {
      v[j] = xv[2 * j] | (xv[2 * j + 1] << 16);
      if (FUSE && xin) {
        const float* sc = sst + b * 2 * TCI;
        v[j] = bf_pack(norm_relu(bf_lo(v[j]), sc[2 * j], sc[TCI + 2 * j]),
                       norm_relu(bf_hi(v[j]), sc[2 * j + 1], sc[TCI + 2 * j + 1]));
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(as + (dd & (SLOTS - 1)) * PLANE + tid * CKP);
    dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
  };
  // dy of the tile at (b, d, h0, w0) into buf, [co][h][w]
  auto stage_dy = [&](int b, int d, int h0, int w0, __nv_bfloat16* buf) {
    if (vec) {  // 16-byte pieces of 8 outputs along W
      for (int i = tid; i < TCO * TH * (TW / 8); i += THREADS) {
        const int q = i % (TW / 8), r = (i / (TW / 8)) % TH, c = i / (TW / 8 * TH);
        const int hh = h0 + r, ww = w0 + q * 8, co = co0 + c;
        const bool ok = co < Co && hh < H && ww < W;
        const unsigned short* src =
            ok ? dy + (((size_t)b * D + d) * Co + co) * HW + (size_t)hh * W + ww : dy;
        cp_async16(buf + c * DYP + r * TW + q * 8, src, ok);
      }
      cp_async_commit();
    } else {
      unsigned short* dst = reinterpret_cast<unsigned short*>(buf);
      for (int i = tid; i < TCO * TP; i += THREADS) {
        const int p = i % TP, c = i / TP;
        const int hh = h0 + p / TW, ww = w0 + p % TW, co = co0 + c;
        dst[c * DYP + p] =
            co < Co && hh < H && ww < W
                ? __ldg(dy + (((size_t)b * D + d) * Co + co) * HW + (size_t)hh * W + ww)
                : (unsigned short)0;
      }
    }
  };
  // this warp's three taps over the tile at depth d, dy in buf
  auto compute = [&](int d, const __nv_bfloat16* buf) {
    const int dd = d + kd - 1;
    if (dd < 0 || dd >= D) return;  // this warp's plane of a is all zero
    float acc[3][4][4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][n][q] = 0.f;
    const __nv_bfloat16* ap = as + (dd & (SLOTS - 1)) * PLANE;
#pragma unroll 2
    for (int r = 0; r < TH; ++r) {  // k16 step: the 16 outputs of tile row r
      unsigned bf[2][4];  // dy: n16 x k16, n-fragments 2j and 2j + 1
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(bf[j], buf + (j * 16 + (lane >> 4) * 8 + (lane & 7)) * DYP + r * TW +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        unsigned a[4];  // a: m16 (channels) x k16 (positions shifted by the tap)
        ldsm_x4_t(a, ap + ((r + kh) * IW + (lane >> 4) * 8 + (lane & 7) + kw) * CKP +
                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[kw][2 * j], a, bf[j][0], bf[j][1]);
          mma_bf16(acc[kw][2 * j + 1], a, bf[j][2], bf[j][3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float4 t = mine[(k * 4 + n) * 32];
        t.x += acc[k][n][0], t.y += acc[k][n][1], t.z += acc[k][n][2], t.w += acc[k][n][3];
        mine[(k * 4 + n) * 32] = t;
      }
  };

  const long long T = (long long)B * D * tiles_h * tiles_w;
  const long long t0 = T * s / S, t1 = T * (s + 1) / S;
  int cur = 0;
  bool fresh = true;
  for (long long t = t0; t < t1; ++t) {
    const int d = (int)(t % D);
    long long col = t / D;
    const int w0 = (int)(col % tiles_w) * TW;
    col /= tiles_w;
    const int h0 = (int)(col % tiles_h) * TH;
    const int b = (int)(col / tiles_h);
    if (fresh) {  // a new column: the three planes around d, and dy
      stage_dy(b, d, h0, w0, ds + cur * DYBUF);
      for (int k = -1; k <= 1; ++k) {
        load_plane(b, d + k, h0, w0);
        store_plane(b, d + k);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const bool next = t + 1 < t1 && d + 1 < D;  // the next tile is one depth row on
    if (next) {
      stage_dy(b, d + 1, h0, w0, ds + (cur ^ 1) * DYBUF);
      load_plane(b, d + 2, h0, w0);
    }
    compute(d, ds + cur * DYBUF);
    if (next) {
      store_plane(b, d + 2);
      cp_async_wait_all();
      cur ^= 1;
    }
    __syncthreads();
    fresh = !next;
  }

  float* out = partial + (size_t)s * 27 * Ci * Co;
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float4 t = mine[(kw * 4 + n) * 32];
      const float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = ci0 + (lane >> 2) + (q >> 1) * 8;
        const int co = co0 + n * 8 + (lane & 3) * 2 + (q & 1);
        if (ci < Ci && co < Co)
          out[((size_t)((kd * 3 + kh) * 3 + kw) * Ci + ci) * Co + co] = v[q];
      }
    }
}

template <bool FUSE>
int launch_fuse(const void* x, const void* dy, const float* stats, float* partial, int B, int D,
                int Ci, int Co, int H, int W, int S, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const int ci_tiles = (Ci + TCI - 1) / TCI;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const size_t smem = (SLOTS * PLANE + 2 * DYBUF) * sizeof(__nv_bfloat16) +
                      WARPS * NACC * 32 * sizeof(float4) +
                      (FUSE ? B * 2 * TCI * sizeof(float) : 0);
  auto kernel = wgrad_tc_kernel<FUSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(S, ci_tiles * co_tiles), THREADS, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(dy), stats,
      partial, B, D, Ci, Co, H, W, tiles_h, tiles_w, co_tiles, S, W % 8 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ------------------------------------------------------- the stem (Ci = 1)
namespace stem {

constexpr int TH = 8, TW = 32;   // outputs of a tile: a warp a row, two k16 steps a row
constexpr int TCO = 32;          // output channels of a block: two m16 fragments
constexpr int THREADS = 32 * TH;
constexpr int IH = TH + 2;       // staged rows of a plane (one-row halo)
constexpr int HALO = IH * (TW + 2);
constexpr int PER = (HALO + THREADS - 1) / THREADS;
constexpr int RS = TW + 8;       // row stride of a staged copy: 80 bytes, 16-byte aligned
constexpr int COPY = IH * RS;
constexpr int PLANE = 3 * COPY;  // the plane at the three kw shifts
constexpr int SLOTS = 4;         // ring: three planes in use, one being filled
constexpr int DYP = TH * TW + 8; // padded position stride of a staged dy channel (528 bytes)
constexpr int DYBUF = TCO * DYP;
constexpr int DYS = 2;           // dy tiles: one in use, one in flight
constexpr int NSUM = 2 * 4 * 4;  // float32 sums of a thread: 2 m16 x 4 n8 fragments
constexpr int GROUP = 16;        // partials summed a group at a time (ops/conv_cf.py: STEM_GROUP)
static_assert(THREADS * NSUM * sizeof(float) <= DYS * DYBUF * sizeof(__nv_bfloat16),
              "the warps' sums fit in the dy buffers");

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  tc::mma_bf16(c, a, b0, b1);  // stem MMA
}

__device__ __forceinline__ unsigned short norm_relu(unsigned short v, float scale,
                                                    float shift) {
  const float f = fmaxf(__fadd_rn(__fmul_rn(__uint_as_float((unsigned)v << 16), scale), shift),
                        0.f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// out[tap][co] (27 x Co, the block's TCO columns) = rows[0] + rows[1] + ...
// + rows[n - 1], each row 27 x Co, summed in that order
__device__ __forceinline__ void sum_rows(const float* rows, int n, float* out, int n0,
                                         int Co) {
  const size_t row = (size_t)27 * Co;
  for (int e = threadIdx.x; e < 27 * TCO; e += THREADS) {
    const int co = n0 + e % TCO;
    if (co >= Co) continue;
    const size_t i = (size_t)(e / TCO) * Co + co;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += __ldcg(rows + k * row + i);
    out[i] = acc;
  }
}

// dwᵀ[co][tap] = sum over positions of dy[co][pos] * patch[pos][tap]: per
// tile a warp takes its tile row, M = TCO channels (A: the staged dy tile by
// ldmatrix), N = 32 taps (B: the planes staged at three kw shifts, by
// ldmatrix, taps 27..31 reading a zeroed block), K = the row's 32 positions.
// Tiles are numbered depth innermost and block s of a C_out tile takes the
// contiguous run [T s / S, T (s + 1) / S), so it marches down columns of
// tiles: the next tile needs one new plane of x and its own dy tile (by
// cp.async), both loaded during the current tile's MMAs. The warps' sums
// are added in a fixed
// order into a (27, Co) partial, and the last block of each group of GROUP,
// then the last group summer, sum the partials in index order (integer
// arrival counters, left at zero).
template <bool FUSE>
__global__ void __launch_bounds__(THREADS, 2)
stem_wgrad_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
                  const float* __restrict__ stats, float* __restrict__ partial,
                  int* __restrict__ counter, float* __restrict__ dw, int B, int D, int Co, int H,
                  int W, int tiles_h, int tiles_w, int vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(smem_raw);  // [SLOTS][3][IH][RS]
  __nv_bfloat16* ds = reinterpret_cast<__nv_bfloat16*>(ring + SLOTS * PLANE);  // [DYS][TCO][DYP]
  unsigned short* zero = reinterpret_cast<unsigned short*>(ds + DYS * DYBUF);  // 8 zeros
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int G = gridDim.x, s = blockIdx.x;
  const int n0 = blockIdx.y * TCO;
  const size_t HW = (size_t)H * W;
  int b = 0, h0 = 0, w0 = 0;  // the current tile's column
  const unsigned short* xb = x;
  float scale = 0.f, shift = 0.f;
  if (tid < 8) zero[tid] = 0;

  unsigned short xr[PER];
  auto load = [&](int dd) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int p = tid + q * THREADS;
      const int hh = h0 - 1 + p / (TW + 2), ww = w0 - 1 + p % (TW + 2);
      const bool ok =
          p < HALO && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
      unsigned short v = ok ? __ldg(xb + (size_t)dd * HW + (size_t)hh * W + ww) : 0;
      if (FUSE && ok) v = norm_relu(v, scale, shift);
      xr[q] = v;
    }
  };
  auto store = [&](int dd) {
    unsigned short* pl = ring + (dd & (SLOTS - 1)) * PLANE;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int p = tid + q * THREADS;
      if (p >= HALO) continue;
      const int row = p / (TW + 2), c = p % (TW + 2);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)  // copy kw holds column c at c - kw
        if (c - kw >= 0 && c - kw < TW) pl[kw * COPY + row * RS + c - kw] = xr[q];
    }
  };
  // dy of depth d into buf, [co][row][column], zero outside the volume
  auto stage_dy = [&](int d, __nv_bfloat16* buf) {
    const unsigned short* src0 = dy + ((size_t)b * D + d) * Co * HW;
    if (vec) {  // 16-byte pieces of 8 outputs along W
      for (int i = tid; i < TCO * TH * (TW / 8); i += THREADS) {
        const int q = i % (TW / 8), rr = i / (TW / 8) % TH, c = i / (TW / 8 * TH);
        const int hh = h0 + rr, ww = w0 + 8 * q, co = n0 + c;
        const bool ok = co < Co && hh < H && ww < W;
        tc::cp_async16(buf + c * DYP + rr * TW + 8 * q,
                       ok ? src0 + (size_t)co * HW + (size_t)hh * W + ww : dy, ok);
      }
      tc::cp_async_commit();
    } else {
      unsigned short* dst = reinterpret_cast<unsigned short*>(buf);
      for (int i = tid; i < TCO * TH * TW; i += THREADS) {
        const int p = i % (TH * TW), c = i / (TH * TW);
        const int hh = h0 + p / TW, ww = w0 + p % TW, co = n0 + c;
        dst[c * DYP + p] = co < Co && hh < H && ww < W
                               ? __ldg(src0 + (size_t)co * HW + (size_t)hh * W + ww)
                               : (unsigned short)0;
      }
    }
  };

  // this lane's ldmatrix rows: A (dy) row 16 mi + lane % 8 + 8 (lane / 8 % 2),
  // column 8 (lane / 16); B (patch) tap 16 jj + lane % 8 + 8 (lane / 16),
  // positions 8 (lane / 8 % 2) on
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * DYP + r * TW + (lane >> 4) * 8;
  int b_tap[2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) b_tap[jj] = 16 * jj + (lane & 7) + (lane >> 4) * 8;

  float sum[NSUM];
#pragma unroll
  for (int i = 0; i < NSUM; ++i) sum[i] = 0.f;

  const long long T = (long long)B * tiles_h * tiles_w * D;
  const long long t1 = T * (s + 1) / G;
  int cur = 0;  // the dy buffer of depth d
  bool fresh = true;
  for (long long t = T * s / G; t < t1; ++t) {
    const int d = (int)(t % D);
    const bool more = t + 1 < t1 && d + 1 < D;  // the next tile is one depth on
    if (fresh) {  // a new column: its three planes around d, and dy
      long long col = t / D;
      w0 = (int)(col % tiles_w) * TW;
      col /= tiles_w;
      h0 = (int)(col % tiles_h) * TH;
      b = (int)(col / tiles_h);
      xb = x + (size_t)b * D * HW;
      if (FUSE) scale = stats[2 * b], shift = stats[2 * b + 1];
      stage_dy(d, ds + cur * DYBUF);
      for (int k = -1; k <= 1; ++k) {
        load(d + k);
        store(d + k);
      }
      tc::cp_async_wait_all();
      __syncthreads();
    }
    if (more) {  // the next depth's dy and plane fly during this depth's MMAs
      stage_dy(d + 1, ds + (cur ^ 1) * DYBUF);
      load(d + 2);
    }
    const unsigned short* bp[2];
    int boff[2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int k = b_tap[jj];
      bp[jj] = zero;
      boff[jj] = 0;
      if (k < 27) {
        const int kd = k / 9, kh = k / 3 % 3, kw = k % 3;
        bp[jj] = ring + ((d + kd - 1) & (SLOTS - 1)) * PLANE + kw * COPY + (r + kh) * RS +
                 ((lane >> 3) & 1) * 8;
        boff[jj] = 16;
      }
    }
    const __nv_bfloat16* ap = ds + cur * DYBUF + a_off;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks) {  // k16 step: positions 16 ks .. 16 ks + 15
      unsigned am[2][4], bm[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) tc::ldsm_x4(am[mi], ap + mi * 16 * DYP + ks * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) tc::ldsm_x4(bm[jj], bp[jj] + ks * boff[jj]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma(acc[mi][2 * jj], am[mi], bm[jj][0], bm[jj][1]);
          mma(acc[mi][2 * jj + 1], am[mi], bm[jj][2], bm[jj][3]);
        }
    }
    // the row's MMA sums join the float32 sums
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[(mi * 4 + j) * 4 + q] += acc[mi][j][q];
    if (more) {
      store(d + 2);  // slot (d + 2) & 3 was last read at depth d - 1
      tc::cp_async_wait_all();
      cur ^= 1;
    }
    __syncthreads();
    fresh = !more;
  }

  // the warps' sums, added in warp order, into this block's partial
  float* red = reinterpret_cast<float*>(ds);  // [warp][NSUM][32]
#pragma unroll
  for (int i = 0; i < NSUM; ++i) red[(r * NSUM + i) * 32 + lane] = sum[i];
  __syncthreads();
  for (int e = tid; e < NSUM * 32; e += THREADS) {
    const int i = e / 32, ln = e % 32;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < TH; ++k) v += red[(k * NSUM + i) * 32 + ln];
    const int mi = i / 16, j = i / 4 % 4, q = i % 4;
    const int co = n0 + 16 * mi + (ln >> 2) + 8 * (q >> 1);
    const int tap = 8 * j + 2 * (ln & 3) + (q & 1);
    if (tap < 27 && co < Co) partial[((size_t)s * 27 + tap) * Co + co] = v;
  }

  // the G partials of this C_out tile, summed in two fixed-order levels
  const int NG = (G + GROUP - 1) / GROUP, grp = s / GROUP;
  int* cnt = counter + (size_t)blockIdx.y * (NG + 1);
  const size_t row = (size_t)27 * Co;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt + grp, 1) == min(GROUP, G - grp * GROUP) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (NG == 1) {
    sum_rows(partial, G, dw, n0, Co);
    if (tid == 0) cnt[0] = 0;
    return;
  }
  sum_rows(partial + grp * GROUP * row, min(GROUP, G - grp * GROUP), partial + (G + grp) * row,
           n0, Co);
  if (tid == 0) cnt[grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(cnt + NG, 1) == NG - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(partial + G * row, NG, dw, n0, Co);
  if (tid == 0) cnt[NG] = 0;
}

template <bool FUSE>
int launch_fuse(const void* x, const void* dy, const float* stats, float* partial, int* counter,
                float* dw, int B, int D, int Co, int H, int W, int S, cudaStream_t stream) {
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  if ((long long)S > (long long)B * tiles_h * tiles_w * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (SLOTS * PLANE + DYS * DYBUF + 8) * sizeof(unsigned short);
  auto kernel = stem_wgrad_kernel<FUSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(S, (Co + TCO - 1) / TCO), THREADS, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(dy), stats,
      partial, counter, dw, B, D, Co, H, W, tiles_h, tiles_w,
      W % 8 == 0 && reinterpret_cast<size_t>(dy) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = CUDA cores, 1 = tensor cores
// (bf16 only), 2 = the stem (bf16, Ci = 1). stats may be null (no
// prologue). S is the number of spatial splits (>= 1). Routes 0 and 1:
// partial holds S * 27 * Ci * Co floats, a second kernel sums them, and
// counter is not read. Route 2: one launch of S blocks a C_out tile (at most
// one a tile of 8 x 32 outputs of one depth row); partial holds (S +
// ceil(S/16)) * 27 * Co floats, counter ceil(Co/32) * (ceil(S/16) + 1) ints,
// zero before the call and after it. Returns cudaGetLastError() after the
// launches.
extern "C" int rsuper_conv3_cf_wgrad(const void* x, const void* dy, const void* stats,
                                     void* partial, void* counter, void* dw, int B, int D,
                                     int Ci, int Co, int H, int W, int S, int dtype, int route,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(stats);
  float* pf = static_cast<float*>(partial);
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 2) {
    if (dtype != 1 || Ci != 1) return static_cast<int>(cudaErrorInvalidValue);
    int* cnt = static_cast<int*>(counter);
    float* out = static_cast<float*>(dw);
    return sf != nullptr
               ? stem::launch_fuse<true>(x, dy, sf, pf, cnt, out, B, D, Co, H, W, S, st)
               : stem::launch_fuse<false>(x, dy, sf, pf, cnt, out, B, D, Co, H, W, S, st);
  }
  int err;
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    err = sf != nullptr
              ? tc::launch_fuse<true>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st)
              : tc::launch_fuse<false>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st);
  } else if (route == 0 && dtype == 0) {
    launch_t<float>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st);
    err = static_cast<int>(cudaGetLastError());
  } else if (route == 0 && dtype == 1) {
    launch_t<__nv_bfloat16>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st);
    err = static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return err;
  const int n = 27 * Ci * Co;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, static_cast<float*>(dw), n, S);
  return static_cast<int>(cudaGetLastError());
}

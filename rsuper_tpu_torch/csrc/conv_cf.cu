// SAME 3x3x3 convolution on depth-major channel-first operands, with an
// optional fused instance-norm + ReLU prologue. CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of rsuper_tpu/ops/conv_cf.py: _conv3_cf_pallas
// (_fwd_kernel, _fwd_kernel_d/_e/_f/_g, _fwd_kernel_ht, _fwd_kernel_ht_d),
// reached through conv3x3x3_cf and, with the stats operand, through
// in_relu_conv3x3x3_cf (_norm_relu_row applied at row load). On flipped
// weights it is the input gradient of both (conv3x3x3_cf_dgrad).
//
//   x     (B, D, Ci, H, W)   float or bf16
//   w     route 0: (27, Ci, Co) float32, already rounded to x's type
//         route 1: (27, Cip, Cop) bf16, Ci padded to 16 and Co to 8 with 0
//         route 2: (27, Co) bf16 (Ci = 1)
//   stats (B, 2, Ci)         float32: [:, 0] = 1/sigma, [:, 1] = -mu/sigma
//   y     (B, D, Co, H, W)   x's type
//
// What bounds it: 54 operations per input-output channel pair and voxel.
// At the production shapes (Ci, Co = 32..192) the work is several hundred
// operations per byte moved, so the card's arithmetic rate bounds it (bf16
// tensor cores: 989 TFLOP/s), not its memory. The stem (Ci = 1, Co = 32)
// does 54 operations per output element it writes: its bf16 output bounds
// it (3.35 TB/s).
//
// Three routes, chosen by the wrapper from (dtype, Ci) alone:
//
// route 1, tensor cores (bf16, Ci >= 16): an implicit GEMM with M = output
// voxels, N = Co, K = 27 taps x Ci, on mma.sync.m16n8k16 (bf16 in, float32
// accumulate). A block owns TH x 16 outputs of one depth row and TN output
// channels; its K loop runs over (16-channel chunk, kd) steps. Each step
// stages one depth plane of the input tile with a one-voxel halo in shared
// memory channel-innermost, [h][w][ci] with the ci stride padded to 24 bf16,
// and the step's 9 x 16 x TN weight slice. A tap's A operand is then the
// same staged plane read at shifted row addresses (every row 48-byte aligned,
// so ldmatrix takes it): the 9 taps of a plane reuse one staged tile. The
// plane goes through registers (loads coalesced along W, the prologue
// applied, written transposed), the weights by cp.async; the next step's
// loads are issued before the current step's MMAs (two stages). All Ci and
// all 27 taps accumulate in float32; the output is rounded once to bf16 on
// store through shared memory, with masked tails.
//
// route 2, the stem (bf16, Ci = 1; the JAX package's form "f",
// _fwd_kernel_f): all 27 taps in one contraction, y (Co x positions) =
// W (Co x 32 taps, padded with zero weights) x patch (32 x positions), two
// k16 steps of mma.sync. A block owns 8 x 32 outputs and 32 output channels
// over a run of depths, and keeps its weights in registers as A fragments.
// It marches in depth through a ring of four staged input planes (zero
// outside the volume), so each plane is staged once and serves three output
// depths. A plane is staged at the three kw shifts, so that a B fragment (8
// consecutive positions of 8 taps) is one ldmatrix .trans of 16-byte rows
// (a single copy read as bf16 values and packed ran slower and spilled more).
// The output tile is rounded once to bf16, staged in shared memory and
// stored as 16-byte vectors along W (storing the C fragments' bf16 pairs
// directly took three times as long); tails in H, W and Co are masked.
//
// route 0, CUDA cores (float32, and bf16 with 2 <= Ci <= 15): one block per
// (batch, depth row, 16x16 output tile, tile of Co). For each chunk of 4
// input channels it stages the three depth rows of the input tile plus a
// one-voxel halo (as float, with the prologue applied) and the matching
// 27 x 4 x TCO weight slice in shared memory. Each thread owns 4 consecutive
// outputs along W times 16 output channels in registers: per (channel, kd,
// kh) it reads 6 inputs and 12 float4 weight vectors (warp-wide broadcasts)
// for 192 FMAs, all in float32.
//
// Neither route splits Ci into separately rounded partial sums, as the TPU
// kernel does. The prologue applies relu(x * scale + shift) only to
// in-volume values while staging, and rounds the activation to x's type as
// _norm_relu_row does. Out-of-volume taps stay 0 in activation space (not
// relu(shift)). The tensor-core route rounds x * scale before adding shift,
// as the plain version does; the CUDA-core route keeps its fused
// multiply-add.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TH = 16;  // output tile rows
constexpr int TW = 16;  // output tile columns
constexpr int RW = 4;   // consecutive W outputs per thread
constexpr int RC = 16;  // output channels per thread
constexpr int CC = 4;   // input channels staged per step
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int SPATIAL_THREADS = TH * TW / RW;  // 64

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int TCO, bool FUSE>
__global__ void __launch_bounds__(SPATIAL_THREADS * (TCO / RC))
conv3_cf_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ stats, T* __restrict__ y,
                int D, int Ci, int Co, int H, int W, int tiles_w, int co_tiles) {
  __shared__ float xs[3][CC][IH][IW];
  __shared__ __align__(16) float ws[27][CC][TCO];

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int d = blockIdx.y;
  const int b = blockIdx.z / co_tiles;
  const int co0 = (blockIdx.z % co_tiles) * TCO;

  const int sp = tid % SPATIAL_THREADS;
  const int g = tid / SPATIAL_THREADS;  // output-channel group of this thread
  const int r = sp / (TW / RW);         // tile row
  const int cq = (sp % (TW / RW)) * RW; // first tile column

  float acc[RW][RC];
#pragma unroll
  for (int j = 0; j < RW; ++j)
#pragma unroll
    for (int o = 0; o < RC; ++o) acc[j][o] = 0.f;

  const size_t HW = (size_t)H * W;
  for (int c0 = 0; c0 < Ci; c0 += CC) {
    const int cn = min(CC, Ci - c0);
    for (int i = tid; i < 3 * CC * IH * IW; i += blockDim.x) {
      const int col = i % IW;
      int t = i / IW;
      const int row = t % IH;
      t /= IH;
      const int c = t % CC;
      const int kd = t / CC;
      const int dd = d + kd - 1, hh = h0 + row - 1, ww = w0 + col - 1;
      float v = 0.f;
      if (c < cn && dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W) {
        const int ci = c0 + c;
        v = to_f(x[(((size_t)b * D + dd) * Ci + ci) * HW + (size_t)hh * W + ww]);
        if (FUSE) {
          const float scale = stats[((size_t)b * 2) * Ci + ci];
          const float shift = stats[((size_t)b * 2 + 1) * Ci + ci];
          v = to_f(from_f<T>(fmaxf(fmaf(v, scale, shift), 0.f)));
        }
      }
      xs[kd][c][row][col] = v;
    }
    for (int i = tid; i < 27 * CC * TCO; i += blockDim.x) {
      const int co = i % TCO;
      const int t = i / TCO;
      const int c = t % CC;
      const int tap = t / CC;
      float v = 0.f;
      if (c < cn && co0 + co < Co) v = w[((size_t)tap * Ci + c0 + c) * Co + co0 + co];
      ws[tap][c][co] = v;
    }
    __syncthreads();

    for (int c = 0; c < cn; ++c) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          float in[RW + 2];
#pragma unroll
          for (int j = 0; j < RW + 2; ++j) in[j] = xs[kd][c][r + kh][cq + j];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4* wp =
                reinterpret_cast<const float4*>(&ws[(kd * 3 + kh) * 3 + kw][c][g * RC]);
#pragma unroll
            for (int q = 0; q < RC / 4; ++q) {
              const float4 wv = wp[q];
#pragma unroll
              for (int j = 0; j < RW; ++j) {
                const float a = in[j + kw];
                acc[j][4 * q + 0] = fmaf(a, wv.x, acc[j][4 * q + 0]);
                acc[j][4 * q + 1] = fmaf(a, wv.y, acc[j][4 * q + 1]);
                acc[j][4 * q + 2] = fmaf(a, wv.z, acc[j][4 * q + 2]);
                acc[j][4 * q + 3] = fmaf(a, wv.w, acc[j][4 * q + 3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + r;
  if (h >= H) return;
#pragma unroll
  for (int o = 0; o < RC; ++o) {
    const int co = co0 + g * RC + o;
    if (co < Co) {
      T* yp = y + (((size_t)b * D + d) * Co + co) * HW + (size_t)h * W;
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int ww = w0 + cq + j;
        if (ww < W) yp[ww] = from_f<T>(acc[j][o]);
      }
    }
  }
}

template <typename T, int TCO>
void launch(const void* x, const float* w, const float* stats, void* y, int B, int D,
            int Ci, int Co, int H, int W, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const dim3 grid(tiles_h * tiles_w, D, B * co_tiles);
  const dim3 block(SPATIAL_THREADS * (TCO / RC));
  if (stats != nullptr) {
    conv3_cf_kernel<T, TCO, true><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, stats, static_cast<T*>(y), D, Ci, Co, H, W, tiles_w,
        co_tiles);
  } else {
    conv3_cf_kernel<T, TCO, false><<<grid, block, 0, stream>>>(
        static_cast<const T*>(x), w, nullptr, static_cast<T*>(y), D, Ci, Co, H, W, tiles_w,
        co_tiles);
  }
}

template <typename T>
void launch_t(const void* x, const float* w, const float* stats, void* y, int B, int D,
              int Ci, int Co, int H, int W, cudaStream_t stream) {
  if (Co <= 32)
    launch<T, 32>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
  else
    launch<T, 64>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
}

// ------------------------------------------------------------ tensor cores
namespace tc {

constexpr int CK = 16;        // input channels of a staged chunk: one k16 step a tap
constexpr int CKP = CK + 8;   // padded channel stride of a staged voxel (48 bytes)
constexpr int TW = 16;        // output tile columns: one m16 fragment a tile row
constexpr int THREADS = 256;  // 8 warps

// A block owns TH x TW outputs of one depth row and TN output channels; its
// 8 warps split them WM x WN, each warp MF tile rows x WTN channels.
template <int TN>
struct Cfg {
  static constexpr int WN = TN == 32 ? 1 : 2;
  static constexpr int WM = 8 / WN;
  static constexpr int WTN = TN / WN;
  static constexpr int NF = WTN / 8;  // n8 fragments of a warp
  // m16 fragments of a warp, one a tile row: 4 at TN = 64 (a taller tile
  // stages fewer halo rows per output; on the card faster than 2 despite
  // about 200 bytes of spills), else 2
  static constexpr int MF = TN == 64 ? 4 : 2;
  static constexpr int TH = MF * WM;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int NP = IH * IW;  // staged voxels of one plane
  static constexpr int NPT = (NP + THREADS - 1) / THREADS;
  static constexpr int TNP = TN + 8;  // padded Co stride of a staged weight row
  static constexpr int XS = NP * CKP;       // bf16 of a staged plane
  static constexpr int WS = 9 * CK * TNP;   // bf16 of a staged weight slice
  static constexpr int STAGE = XS + WS;     // bf16 of one stage
  static constexpr int TM = TH * TW, TMP = TM + 8;  // output tile, padded
  static_assert(NF % 2 == 0, "B fragments are loaded in pairs");
  static_assert(TN * TMP <= 2 * STAGE, "the output tile fits in the stages");
};

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
// relu(x * scale + shift) of a bf16 pair, rounded to nearest even into a
// bf16 pair: the product is rounded before the sum as the plain version
// rounds it (an fma would round the bf16 activation differently), and the
// ReLU rides on the conversion (cvt .relu)
__device__ __forceinline__ unsigned norm_relu2(unsigned v, float s0, float h0, float s1,
                                               float h1) {
  const float lo = __fadd_rn(__fmul_rn(bf_lo(v), s0), h0);
  const float hi = __fadd_rn(__fmul_rn(bf_hi(v), s1), h1);
  unsigned d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

template <int TN, bool FUSE>
__global__ void __launch_bounds__(THREADS, 2)
conv3_tc_kernel(const unsigned short* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ stats, __nv_bfloat16* __restrict__ y, int D, int Ci,
                int Co, int H, int W, int Cip, int Cop, int tiles_w, int co_tiles) {
  using C = Cfg<TN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* sst = reinterpret_cast<float*>(smem + 2 * C::STAGE);  // [2][Cip]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int h0 = (blockIdx.x / tiles_w) * C::TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int d = blockIdx.y;
  const int b = blockIdx.z / co_tiles;
  const int n0 = (blockIdx.z % co_tiles) * TN;
  const size_t HW = (size_t)H * W;

  if (FUSE) {  // padded channels get scale = shift = 0, so they stay 0
    for (int i = tid; i < Cip; i += THREADS) {
      sst[i] = i < Ci ? stats[(size_t)b * 2 * Ci + i] : 0.f;
      sst[Cip + i] = i < Ci ? stats[((size_t)b * 2 + 1) * Ci + i] : 0.f;
    }
    __syncthreads();
  }

  // K steps: (16-channel chunk, kd), planes outside the volume skipped
  const int kd_lo = d == 0 ? 1 : 0;
  const int nkd = (d == D - 1 ? 2 : 3) - kd_lo;
  const int nsteps = (Cip / CK) * nkd;

  unsigned xr[C::NPT][8];  // the next plane, 16 channels of a voxel
  bool xin[C::NPT];

  auto load_x = [&](int s) {
    const int c0 = (s / nkd) * CK;
    const int dd = d + kd_lo + s % nkd - 1;
    const int cn = min(CK, Ci - c0);
    const unsigned short* xp = x + (((size_t)b * D + dd) * Ci + c0) * HW;
#pragma unroll
    for (int i = 0; i < C::NPT; ++i) {
      const int p = tid + i * THREADS;
      const int hh = h0 - 1 + p / C::IW, ww = w0 - 1 + p % C::IW;
      xin[i] = p < C::NP && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const unsigned short* src = xp + (xin[i] ? (size_t)hh * W + ww : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned lo = xin[i] && 2 * j < cn ? __ldg(src + (size_t)(2 * j) * HW) : 0u;
        const unsigned hi = xin[i] && 2 * j + 1 < cn ? __ldg(src + (size_t)(2 * j + 1) * HW) : 0u;
        xr[i][j] = lo | (hi << 16);
      }
    }
  };

  auto store_x = [&](int s, __nv_bfloat16* xs) {
    float sc[CK], sh[CK];  // the chunk's scale and shift
    if (FUSE) {
      const float4* s4 = reinterpret_cast<const float4*>(sst + (s / nkd) * CK);
#pragma unroll
      for (int q = 0; q < CK / 4; ++q) {
        const float4 a = s4[q], b = s4[Cip / 4 + q];
        sc[4 * q] = a.x, sc[4 * q + 1] = a.y, sc[4 * q + 2] = a.z, sc[4 * q + 3] = a.w;
        sh[4 * q] = b.x, sh[4 * q + 1] = b.y, sh[4 * q + 2] = b.z, sh[4 * q + 3] = b.w;
      }
    }
#pragma unroll
    for (int i = 0; i < C::NPT; ++i) {
      const int p = tid + i * THREADS;
      if (p < C::NP) {
        unsigned v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = xr[i][j];
          if (FUSE && xin[i])
            v[j] = norm_relu2(v[j], sc[2 * j], sh[2 * j], sc[2 * j + 1], sh[2 * j + 1]);
        }
        uint4* dst = reinterpret_cast<uint4*>(xs + p * CKP);
        dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
        dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
      }
    }
  };

  auto load_w = [&](int s, __nv_bfloat16* ws) {
    const int c0 = (s / nkd) * CK;
    const int kd = kd_lo + s % nkd;
    constexpr int QN = TN / 8;  // 16-byte pieces of a weight row
    for (int i = tid; i < 9 * CK * QN; i += THREADS) {
      const int q = i % QN, r = i / QN;  // r = tap * CK + k
      const int co = n0 + q * 8;
      const bool ok = co < Cop;
      const __nv_bfloat16* src =
          ok ? w + ((size_t)(kd * 9 + r / CK) * Cip + c0 + r % CK) * Cop + co : w;
      cp_async16(ws + r * C::TNP + q * 8, src, ok);
    }
    cp_async_commit();
  };

  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int f = 0; f < C::MF; ++f)
#pragma unroll
    for (int n = 0; n < C::NF; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[f][n][q] = 0.f;

  __nv_bfloat16* st[2] = {smem, smem + C::STAGE};
  load_w(0, st[0] + C::XS);
  load_x(0);
  store_x(0, st[0]);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < nsteps; ++s) {
    const __nv_bfloat16* xs = st[s & 1];
    const __nv_bfloat16* ws = xs + C::XS;
    __nv_bfloat16* nxt = st[(s & 1) ^ 1];
    const bool more = s + 1 < nsteps;
    if (more) {  // the next step's loads fly during this step's MMAs
      load_w(s + 1, nxt + C::XS);
      load_x(s + 1);
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) {  // the 9 taps of the staged plane
      const int kh = t / 3, kw = t % 3;
      unsigned a[C::MF][4];
#pragma unroll
      for (int f = 0; f < C::MF; ++f)  // rows: 16 outputs along W; k: 8 channels a half
        ldsm_x4(a[f], xs + ((wm * C::MF + f + kh) * C::IW + (lane & 15) + kw) * CKP +
                          (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < C::NF / 2; ++j) {
        unsigned bb[4];  // k16 x n16: n-fragments 2j and 2j + 1
        ldsm_x4_t(bb, ws + (t * CK + ((lane >> 3) & 1) * 8 + (lane & 7)) * C::TNP +
                          wn * C::WTN + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int f = 0; f < C::MF; ++f) {
          mma_bf16(acc[f][2 * j], a[f], bb[0], bb[1]);
          mma_bf16(acc[f][2 * j + 1], a[f], bb[2], bb[3]);
        }
      }
      // the next plane's loads have landed by now: store it between MMAs
      // (on the card no slower than after the last tap, faster at Co = 128)
      if (t == 6 && more) store_x(s + 1, nxt);
    }
    if (more) cp_async_wait_all();
    __syncthreads();
  }

  // round once to bf16, stage the tile as [co][h][w], store along W
  __nv_bfloat16* ys = smem;
#pragma unroll
  for (int f = 0; f < C::MF; ++f)
#pragma unroll
    for (int n = 0; n < C::NF; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = (wm * C::MF + f) * TW + (lane >> 2) + (q >> 1) * 8;
        const int co = wn * C::WTN + n * 8 + (lane & 3) * 2 + (q & 1);
        ys[co * C::TMP + m] = __float2bfloat16(acc[f][n][q]);
      }
  __syncthreads();
  for (int i = tid; i < TN * C::TM; i += THREADS) {
    const int m = i % C::TM, co = i / C::TM;
    const int h = h0 + m / TW, ww = w0 + m % TW;
    if (n0 + co < Co && h < H && ww < W)
      y[(((size_t)b * D + d) * Co + n0 + co) * HW + (size_t)h * W + ww] = ys[co * C::TMP + m];
  }
}

template <int TN, bool FUSE>
int launch_tn(const void* x, const void* w, const float* stats, void* y, int B, int D, int Ci,
              int Co, int H, int W, cudaStream_t stream) {
  using C = Cfg<TN>;
  const int Cip = (Ci + CK - 1) / CK * CK, Cop = (Co + 7) / 8 * 8;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + C::TH - 1) / C::TH;
  const int co_tiles = (Co + TN - 1) / TN;
  const size_t smem = 2 * C::STAGE * sizeof(__nv_bfloat16) + (FUSE ? 2 * Cip * sizeof(float) : 0);
  auto kernel = conv3_tc_kernel<TN, FUSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles_h * tiles_w, D, B * co_tiles);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const __nv_bfloat16*>(w), stats,
      static_cast<__nv_bfloat16*>(y), D, Ci, Co, H, W, Cip, Cop, tiles_w, co_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int TN>
int launch_fuse(const void* x, const void* w, const float* stats, void* y, int B, int D, int Ci,
                int Co, int H, int W, cudaStream_t stream) {
  return stats != nullptr ? launch_tn<TN, true>(x, w, stats, y, B, D, Ci, Co, H, W, stream)
                          : launch_tn<TN, false>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
}

// The Co tile that pads Co the least; on a tie the widest.
int pick_tn(int Co) {
  const int tns[4] = {32, 64, 96, 128};
  int best = 32, waste = 1 << 30;
  for (int tn : tns) {
    const int pad = (Co + tn - 1) / tn * tn - Co;
    if (pad <= waste) best = tn, waste = pad;
  }
  return best;
}

int launch(const void* x, const void* w, const float* stats, void* y, int B, int D, int Ci,
           int Co, int H, int W, cudaStream_t stream) {
  switch (pick_tn(Co)) {
    case 32: return launch_fuse<32>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
    case 64: return launch_fuse<64>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
    case 96: return launch_fuse<96>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
    default: return launch_fuse<128>(x, w, stats, y, B, D, Ci, Co, H, W, stream);
  }
}

}  // namespace tc

// ------------------------------------------------------- the stem (Ci = 1)
namespace stem {

constexpr int TH = 8;            // output tile rows: one warp a row
constexpr int TW = 32;           // output tile columns: four n8 fragments a warp
constexpr int TCO = 32;          // output channels of a block: two m16 fragments
constexpr int THREADS = 32 * TH;
constexpr int IH = TH + 2;       // staged rows of a plane (one-row halo)
constexpr int HALO = IH * (TW + 2);  // voxels of a plane with its halo
constexpr int PER = (HALO + THREADS - 1) / THREADS;
constexpr int RS = TW + 8;       // row stride of a staged copy: 80 bytes, 16-byte aligned
constexpr int COPY = IH * RS;    // bf16 of one staged copy of a plane
constexpr int PLANE = 3 * COPY;  // the plane at the three kw shifts
constexpr int SLOTS = 4;         // ring: three planes in use, one being filled
constexpr int YS = TH * TW + 8;  // padded co stride of the staged output tile (528 bytes)

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  tc::mma_bf16(c, a, b0, b1);  // stem MMA
}

// relu(x * scale + shift) of one bf16 value, rounded to bf16, the product
// rounded before the sum as the plain version rounds it
__device__ __forceinline__ unsigned short norm_relu(unsigned short v, float scale,
                                                    float shift) {
  const float f = fmaxf(__fadd_rn(__fmul_rn(__uint_as_float((unsigned)v << 16), scale), shift),
                        0.f);
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// A block owns TH x TW outputs of a run of depths [d0, d1) and TCO output
// channels. Per depth a warp computes its tile row: y (TCO x 32 positions) =
// A (TCO x 32 taps, the weights in registers) x B (32 taps x 32 positions),
// two k16 steps of mma.sync on each of 2 x 4 (m16, n8) fragments. B is read
// from a ring of staged input planes: tap (kd, kh, kw) of position (r, p)
// is plane d + kd - 1, copy kw, row r + kh, column p. Taps 27..31 read a
// zeroed 16-byte block (their weights are zero too).
template <bool FUSE>
__global__ void __launch_bounds__(THREADS, 3)
stem_fwd_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                const float* __restrict__ stats, __nv_bfloat16* __restrict__ y, int D, int Co,
                int H, int W, int tiles_w, int co_tiles, int run) {
  __shared__ __align__(16) unsigned short ring[SLOTS * PLANE];
  __shared__ __align__(16) __nv_bfloat16 ys[2][TCO * YS];
  __shared__ __align__(16) unsigned short zero[8];

  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int d0 = blockIdx.y * run, d1 = min(D, d0 + run);
  const int b = blockIdx.z / co_tiles, n0 = (blockIdx.z % co_tiles) * TCO;
  const size_t HW = (size_t)H * W;
  const unsigned short* xb = x + (size_t)b * D * HW;
  const float scale = FUSE ? stats[2 * b] : 0.f, shift = FUSE ? stats[2 * b + 1] : 0.f;
  if (tid < 8) zero[tid] = 0;

  // A: w (27, Co) bf16 as (co, tap), zero past tap 26 and past Co
  auto wv = [&](int co, int k) -> unsigned {
    return co < Co && k < 27 ? (unsigned)__ldg(w + (size_t)k * Co + co) : 0u;
  };
  unsigned a[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int co = n0 + 16 * mi + g, k = 16 * s + 2 * t;
      a[mi][s][0] = wv(co, k) | wv(co, k + 1) << 16;
      a[mi][s][1] = wv(co + 8, k) | wv(co + 8, k + 1) << 16;
      a[mi][s][2] = wv(co, k + 8) | wv(co, k + 9) << 16;
      a[mi][s][3] = wv(co + 8, k + 8) | wv(co + 8, k + 9) << 16;
    }

  // a plane with its halo: one voxel (or none) a thread and step, zero
  // outside the volume, the prologue applied to in-volume values
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

  for (int k = -1; k <= 1; ++k) {
    load(d0 + k);
    store(d0 + k);
  }
  __syncthreads();

  const int my_tap = (lane >> 3) * 8 + (lane & 7);
  int buf = 0;
  for (int d = d0; d < d1; ++d) {
    const bool more = d + 1 < d1;  // depth d + 1 needs plane d + 2
    if (more) load(d + 2);

    // this lane's ldmatrix row: tap 8 (lane / 8) + lane % 8 at the tile
    // row's first position; taps 27..31 read the zeroed block
    const unsigned short* bp = zero;
    int step = 0;
    if (my_tap < 27) {
      const int kd = my_tap / 9, kh = my_tap / 3 % 3, kw = my_tap % 3;
      bp = ring + ((d + kd - 1) & (SLOTS - 1)) * PLANE + kw * COPY + (r + kh) * RS;
      step = 8;
    }
#pragma unroll 1
    for (int jh = 0; jh < 2; ++jh) {  // n8 fragments 2 jh, 2 jh + 1: half the sums live
      float acc[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][jj][q] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {  // n8 fragment j: positions 8j .. 8j + 7
        const int j = 2 * jh + jj;
        unsigned bb[4];  // b0, b1 of k16 step 0, then of step 1
        tc::ldsm_x4_t(bb, bp + j * step);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[mi][jj], a[mi][0], bb[0], bb[1]);
          mma(acc[mi][jj], a[mi][1], bb[2], bb[3]);
        }
      }
      // round once to bf16, stage the tile as [co][row][column]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int hq = 0; hq < 2; ++hq) {
            const int co = 16 * mi + g + 8 * hq, p = 8 * (2 * jh + jj) + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(&ys[buf][co * YS + r * TW + p]) =
                __floats2bfloat162_rn(acc[mi][jj][2 * hq], acc[mi][jj][2 * hq + 1]);
          }
    }
    if (more) store(d + 2);  // slot (d + 2) & 3 was last read at depth d - 1
    __syncthreads();
    // 16-byte pieces of 8 outputs along W
    const size_t yd = ((size_t)b * D + d) * Co;
    for (int i = tid; i < TCO * TH * (TW / 8); i += THREADS) {
      const int q = i % (TW / 8), rr = i / (TW / 8) % TH, c = i / (TW / 8 * TH);
      const int h = h0 + rr, ww = w0 + 8 * q, co = n0 + c;
      if (co >= Co || h >= H || ww >= W) continue;
      const __nv_bfloat16* src = &ys[buf][c * YS + rr * TW + 8 * q];
      __nv_bfloat16* dst = y + (yd + co) * HW + (size_t)h * W + ww;
      if (W % 8 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && ww + e < W; ++e) dst[e] = src[e];
      }
    }
    buf ^= 1;  // the other buffer was last read before this depth's barrier
  }
}

template <bool FUSE>
int launch_fuse(const void* x, const void* w, const float* stats, void* y, int B, int D, int Co,
                int H, int W, int run, cudaStream_t stream) {
  if (run < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int co_tiles = (Co + TCO - 1) / TCO;
  const dim3 grid(tiles_h * tiles_w, (D + run - 1) / run, B * co_tiles);
  stem_fwd_kernel<FUSE><<<grid, THREADS, 0, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w), stats,
      static_cast<__nv_bfloat16*>(y), D, Co, H, W, tiles_w, co_tiles, run);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; route: 0 = CUDA cores (w float32
// (27, Ci, Co)), 1 = tensor cores (bf16 only; w bf16 (27, Cip, Cop)), 2 =
// the stem (bf16, Ci = 1; w bf16 (27, Co); run = depths a block marches
// through). stats may be null (no prologue). Returns cudaGetLastError()
// after the launch.
extern "C" int rsuper_conv3_cf(const void* x, const void* w, const void* stats, void* y,
                               int B, int D, int Ci, int Co, int H, int W, int run, int dtype,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  if (route == 2) {
    if (dtype != 1 || Ci != 1) return static_cast<int>(cudaErrorInvalidValue);
    return st != nullptr ? stem::launch_fuse<true>(x, w, st, y, B, D, Co, H, W, run, s)
                         : stem::launch_fuse<false>(x, w, st, y, B, D, Co, H, W, run, s);
  }
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch(x, w, st, y, B, D, Ci, Co, H, W, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    launch_t<float>(x, wf, st, y, B, D, Ci, Co, H, W, s);
  else if (dtype == 1)
    launch_t<__nv_bfloat16>(x, wf, st, y, B, D, Ci, Co, H, W, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

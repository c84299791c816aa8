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
// it. This first design runs on the CUDA cores in float32.
//
// Design: the sum runs over B*D*H*W positions, far more than one block can
// take, and blocks cannot carry a sum from one to the next as the TPU grid
// does. So the grid is (spatial split s of S, C_in tile x C_out tile). A
// block walks the 4x16 output tiles t = s, s+S, ... of the volume; for each
// it stages the dy tile (32 output channels) and the three depth planes of
// the a tile with a one-voxel halo (16 input channels, or 4 for the stem) in
// shared memory, channel innermost. A thread owns one (kd, kh), 4 input and
// 4 output channels: 3 taps x 4 x 4 float32 accumulators kept in registers
// over the whole walk. Along a tile row it reads one float4 of dy and one new
// float4 of a per position (the other two kw columns slide in registers) for
// 48 multiply-adds. At the end each block writes its accumulators to
// partial[s]; a second kernel sums the S partials in a fixed order, so dw is
// the same from run to run (no atomics).

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats may be null (no prologue). S is the
// number of spatial splits (>= 1); partial holds S * 27 * Ci * Co floats.
// Returns cudaGetLastError() after the two launches.
extern "C" int rsuper_conv3_cf_wgrad(const void* x, const void* dy, const void* stats,
                                     void* partial, void* dw, int B, int D, int Ci, int Co,
                                     int H, int W, int S, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(stats);
  float* pf = static_cast<float*>(partial);
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    launch_t<float>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st);
  else if (dtype == 1)
    launch_t<__nv_bfloat16>(x, dy, sf, pf, B, D, Ci, Co, H, W, S, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 27 * Ci * Co;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, static_cast<float*>(dw), n, S);
  return static_cast<int>(cudaGetLastError());
}

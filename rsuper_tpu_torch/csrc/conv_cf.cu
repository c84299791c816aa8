// SAME 3x3x3 convolution on depth-major channel-first operands, with an
// optional fused instance-norm + ReLU prologue. CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of rsuper_tpu/ops/conv_cf.py: _conv3_cf_pallas
// (_fwd_kernel, _fwd_kernel_d/_e/_f/_g, _fwd_kernel_ht, _fwd_kernel_ht_d),
// reached through conv3x3x3_cf and, with the stats operand, through
// in_relu_conv3x3x3_cf (_norm_relu_row applied at row load).
//
//   x     (B, D, Ci, H, W)   float or bf16
//   w     (27, Ci, Co)       float32, already rounded to x's type
//   stats (B, 2, Ci)         float32: [:, 0] = 1/sigma, [:, 1] = -mu/sigma
//   y     (B, D, Co, H, W)   x's type
//
// What bounds it: 54 operations per input-output channel pair and voxel.
// At the production shapes (Ci, Co = 32..192) the work is several hundred
// operations per byte moved, so the card's arithmetic rate bounds it, not
// its memory. This first design runs on the CUDA cores in float32 (no tensor
// cores yet), so it sits far from the bf16 tensor-core bound.
//
// Design: one block per (batch, depth row, 16x16 output tile, tile of Co).
// For each chunk of 4 input channels it stages the three depth rows of the
// input tile plus a one-voxel halo (as float, with the prologue applied)
// and the matching 27 x 4 x TCO weight slice in shared memory. Each thread
// owns 4 consecutive outputs along W times 16 output channels in registers:
// per (channel, kd, kh) it reads 6 inputs and 12 float4 weight vectors
// (warp-wide broadcasts) for 192 FMAs. All Ci and all 27 taps accumulate in
// float32 registers; the output is rounded once to x's type. Unlike the TPU
// kernel, Ci is never split into separately rounded partial sums.
//
// The prologue applies relu(x * scale + shift) only to in-volume values while
// staging, and rounds the activation to x's type as _norm_relu_row does.
// Out-of-volume taps stay 0 in activation space (not relu(shift)).

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. stats may be null (no prologue).
// Returns cudaGetLastError() after the launch.
extern "C" int rsuper_conv3_cf(const void* x, const void* w, const void* stats, void* y,
                               int B, int D, int Ci, int Co, int H, int W, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* st = static_cast<const float*>(stats);
  if (dtype == 0)
    launch_t<float>(x, wf, st, y, B, D, Ci, Co, H, W, s);
  else if (dtype == 1)
    launch_t<__nv_bfloat16>(x, wf, st, y, B, D, Ci, Co, H, W, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

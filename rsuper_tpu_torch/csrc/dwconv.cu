// Depthwise SAME 3x3x3 convolution on channels-last operands. CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel of rsuper_tpu/ops/dwconv.py: _dw_pallas
// (_fwd_kernel), reached through depthwise_conv3x3x3.
//
//   x (B, D, H, W, C)  float or bf16
//   w (27, C)          float32, already rounded to x's type
//   y (B, D, H, W, C)  x's type
//
// What bounds it: 27 multiply-adds per element and no channel contraction,
// so about 14 operations per byte in bf16. Memory bounds it: the least
// traffic is one read of x and one write of y.
//
// Design: each thread owns VEC channels (16 bytes: 8 bf16 or 4 float) at
// RWD = 4 consecutive W positions of one (b, d, h). Neighbouring threads own
// neighbouring channel vectors, so every load and store is a coalesced
// 16-byte access. For each (kd, kh) row the thread loads the 6 W positions
// it needs once and reuses them across the 3 kw taps; the other reads of the
// same voxels by neighbouring threads hit L1/L2. The weights (27 x VEC
// floats) come through the read-only cache. Accumulation is float32; the
// output is rounded once to x's type. The TPU's C % 128 gate does not apply:
// any C works (VEC = 1 when C or the pointers do not allow 16-byte access).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int RWD = 4;  // consecutive W outputs per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC contiguous elements <-> floats, as one 16-byte access when
// VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f(p[v]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int v = 0; v < VEC; ++v) e[v] = from_f<T>(in[v]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) p[v] = from_f<T>(in[v]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
dw3_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
           int B, int D, int H, int W, int C, int wgroups) {
  const int CV = C / VEC;
  const long long total = (long long)B * D * H * wgroups * CV;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cv = (int)(idx % CV);
  long long t = idx / CV;
  const int wg = (int)(t % wgroups);
  t /= wgroups;
  const int h = (int)(t % H);
  t /= H;
  const int d = (int)(t % D);
  const int b = (int)(t / D);
  const int c = cv * VEC;
  const int w0 = wg * RWD;

  float acc[RWD][VEC];
#pragma unroll
  for (int j = 0; j < RWD; ++j)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[j][v] = 0.f;

#pragma unroll
  for (int kd = 0; kd < 3; ++kd) {
    const int dd = d + kd - 1;
    if (dd < 0 || dd >= D) continue;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = h + kh - 1;
      if (hh < 0 || hh >= H) continue;
      const T* row = x + ((((size_t)b * D + dd) * H + hh) * W) * C + c;
      float in[RWD + 2][VEC];
#pragma unroll
      for (int j = 0; j < RWD + 2; ++j) {
        const int ww = w0 + j - 1;
        if (ww >= 0 && ww < W) {
          load_vec<T, VEC>(row + (size_t)ww * C, in[j]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) in[j][v] = 0.f;
        }
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float wv[VEC];
        const float* wp = w + (size_t)((kd * 3 + kh) * 3 + kw) * C + c;
#pragma unroll
        for (int v = 0; v < VEC; ++v) wv[v] = __ldg(wp + v);
#pragma unroll
        for (int j = 0; j < RWD; ++j)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[j][v] = fmaf(in[j + kw][v], wv[v], acc[j][v]);
      }
    }
  }

  T* out = y + ((((size_t)b * D + d) * H + h) * W) * C + c;
#pragma unroll
  for (int j = 0; j < RWD; ++j) {
    const int ww = w0 + j;
    if (ww < W) store_vec<T, VEC>(out + (size_t)ww * C, acc[j]);
  }
}

template <typename T, int VEC>
void launch(const void* x, const float* w, void* y, int B, int D, int H, int W, int C,
            cudaStream_t stream) {
  const int wgroups = (W + RWD - 1) / RWD;
  const long long total = (long long)B * D * H * wgroups * (C / VEC);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  dw3_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), B, D, H, W, C, wgroups);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec16 != 0 selects 16-byte accesses (the
// caller checks C and pointer alignment). Returns cudaGetLastError().
extern "C" int rsuper_dw3(const void* x, const void* w, void* y, int B, int D, int H,
                          int W, int C, int dtype, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    if (vec16)
      launch<float, 4>(x, wf, y, B, D, H, W, C, s);
    else
      launch<float, 1>(x, wf, y, B, D, H, W, C, s);
  } else if (dtype == 1) {
    if (vec16)
      launch<__nv_bfloat16, 8>(x, wf, y, B, D, H, W, C, s);
    else
      launch<__nv_bfloat16, 1>(x, wf, y, B, D, H, W, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

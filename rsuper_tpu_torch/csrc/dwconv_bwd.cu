// Weight gradient of the depthwise SAME 3x3x3 convolution on channels-last
// operands. CUDA C++ for sm_90a.
//
// Replaces, together with the stencil kernel of dwconv.cu run on dy with
// flipped taps (which gives dx), the TPU kernel of rsuper_tpu/ops/dwconv.py:
// _dw_bwd_pallas (_bwd_kernel), reached from the VJP of depthwise_conv3x3x3.
//
//   x, dy   (B, D, H, W, C)   float or bf16
//   partial (G, 27, C)        float32 scratch, every element written
//   dw      (27, C)           float32
//
//   dw[k, c] = sum over positions q of x[q, c] * dy[q - (k - 1), c]
//   (k - 1 is the tap's offset in depth, row and column; dy is 0 outside).
//
// Why two kernels and not the TPU's one: the TPU kernel adds its 27 x C sums
// into one resident block while the grid walks the volume in order. Here a
// thread that produced dx and dw together would hold 27 x VEC sums beside its
// stencil state (more than 255 registers at VEC = 8), and dx needs no
// reduction at all. So dx stays the memory-bound stencil of dwconv.cu, and
// this kernel does the reduction.
//
// What bounds it: 27 multiply-adds per element against one read of x and dy:
// memory, as the forward.
//
// Design: a thread owns VEC channels (16 bytes: 8 bf16 or 4 float; 1 element
// when C or the pointers do not allow 16-byte access) and ONE depth tap kd,
// so 9 x VEC float32 sums stay in registers. Neighbouring threads own
// neighbouring channel vectors (coalesced 16-byte loads). A block is
// 16 channel vectors x 3 depth taps x 4 row slices; it walks the rows
// (b, d, h) assigned to it, and along each row loads x once and the 9
// neighbouring dy vectors (re-reads hit L1/L2). The 4 slices are then summed
// through shared memory, the block writes partial[g], and a second kernel
// sums the G partials in a fixed order: dw is the same from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CVB = 16;  // channel vectors per block
constexpr int NS = 4;    // row slices per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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
__global__ void __launch_bounds__(CVB * 3 * NS)
dw3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ partial, int B, int D, int H, int W, int C, int G) {
  __shared__ float red[27][CVB * VEC];

  const int tid = threadIdx.x;
  const int cvl = tid % CVB;
  const int kd = (tid / CVB) % 3;
  const int s = tid / (CVB * 3);
  const int cv = blockIdx.y * CVB + cvl;
  const bool active = cv < C / VEC;
  const int c = cv * VEC;

  float acc[9][VEC];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[k][v] = 0.f;

  if (active) {
    const long long rows = (long long)B * D * H;
    for (long long row = (long long)blockIdx.x * NS + s; row < rows;
         row += (long long)G * NS) {
      const int h = (int)(row % H);
      const long long u = row / H;
      const int d = (int)(u % D);
      const int b = (int)(u / D);
      const int dd = d - (kd - 1);
      if (dd < 0 || dd >= D) continue;
      const T* xrow = x + ((((size_t)b * D + d) * H + h) * W) * C + c;
      for (int w = 0; w < W; ++w) {
        float xv[VEC];
        load_vec<T, VEC>(xrow + (size_t)w * C, xv);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int hh = h - (kh - 1);
          if (hh < 0 || hh >= H) continue;
          const T* grow = dy + ((((size_t)b * D + dd) * H + hh) * W) * C + c;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int ww = w - (kw - 1);
            if (ww < 0 || ww >= W) continue;
            float gv[VEC];
            load_vec<T, VEC>(grow + (size_t)ww * C, gv);
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[kh * 3 + kw][v] = fmaf(gv[v], xv[v], acc[kh * 3 + kw][v]);
          }
        }
      }
    }
  }

  for (int ss = 0; ss < NS; ++ss) {
    if (s == ss && active) {
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float* r = &red[kd * 9 + k][cvl * VEC + v];
          *r = (ss == 0) ? acc[k][v] : *r + acc[k][v];
        }
    }
    __syncthreads();
  }
  const int c0 = blockIdx.y * CVB * VEC;
  for (int i = tid; i < 27 * CVB * VEC; i += blockDim.x) {
    const int k = i / (CVB * VEC);
    const int col = i % (CVB * VEC);
    if (c0 + col < C)
      partial[((size_t)blockIdx.x * 27 + k) * C + c0 + col] = red[k][col];
  }
}

// dw[i] = partial[0][i] + partial[1][i] + ... in that order.
__global__ void sum_partials_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                    int n, int G) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += partial[(size_t)g * n + i];
  dw[i] = acc;
}

template <typename T, int VEC>
void launch(const void* x, const void* dy, float* partial, int B, int D, int H, int W, int C,
            int G, cudaStream_t stream) {
  const int cv = C / VEC;
  const dim3 grid(G, (cv + CVB - 1) / CVB);
  dw3_wgrad_kernel<T, VEC><<<grid, CVB * 3 * NS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partial, B, D, H, W, C, G);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec16 != 0 selects 16-byte accesses (the
// caller checks C and pointer alignment). G is the number of row groups
// (>= 1); partial holds G * 27 * C floats. Returns cudaGetLastError() after
// the two launches.
extern "C" int rsuper_dw3_wgrad(const void* x, const void* dy, void* partial, void* dw, int B,
                                int D, int H, int W, int C, int G, int dtype, int vec16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(partial);
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (vec16)
      launch<float, 4>(x, dy, pf, B, D, H, W, C, G, st);
    else
      launch<float, 1>(x, dy, pf, B, D, H, W, C, G, st);
  } else if (dtype == 1) {
    if (vec16)
      launch<__nv_bfloat16, 8>(x, dy, pf, B, D, H, W, C, G, st);
    else
      launch<__nv_bfloat16, 1>(x, dy, pf, B, D, H, W, C, G, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 27 * C;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, st>>>(pf, static_cast<float*>(dw), n, G);
  return static_cast<int>(cudaGetLastError());
}

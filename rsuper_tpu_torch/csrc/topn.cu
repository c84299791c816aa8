// Bisection top-N thresholds for sm_90a.
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
// is 26 * K compares a value. What it costs is the chain of iters + 1
// dependent whole-volume reductions. The TPU kernel holds the volume in VMEM
// for that chain; here the S blocks of an item hold it in registers: a
// thread keeps its first CACHE values (S is chosen so that this is all of
// them while the blocks fit on the card at once) and reads any further ones
// again from L2 in each pass. One pass counts against the mids of all K
// targets. Between passes the blocks exchange per-block counts through a
// small global buffer (two halves, used in turn) and a grid-wide barrier of
// a cooperative launch; every block then sums the S partial counts of its
// item itself and keeps its own copy of lo and hi. An item that fits one
// block (V <= THREADS * CACHE) is launched plainly and synchronises with
// __syncthreads alone.
//
// Loads are single elements, consecutive threads on consecutive addresses:
// any V and any alignment are taken, and the volume is read from device
// memory only once. float32, bfloat16 and float16 input; every value is
// converted to float32 on load.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CACHE = 16;  // values a thread keeps in registers
constexpr int KMAX = 8;    // targets of one launch
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}

// grid (S, B): block (s, b) is the s-th of the S blocks of item b.
// part_cnt: int[2][B][S][KMAX], part_max: float[B][S].
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bisect_kernel(const T* __restrict__ x, const float* __restrict__ ns,
              float* __restrict__ out, int* part_cnt, float* part_max,
              long long V, int K, int iters) {
  const int S = gridDim.x, s = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xb = x + (size_t)b * (size_t)V;
  const long long stride = (long long)S * THREADS;  // threads of this item
  const long long first = (long long)s * THREADS + tid;
  const long long rest = first + (long long)CACHE * stride;

  __shared__ float sh_max[WARPS];
  __shared__ int sh_cnt[WARPS][KMAX];
  __shared__ float sh_lo[KMAX], sh_hi[KMAX];

  auto sync_item = [&]() {
    if (S > 1) cg::this_grid().sync();
    else __syncthreads();
  };

  // ---- the only read from device memory, and the item's maximum
  float r[CACHE];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const long long idx = first + (long long)i * stride;
    r[i] = idx < V ? to_float(xb[idx]) : -CUDART_INF_F;
    m = fmaxf(m, r[i]);
  }
  for (long long idx = rest; idx < V; idx += stride)
    m = fmaxf(m, to_float(xb[idx]));
  m = warp_max(m);
  if (lane == 0) sh_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < WARPS ? sh_max[lane] : -CUDART_INF_F);
    if (lane == 0) part_max[(size_t)b * S + s] = m;
  }
  sync_item();
  if (warp == 0) {
    m = -CUDART_INF_F;
    for (int j = lane; j < S; j += 32)
      m = fmaxf(m, __ldcg(&part_max[(size_t)b * S + j]));
    m = warp_max(m);
    if (lane < KMAX) {
      sh_lo[lane] = 0.0f;
      sh_hi[lane] = m;
    }
  }
  __syncthreads();

  // ---- the bisection: one counting pass a step, against all K mids
  for (int it = 0; it < iters; ++it) {
    float mid[KMAX];
    int cnt[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      mid[k] = 0.5f * (sh_lo[k] + sh_hi[k]);
      cnt[k] = 0;
    }
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) cnt[k] += (r[i] >= mid[k]) ? 1 : 0;
    }
    for (long long idx = rest; idx < V; idx += stride) {
      const float v = to_float(xb[idx]);
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        if (k < K) cnt[k] += (v >= mid[k]) ? 1 : 0;
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const int c = __reduce_add_sync(FULL, cnt[k]);
        if (lane == 0) sh_cnt[warp][k] = c;
      }
    }
    __syncthreads();
    int* buf = part_cnt + (size_t)(it & 1) * gridDim.y * S * KMAX;
    if (tid < K) {
      int c = 0;
      for (int w = 0; w < WARPS; ++w) c += sh_cnt[w][tid];
      buf[((size_t)b * S + s) * KMAX + tid] = c;
    }
    sync_item();
    if (warp < K) {  // warp k sums the S partial counts of target k
      long long c = 0;
      for (int j = lane; j < S; j += 32)
        c += __ldcg(&buf[((size_t)b * S + j) * KMAX + warp]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
      if (lane == 0) {
        const float lo = sh_lo[warp], hi = sh_hi[warp];
        const float md = 0.5f * (lo + hi);
        const bool ok = (float)c >= ns[(size_t)b * K + warp];
        sh_lo[warp] = ok ? md : lo;
        sh_hi[warp] = ok ? hi : md;
      }
    }
    __syncthreads();
  }
  if (s == 0 && tid < K) out[(size_t)b * K + tid] = sh_lo[tid];
}

const void* kernel_of(int dtype) {
  switch (dtype) {
    case 0: return (const void*)bisect_kernel<float>;
    case 1: return (const void*)bisect_kernel<__nv_bfloat16>;
    case 2: return (const void*)bisect_kernel<__half>;
    default: return nullptr;
  }
}

int launch(const void* x, const float* ns, float* out, int* part_cnt,
           float* part_max, long long B, long long V, int K, int iters,
           int dtype, int S, cudaStream_t stream) {
  const void* fn = kernel_of(dtype);
  if (fn == nullptr || K < 1 || K > KMAX || S < 1 || B < 1 || B > 65535 ||
      V < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)S, (unsigned)B), block(THREADS);
  void* args[] = {&x, &ns, &out, &part_cnt, &part_max, &V, &K, &iters};
  cudaError_t e = S > 1
      ? cudaLaunchCooperativeKernel(fn, grid, block, args, 0, stream)
      : cudaLaunchKernel(fn, grid, block, args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel that the current device holds at once (the most a
// cooperative launch takes); 0 when the device has no cooperative launch,
// a negative CUDA error code on failure.
extern "C" int rsuper_topn_max_blocks(int dtype) {
  const void* fn = kernel_of(dtype);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return coop ? sms * per_sm : 0;
}

// One volume: x[V] in `dtype` (0 float32, 1 bfloat16, 2 float16), ns[K] and
// out[K] float32, part_cnt int[2 * S * 8], part_max float[S].
extern "C" int rsuper_topn_threshold_multi(
    const void* x, const float* ns, float* out, int* part_cnt, float* part_max,
    long long V, int K, int iters, int dtype, int S, cudaStream_t stream) {
  return launch(x, ns, out, part_cnt, part_max, 1, V, K, iters, dtype, S,
                stream);
}

// B volumes: x[B][V], ns[B][K] and out[B][K], part_cnt int[2 * B * S * 8],
// part_max float[B * S]; B * S at most rsuper_topn_max_blocks when S > 1.
extern "C" int rsuper_topn_threshold_multi_batched(
    const void* x, const float* ns, float* out, int* part_cnt, float* part_max,
    long long B, long long V, int K, int iters, int dtype, int S,
    cudaStream_t stream) {
  return launch(x, ns, out, part_cnt, part_max, B, V, K, iters, dtype, S,
                stream);
}

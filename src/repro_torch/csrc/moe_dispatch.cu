// Dispatch of the dropless expert layer for Hopper (sm_90a): the routed
// rows into expert order and the gated combine back, forward and backward.
//
// Replaces no TPU kernel: the reference's MoE layer has a capacity and
// leaves its dispatch to XLA (one-hot matmuls or gather / scatter). The
// port's dropless layer (models/mlp.py dropless_moe_forward) routes a
// data-dependent number of rows to each held expert; torch's scatter-add
// would sum them with float atomics, in an order that changes from run to
// run. These kernels move rows by index and sum in a fixed order:
//   repro_moe_permute      out[r] = x[pair[r] / k]          (pair[r] >= 0)
//   repro_moe_permute_bwd  dx[t] = sum_j dxp[slot[t][j]]     (choice order)
//   repro_moe_combine      y[t]  = sum_j g[t][j] ye[slot[t][j]]
//   repro_moe_combine_bwd  dye[r] = g[p] dy[p / k], dg[p] = <dy[p / k], ye[r]>
// with p = pair[r]; a slot of -1 (an expert held elsewhere) adds nothing, a
// pair of -1 (an empty row of the R = T * k buffer) is skipped, and its row
// is left unwritten: the grouped expert products read the filled rows only.
//
// What bounds it: device-memory bytes. Each kernel moves a few rows of d
// elements per token and does at most 2 operations an element, far below
// the card's arithmetic rate. So the design is one pass: one CTA a row (the
// permute and the combine's backward) or a token (the sums), each thread
// moving 16 bytes at a time (8 bf16 or 4 f32 values), neighbouring threads
// on neighbouring addresses. The sums accumulate in float32 registers in
// choice order and the dot product of the backward reduces through warp
// shuffles and shared memory in a fixed order, so every result is the same
// from run to run; nothing uses atomics.
//
// Kernels launch on the caller's stream, allocate nothing and never
// synchronise; each entry point returns cudaGetLastError(). Rows are
// contiguous with d * element size a multiple of 16 bytes (the wrapper
// checks), indices int32, gates float32, rows bf16 (esize 2) or f32 (4).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxK = 32;

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

// out[r] = x[pair[r] / k]: a byte copy, 16 bytes a thread
__global__ void moe_permute_fwd_kernel(const uint4* __restrict__ x,
                                       const int32_t* __restrict__ pair,
                                       uint4* __restrict__ out, int k,
                                       int64_t nvec) {
  const int64_t r = blockIdx.x;
  const int p = pair[r];
  if (p < 0) return;
  const uint4* src = x + static_cast<int64_t>(p / k) * nvec;
  uint4* dst = out + r * nvec;
  for (int64_t c = threadIdx.x; c < nvec; c += blockDim.x) dst[c] = src[c];
}

// dx[t] = sum over j of dxp[slot[t][j]], in choice order, in float32
template <typename T>
__global__ void moe_permute_bwd_kernel(const T* __restrict__ dxp,
                                       const int32_t* __restrict__ slot,
                                       T* __restrict__ dx, int k, int64_t d) {
  constexpr int N = Pack<T>::N;
  __shared__ int32_t sl[kMaxK];
  const int64_t t = blockIdx.x;
  if (threadIdx.x < k) sl[threadIdx.x] = slot[t * k + threadIdx.x];
  __syncthreads();
  for (int64_t c = static_cast<int64_t>(threadIdx.x) * N; c < d;
       c += static_cast<int64_t>(blockDim.x) * N) {
    float acc[N] = {};
    for (int j = 0; j < k; ++j) {
      const int r = sl[j];
      if (r < 0) continue;
      float v[N];
      Pack<T>::load(dxp + static_cast<int64_t>(r) * d + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += v[i];
    }
    Pack<T>::store(dx + t * d + c, acc);
  }
}

// y[t] = sum over j of g[t][j] ye[slot[t][j]], in choice order, in float32
template <typename T>
__global__ void moe_combine_fwd_kernel(const T* __restrict__ ye,
                                       const float* __restrict__ g,
                                       const int32_t* __restrict__ slot,
                                       T* __restrict__ y, int k, int64_t d) {
  constexpr int N = Pack<T>::N;
  __shared__ int32_t sl[kMaxK];
  __shared__ float gs[kMaxK];
  const int64_t t = blockIdx.x;
  if (threadIdx.x < k) {
    sl[threadIdx.x] = slot[t * k + threadIdx.x];
    gs[threadIdx.x] = g[t * k + threadIdx.x];
  }
  __syncthreads();
  for (int64_t c = static_cast<int64_t>(threadIdx.x) * N; c < d;
       c += static_cast<int64_t>(blockDim.x) * N) {
    float acc[N] = {};
    for (int j = 0; j < k; ++j) {
      const int r = sl[j];
      if (r < 0) continue;
      float v[N];
      Pack<T>::load(ye + static_cast<int64_t>(r) * d + c, v);
      const float gj = gs[j];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += gj * v[i];
    }
    Pack<T>::store(y + t * d + c, acc);
  }
}

// row r of pair p = t * k + j: dye[r] = g[p] dy[t], dg[p] = <dy[t], ye[r]>
template <typename T>
__global__ void moe_combine_bwd_kernel(const T* __restrict__ dy,
                                       const T* __restrict__ ye,
                                       const float* __restrict__ g,
                                       const int32_t* __restrict__ pair,
                                       T* __restrict__ dye,
                                       float* __restrict__ dg, int k,
                                       int64_t d) {
  constexpr int N = Pack<T>::N;
  const int64_t r = blockIdx.x;
  const int p = pair[r];
  if (p < 0) return;
  const int64_t t = p / k;
  const float gp = g[p];
  float part = 0.f;
  for (int64_t c = static_cast<int64_t>(threadIdx.x) * N; c < d;
       c += static_cast<int64_t>(blockDim.x) * N) {
    float a[N], b[N], o[N];
    Pack<T>::load(dy + t * d + c, a);
    Pack<T>::load(ye + r * d + c, b);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      o[i] = gp * a[i];
      part += a[i] * b[i];
    }
    Pack<T>::store(dye + r * d + c, o);
  }
  // the block's sum in a fixed order: each warp by shuffles, then warp 0
  __shared__ float warp_sum[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (lane == 0) warp_sum[warp] = part;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) / 32;
    float s = lane < n_warps ? warp_sum[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dg[p] = s;
  }
}

// threads a CTA: one 16-byte vector each, a whole number of warps, at most
// kMaxThreads
int threads_for(int64_t nvec) {
  int64_t n = (nvec + 31) / 32 * 32;
  return static_cast<int>(n < kMaxThreads ? n : kMaxThreads);
}

// one CTA a row or token; the grid's x dim holds up to 2^31 - 1
dim3 grid(int64_t n) { return dim3(static_cast<unsigned>(n)); }

bool bad_args(int64_t rows, int k, int esize) {
  return rows < 0 || rows > 0x7fffffff || k < 1 || k > kMaxK ||
         (esize != 2 && esize != 4);
}

}  // namespace

extern "C" {

int repro_moe_permute(const void* x, const void* pair, void* out,
                      int64_t rows, int64_t k, int64_t d, int esize,
                      void* stream) {
  if (bad_args(rows, static_cast<int>(k), esize)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const int64_t nvec = d * esize / 16;
  moe_permute_fwd_kernel<<<grid(rows), threads_for(nvec), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int32_t*>(pair),
      static_cast<uint4*>(out), static_cast<int>(k), nvec);
  return cudaGetLastError();
}

int repro_moe_permute_bwd(const void* dxp, const void* slot, void* dx,
                          int64_t t, int64_t k, int64_t d, int esize,
                          void* stream) {
  if (bad_args(t, static_cast<int>(k), esize)) return cudaErrorInvalidValue;
  if (t == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d * esize / 16);
  if (esize == 2) {
    moe_permute_bwd_kernel<__nv_bfloat16><<<grid(t), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dxp),
        static_cast<const int32_t*>(slot), static_cast<__nv_bfloat16*>(dx),
        static_cast<int>(k), d);
  } else {
    moe_permute_bwd_kernel<float><<<grid(t), threads, 0, s>>>(
        static_cast<const float*>(dxp), static_cast<const int32_t*>(slot),
        static_cast<float*>(dx), static_cast<int>(k), d);
  }
  return cudaGetLastError();
}

int repro_moe_combine(const void* ye, const void* g, const void* slot,
                      void* y, int64_t t, int64_t k, int64_t d, int esize,
                      void* stream) {
  if (bad_args(t, static_cast<int>(k), esize)) return cudaErrorInvalidValue;
  if (t == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d * esize / 16);
  if (esize == 2) {
    moe_combine_fwd_kernel<__nv_bfloat16><<<grid(t), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(ye), static_cast<const float*>(g),
        static_cast<const int32_t*>(slot), static_cast<__nv_bfloat16*>(y),
        static_cast<int>(k), d);
  } else {
    moe_combine_fwd_kernel<float><<<grid(t), threads, 0, s>>>(
        static_cast<const float*>(ye), static_cast<const float*>(g),
        static_cast<const int32_t*>(slot), static_cast<float*>(y),
        static_cast<int>(k), d);
  }
  return cudaGetLastError();
}

int repro_moe_combine_bwd(const void* dy, const void* ye, const void* g,
                          const void* pair, void* dye, void* dg,
                          int64_t rows, int64_t k, int64_t d, int esize,
                          void* stream) {
  if (bad_args(rows, static_cast<int>(k), esize)) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(d * esize / 16);
  if (esize == 2) {
    moe_combine_bwd_kernel<__nv_bfloat16><<<grid(rows), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(ye), static_cast<const float*>(g),
        static_cast<const int32_t*>(pair), static_cast<__nv_bfloat16*>(dye),
        static_cast<float*>(dg), static_cast<int>(k), d);
  } else {
    moe_combine_bwd_kernel<float><<<grid(rows), threads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(ye),
        static_cast<const float*>(g), static_cast<const int32_t*>(pair),
        static_cast<float*>(dye), static_cast<float*>(dg),
        static_cast<int>(k), d);
  }
  return cudaGetLastError();
}

}  // extern "C"

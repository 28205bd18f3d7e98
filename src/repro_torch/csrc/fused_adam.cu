// Fused BertAdam update (no bias correction) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_adam/kernel.py:adam_step
// (body _adam_kernel) -> repro_adam_step.
//
// What bounds it: device-memory bytes. Per element it reads x, m, v, g and
// writes x, m, v: 28 bytes for about a dozen floating-point operations, far
// below the card's arithmetic rate. The design is one grid-stride pass with
// coalesced float4 accesses, so every byte crosses device memory once.
//
// Numerics: the operations run in _adam_kernel's order, each rounded on its
// own (explicit __f*_rn intrinsics, so the compiler contracts nothing into an
// FMA), with IEEE square root and division. That is the plain PyTorch chain
// of kernels/fused_adam/ref.py operation for operation.
//
// The kernel launches on the caller's stream, allocates nothing, never
// synchronises, and the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct AdamScalars {
  float lr, b1, omb1, b2, omb2, eps, wd;
  int has_wd;
};

__device__ __forceinline__ void adam_elem(const AdamScalars& c, float x,
                                          float m, float v, float g,
                                          float& nx, float& nm, float& nv) {
  nm = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  nv = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, g), g));
  float upd = __fdiv_rn(nm, __fadd_rn(__fsqrt_rn(nv), c.eps));
  if (c.has_wd) upd = __fadd_rn(upd, __fmul_rn(c.wd, x));
  nx = __fsub_rn(x, __fmul_rn(c.lr, upd));
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const float4* __restrict__ x, const float4* __restrict__ m,
            const float4* __restrict__ v, const float4* __restrict__ g,
            float4* nx, float4* nm, float4* nv, int64_t n4, AdamScalars c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += stride) {
    const float4 xi = x[i], mi = m[i], vi = v[i], gi = g[i];
    float4 ox, om, ov;
    adam_elem(c, xi.x, mi.x, vi.x, gi.x, ox.x, om.x, ov.x);
    adam_elem(c, xi.y, mi.y, vi.y, gi.y, ox.y, om.y, ov.y);
    adam_elem(c, xi.z, mi.z, vi.z, gi.z, ox.z, om.z, ov.z);
    adam_elem(c, xi.w, mi.w, vi.w, gi.w, ox.w, om.w, ov.w);
    nx[i] = ox;
    nm[i] = om;
    nv[i] = ov;
  }
}

}  // namespace

extern "C" {

// All seven vectors: (d,) f32, 16-byte aligned, d % 4 == 0. b1, b2 and the
// (1 - b) factors are passed already rounded to f32, as the reference's
// Python floats are when they meet an f32 array.
int repro_adam_step(const void* x, const void* m, const void* v,
                    const void* g, void* nx, void* nm, void* nv, int64_t d,
                    float lr, float b1, float omb1, float b2, float omb2,
                    float eps, float wd, void* stream) {
  const int64_t n4 = d / 4;
  if (n4 > 0) {
    const AdamScalars c{lr, b1, omb1, b2, omb2, eps, wd, wd != 0.f};
    const int64_t blocks = (n4 + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
    adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(m),
        static_cast<const float4*>(v), static_cast<const float4*>(g),
        static_cast<float4*>(nx), static_cast<float4*>(nm),
        static_cast<float4*>(nv), n4, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

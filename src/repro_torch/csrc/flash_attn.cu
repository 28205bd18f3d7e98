// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel in src/repro/kernels/flash_attn/kernel.py:
//   flash_attention (body _flash_kernel) -> repro_flash_attention
// for f32 inputs (the wrapper routes bf16 and fp16 to the tensor-core
// kernel of flash_attn_sm90.cu; this one still takes bf16, for timing).
//
// It computes what _flash_kernel computes, on q/k/v of shape (B*H, S, D),
// f32 or bf16:
//   * q, k and v are upcast to f32 and q is divided by sqrt(d_scale) before
//     QK^T, where d_scale is the true head dim (the wrapper zero-pads q, k
//     and v to the next instantiated D, which leaves q.k unchanged);
//   * scores, p = exp(s - m) and p @ v stay in f32 (p is never rounded to
//     bf16), with the running max m, normaliser l and accumulator o in f32;
//   * masked scores are -1e30 (causal: col > row; sliding window:
//     col <= row - window), not -inf: a tile that is fully masked for a row
//     while m is still -1e30 adds exp(0) = 1 per entry, as the reference
//     does, and the first real score wipes it with corr = exp(-1e30 - m) = 0;
//   * whole kv tiles right of the diagonal (causal) and left of the window
//     are skipped by the bounds of the kv loop, as _flash_kernel's loop
//     bounds do;
//   * out = o / max(l, 1e-30), rounded once to the input dtype.
// Tile sizes differ from the TPU's 256 x 256: the result depends on them
// only through the order of the f32 sums. Columns past S (a ragged last
// tile) get -inf and so an exact zero weight.
//
// What bounds it: tensor-core operations. At the serving shape (8, 24,
// 2048, 128) bf16, causal, the work is 2*B*H*S^2*D = 2.06e11 FLOP against
// 0.4 GB of device memory, far above the card's ~295 FLOP/byte ridge, so
// the floor is the bf16 tensor-core rate (989 TFLOP/s).
//
// What this design does about that bound: nothing yet. It is the simple,
// exact version: SIMT f32 FMAs (the reference keeps q/sqrt(D) and p in f32,
// which bf16 tensor-core operands would round), no wgmma, no TMA, no
// pipelining of the tile loads. So it runs at a fraction of the f32 SIMT
// rate (67 TFLOP/s), far from the tensor-core floor.
//
// Design:
//   * one CTA of 256 threads per (b*h, 64-query tile); heavy causal tiles
//     (late queries) are scheduled first;
//   * the CTA's q tile (already divided by sqrt(D)) and each 64-row k and v
//     tile are staged in dynamic shared memory as f32 (~98 KB at D = 128,
//     two CTAs per SM; ~194 KB at D = 256, one); the p tile reuses the k
//     tile's space;
//   * thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3: the
//     score micro-tile at key columns tx + 16j (j < 4) and the output
//     columns of its 16-lane slice of D; row max and row sum reduce over the
//     16 lanes of the half-warp with shuffles;
//   * int64 offsets; launches on the caller's stream, allocates nothing,
//     never synchronises; the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // key rows per kv tile
constexpr int kThreads = 256;
constexpr int kPad = 4;        // keeps float4 rows aligned, spreads banks
constexpr int kLDP = kBK + kPad;
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

static_assert(kBQ == kBK, "stage_tile stages q and kv tiles alike");

// Rows [row0, row0 + 64) of one (S, D) head -> f32 shared tile with row
// stride ld (divided by sqrt_d when kScale); rows at or past S are zero.
template <int D, bool kScale, typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ head,
                                           int64_t row0, int64_t s_len,
                                           float* tile, int ld, float sqrt_d) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t row = row0 + r;
    if (row < s_len) load4(head + row * D + c, v);
    if (kScale) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = v[e] / sqrt_d;   // IEEE division
    }
    *reinterpret_cast<float4*>(tile + r * ld + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + kPad)                                      // q
         + (kBK * (D + kPad) > kBQ * kLDP ? kBK * (D + kPad)   // k, then p
                                          : kBQ * kLDP)
         + kBK * D;                                            // v
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int64_t s_len,
                 int n_qt, float sqrt_d, int causal, int64_t window) {
  constexpr int LDQ = D + kPad;
  constexpr int VEC = D / 16 < 4 ? D / 16 : 4;   // output columns per chunk
  constexpr int NCH = D / (16 * VEC);            // chunks per thread
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + kBQ * LDQ;                    // k tile, then p tile
  float* ps = ks;
  float* vs = ks + (kBK * LDQ > kBQ * kLDP ? kBK * LDQ : kBQ * kLDP);

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int64_t bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int64_t q0 = static_cast<int64_t>(qt) * kBQ;
  const int64_t head = bh * s_len * D;

  stage_tile<D, true>(q + head, q0, s_len, qs, LDQ, sqrt_d);

  // kv tile range, as _flash_kernel's fori_loop bounds
  const int64_t n_kt = (s_len + kBK - 1) / kBK;
  int64_t kt_end = n_kt;
  if (causal) {
    const int64_t diag = (q0 + kBQ + kBK - 1) / kBK;
    kt_end = diag < n_kt ? diag : n_kt;
  }
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window > 0) kt_begin = (q0 - window) / kBK;

  float m[4], l[4], acc[4][NCH * VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH * VEC; ++c) acc[i][c] = 0.f;
  }

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();   // the previous tile's p and v are consumed
    stage_tile<D, false>(k + head, k0, s_len, ks, LDQ, 1.f);
    stage_tile<D, false>(v + head, k0, s_len, vs, D, 1.f);
    __syncthreads();

    // s = (q / sqrt(D)) k^T on the 4 x 4 micro-tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(qs + (ty * 4 + i) * LDQ + kk, a[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(ks + (tx + 16 * j) * LDQ + kk, b[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float m_cur = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        if (col >= s_len) {
          s[i][j] = -INFINITY;   // past S: an exact zero weight
        } else if ((causal && col > row) ||
                   (window > 0 && col <= row - window)) {
          s[i][j] = kMaskValue;
        }
        m_cur = fmaxf(m_cur, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      }
      const float m_new = fmaxf(m[i], m_cur);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH * VEC; ++c) acc[i][c] *= corr;
    }

    __syncthreads();   // every thread is done with the k tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty * 4 + i) * kLDP + tx + 16 * j] = s[i][j];
    __syncwarp();      // a row's p is written and read by one half-warp

    // acc += p v
#pragma unroll 2
    for (int jj = 0; jj < kBK; jj += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(ps + (ty * 4 + i) * kLDP + jj, p[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = vs + (jj + e) * D;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          float vv[VEC];
          const float* src = vrow + ch * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            load4(src, vv);
          } else {
#pragma unroll
            for (int c = 0; c < VEC; ++c) vv[c] = src[c];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[i][ch * VEC + c] = fmaf(p[i][e], vv[c], acc[i][ch * VEC + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + head + row * D;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        store1(out + ch * 16 * VEC + tx * VEC + c, acc[i][ch * VEC + c] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t bh, int64_t s_len, int64_t d_scale, int causal,
                   int64_t window, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (s_len + kBQ - 1) / kBQ;
  const int64_t n_ctas = bh * n_qt;
  if (n_ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_ctas), kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len,
      static_cast<int>(n_qt), sqrtf(static_cast<float>(d_scale)), causal,
      window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int64_t bh, int64_t s_len, int64_t d, int64_t d_scale,
                       int causal, int64_t window, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, bh, s_len, d_scale, causal, window,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, bh, s_len, d_scale, causal, window,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, bh, s_len, d_scale, causal, window,
                            stream);
    case 256:
      return launch<256, T>(q, k, v, o, bh, s_len, d_scale, causal, window,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (bh, s_len, d) contiguous, 16-byte aligned; dtype 0 = f32,
// 1 = bf16; d in {32, 64, 128, 256} (the wrapper zero-pads other head
// dims); d_scale is the true head dim; window <= 0 means no sliding window.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int64_t bh, int64_t s_len, int64_t d,
                          int64_t d_scale, int dtype, int causal,
                          int64_t window, void* stream) {
  if (bh <= 0 || s_len <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, o, bh, s_len, d, d_scale, causal, window,
                            st);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, bh, s_len, d, d_scale, causal,
                                    window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"

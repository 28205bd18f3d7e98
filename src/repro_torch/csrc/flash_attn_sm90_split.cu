// Flash-attention forward on Hopper tensor cores (sm_90a) for f32 inputs and
// for head dims above 256: wgmma on operands split into 16-bit terms.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attn/kernel.py:
//   flash_attention (body _flash_kernel) -> repro_flash_attention (f32,
//   D <= 256) and repro_flash_attention_wide (f32, bf16 and fp16, D > 256).
// bf16 and fp16 with D <= 256 take flash_attn_sm90.cu. The wrapper routes by
// dtype and D, never by a failure.
//
// It computes what _flash_kernel computes, on q/k/v of shape (B*H, S, D):
//   * the online softmax with running max m, normaliser l and accumulator
//     o in f32;
//   * masked scores of -1e30 (causal: col > row; sliding window:
//     col <= row - window), so a tile that is fully masked for a row while
//     m is still -1e30 adds exp(0) = 1 per entry and the first real score
//     wipes it with corr = exp(-1e30 - m) = 0; -inf (an exact zero weight)
//     for keys past S, so any S is taken;
//   * whole kv tiles right of the diagonal and left of the window skipped
//     by the bounds of the kv loop;
//   * out = o / max(l, 1e-30), rounded once to the input dtype.
// The f32 score q.k is scaled by log2(e) / sqrt(d_scale) after the product
// (q is not rounded to 16 bits divided by sqrt(D), which is no power of two
// at D = 512), d_scale being the true head dim of a zero-padded input.
//
// Accuracy. The reference keeps q / sqrt(D), the scores, p and o in f32;
// wgmma multiplies 16-bit operands into f32 sums. So:
//   * f32 inputs: each of q, k and v is split into three bf16 terms,
//     x = x0 + x1 + x2, each the round-to-nearest of what the earlier ones
//     leave (together they carry x's 24 bits), and each product is the sum
//     of the six leading cross products x2y0, x1y1, x0y2, x1y0, x0y1, x0y0
//     (the three dropped ones are below 2^-24 of |x y|). The f32 p is split
//     the same way for p v. In the score, x0y0 and the five small products
//     go into two accumulators that are added once in f32, and each kv
//     tile's p v goes into a fresh accumulator that the threads add to o in
//     f32 (o * corr + tile), so the tensor cores' own f32 sums run over at
//     most D/16 (q k) or 2 x 6 (p v) steps, never over the sequence;
//   * bf16 and fp16 inputs above D = 256: q, k and v are exact in their
//     dtype; p is split into two terms of that dtype, p = p0 + p1, and both
//     p1 v and p0 v go into the f32 accumulator, so p keeps 16 (bf16) or 22
//     (fp16) bits where one rounding would keep 8 or 11: the output differs
//     from the plain version's by at most about one output ulp.
//
// What bounds it: tensor-core operations. At (8, 24, 2048, 128) f32 causal
// the work is 2*B*H*S^2*D = 2.06e11 FLOP: 0.42 ms at the data sheet's TF32
// rate (495 TFLOP/s, the card's f32 tensor rate); this design runs six bf16
// products for each, 1.25 ms at 989 TFLOP/s, its own floor. At (2, 8, 1024,
// 512) bf16 causal: 1.7e10 FLOP, 0.017 ms at 989 TFLOP/s, under the 0.020 ms
// it takes to move q, k, v and o once; the score is recomputed once per
// 256-column output slice and p v runs twice, so this design's floor there
// is twice the operations.
//
// What this design does about it:
//   * one CTA of 256 threads (two warpgroups of 64 query rows each, which
//     share every k and v tile: the bytes a CTA reads from L2 for a tile
//     are spread over 128 rows) per (b*h, 128-query tile, DV-column output
//     slice): DV = 128 for f32 (o and the fresh p v tile take 64 registers
//     each), 256 for 16-bit; a D above DV takes ceil(D / DV) CTAs per
//     query tile, each recomputing the score over the whole D (16-bit at
//     D = 512 twice). Consecutive CTAs share one head's q and k (its slices
//     are neighbours) and walk its query tiles from the last (heaviest
//     under a causal mask);
//   * no TMA and no producer warp: the threads load every piece. f32 pieces
//     are read from global memory (32-byte loads, eight threads a
//     64-column row), split, and stored in shared memory; 16-bit ones are
//     copied by cp.async. Either way they land in the 128-byte swizzle that
//     wgmma's descriptors describe (64-column chunks of 128-byte rows), and
//     a fence.proxy.async and a barrier hand them to the tensor cores;
//   * q is loaded (and split) once per CTA and stays in shared memory where
//     it fits (f32 D <= 128: 96 KB; 16-bit D <= 512: 128 KB); above that it
//     streams with k. The walk is a sequence of steps: the score's 64-column
//     chunks of a kv tile, then its softmax and p v. Each step's pieces (a
//     k chunk, or the v slice) are loaded P steps ahead, while the wgmmas
//     of the steps between run: f32 one step ahead (the split needs
//     registers), 16-bit three (cp.async needs none), through a ring of
//     P + 2 chunk buffers, so shared memory does not grow with D. Shared
//     memory at most: f32 157 KB (q resident) or 205 KB (streamed), 16-bit
//     201 KB or 153 KB; one CTA an SM;
//   * S = Q K^T by wgmma m64nBKk16 with both operands K-major in shared
//     memory (BK = 32 keys for f32, 64 for 16-bit); the online softmax on
//     the accumulator fragment (the shared softmax_tile: masks only on
//     tiles that cross the diagonal, the window's edge or S);
//   * O += P V by wgmma with the terms of p from registers (the f32
//     accumulator layout of m64nN is the A-operand layout of m64k16) and V
//     as an MN-major B operand (the descriptor's transpose bit);
//   * the epilogue divides once and stores from registers.
// Not done yet: the two warpgroups' softmax taking turns with the other's
// products, and the f32 split's loads further ahead.
//
// Launches on the caller's stream, allocates nothing, never synchronises;
// the entry points return a cudaError_t.
#include <cmath>

#include "flash_attn_sm90.cuh"

namespace {

constexpr int kSplitThreads = 256;                // two warpgroups
constexpr int kSplitBQ = 128;                     // query rows per CTA
constexpr int kChunkCols = 64;                    // head-dim columns a chunk
constexpr int kQChunkBytes = kSplitBQ * kRowBytes;  // one q chunk term, 16 KB

// per input dtype: the wgmma operand type M, the 16-bit terms of q, k and v
// (NT) and of p (NP), the key rows of a kv tile (BK), the output columns of
// a CTA (DV), the most 64-column chunks of q kept resident (kMaxRes), and
// how many load steps run ahead of the wgmmas (P: f32 pieces are split in
// registers one step ahead, 16-bit ones copied by cp.async three ahead)
template <typename T>
struct Split;

template <>
struct Split<float> {
  using M = __nv_bfloat16;
  static constexpr int NT = 3, NP = 3, BK = 32, DV = 128, kMaxRes = 2, P = 1;
};

template <>
struct Split<__nv_bfloat16> {
  using M = __nv_bfloat16;
  static constexpr int NT = 1, NP = 2, BK = 64, DV = 256, kMaxRes = 8, P = 3;
};

template <>
struct Split<__half> {
  using M = __half;
  static constexpr int NT = 1, NP = 2, BK = 64, DV = 256, kMaxRes = 8, P = 3;
};

// shared memory: [q, resident: n_ch chunks of NT terms][a ring of R chunk
// buffers: the streamed q chunk's NT terms, then the k chunk's][the v slice:
// NT terms of DV / 64 chunks]; every chunk term 1024-byte aligned. R = P + 2:
// a buffer is refilled only once both warpgroups have waited for the wgmmas
// that read it, before the barrier of an earlier step
template <typename T, bool kQRes>
struct SplitSmem {
  using SP = Split<T>;
  static constexpr int R = SP::P + 2;
  static constexpr int kKBytes = SP::BK * kRowBytes;   // one k/v chunk term
  static constexpr int kQBuf = kQRes ? 0 : SP::NT * kQChunkBytes;
  static constexpr int kBuf = kQBuf + SP::NT * kKBytes;
  static constexpr int kV = SP::NT * (SP::DV / kChunkCols) * kKBytes;
  static constexpr int kFixed = R * kBuf + kV + 1024;  // + the alignment
  static constexpr int bytes(int n_ch) {
    return kFixed + (kQRes ? n_ch * SP::NT * kQChunkBytes : 0);
  }
};

template <typename M>
__device__ __forceinline__ float2 unpack2(uint32_t w);

template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// (a, b) -> N terms of M, term t the round-to-nearest of what terms 0..t-1
// leave; the remainders are exact in f32
template <typename M, int N>
__device__ __forceinline__ void split2(float a, float b, uint32_t (&w)[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) {
    w[t] = pack2<M>(a, b);
    if (t + 1 < N) {
      const float2 h = unpack2<M>(w[t]);
      a -= h.x;
      b -= h.y;
    }
  }
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 8 consecutive f32 at p -> their three bf16 terms, 8 values each
__device__ __forceinline__ void load_split(const float* p,
                                           uint32_t (&w)[3][4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t[3];
    split2<__nv_bfloat16, 3>(x[2 * i], x[2 * i + 1], t);
#pragma unroll
    for (int j = 0; j < 3; ++j) w[j][i] = t[j];
  }
}

// rows row0 .. row0 + R - 1, columns col0 .. col0 + 63 of one (S, d) f32
// head (every thread of the CTA a share) -> three swizzled bf16 chunk terms
// at dst + t * term_stride; rows at or past S and columns at or past d are
// zero
template <int R>
__device__ __forceinline__ void load_chunk(uint32_t dst, int term_stride,
                                           const float* __restrict__ head,
                                           int row0, int col0, int s_len,
                                           int d) {
  constexpr int kUnits = R * (kChunkCols / 8);   // 16-byte units of a term
  static_assert(kUnits % kSplitThreads == 0, "units split evenly");
#pragma unroll
  for (int i = 0; i < kUnits / kSplitThreads; ++i) {
    const int idx = static_cast<int>(threadIdx.x) + kSplitThreads * i;
    const int r = idx / 8;
    const int u = idx % 8;
    const int row = row0 + r;
    const int col = col0 + 8 * u;
    uint32_t w[3][4] = {};
    if (row < s_len && col < d) {
      load_split(head + static_cast<int64_t>(row) * d + col, w);
    }
    // the 128-byte swizzle: 16-byte unit u of row r lands at unit u ^ (r % 8)
    const uint32_t off = r * kRowBytes + ((u ^ (r & 7)) << 4);
#pragma unroll
    for (int t = 0; t < 3; ++t) sts128(dst + t * term_stride + off, w[t]);
  }
}

// the stores above reach the tensor cores' (async) proxy, then every thread
// has written
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// 16 bytes global -> shared without registers; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16-bit pieces (one term, no split): cp.async into the swizzled layout,
// completed by cp_async_wait
template <typename T, int R>
__device__ __forceinline__ void copy_chunk(uint32_t dst,
                                           const T* __restrict__ head,
                                           int row0, int col0, int s_len,
                                           int d) {
  constexpr int kUnits = R * (kChunkCols / 8);
  static_assert(kUnits % kSplitThreads == 0, "units split evenly");
#pragma unroll
  for (int i = 0; i < kUnits / kSplitThreads; ++i) {
    const int idx = static_cast<int>(threadIdx.x) + kSplitThreads * i;
    const int r = idx / 8;
    const int u = idx % 8;
    const int row = row0 + r;
    const int col = col0 + 8 * u;
    const bool valid = row < s_len && col < d;
    cp_async16(dst + r * kRowBytes + ((u ^ (r & 7)) << 4),
               head + (valid ? static_cast<int64_t>(row) * d + col : 0),
               valid);
  }
}

// one 64-column chunk (rows row0 ..) of a head into its terms at dst: f32
// split through registers, 16-bit copied as it is
template <typename T, int R>
__device__ __forceinline__ void fetch_chunk(uint32_t dst, int term_stride,
                                            const T* __restrict__ head,
                                            int row0, int col0, int s_len,
                                            int d) {
  if constexpr (std::is_same<T, float>::value) {
    load_chunk<R>(dst, term_stride, head, row0, col0, s_len, d);
  } else {
    copy_chunk<T, R>(dst, head, row0, col0, s_len, d);
  }
}

// the six products of the f32 split, smallest first: (q term, k term) of
// products 0..4 (x2y0, x1y1, x0y2, x1y0, x0y1); x0y0 is issued apart
__device__ __forceinline__ constexpr int small_a(int i) {
  return i < 3 ? 2 - i : 4 - i;
}
__device__ __forceinline__ constexpr int small_b(int i) {
  return i < 3 ? i : i - 3;
}

// one 64-column chunk of s = q k^T for this warpgroup's 64 rows of q (terms
// kQChunkBytes apart) and the k chunk (terms kKBytes apart): 4 k-slices of
// 32 bytes into the 128-byte rows; the small products into s_lo, x0y0 into
// s_hi; first: the tile's first chunk, whose first k-slice overwrites the
// accumulators
template <typename T, int NLO>
__device__ __forceinline__ void issue_qk_chunk(float (&s_hi)[Split<T>::BK / 2],
                                               float (&s_lo)[NLO],
                                               uint32_t qa, uint32_t ka,
                                               bool first) {
  using SP = Split<T>;
  using M = typename SP::M;
  constexpr int BK = SP::BK;
  constexpr int kKBytes = BK * kRowBytes;
  if constexpr (SP::NT > 1) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss<M, BK>(
            s_lo, smem_desc(qa + small_a(i) * kQChunkBytes + 32 * kk, 16, 1024),
            smem_desc(ka + small_b(i) * kKBytes + 32 * kk, 16, 1024),
            !(first && kk == 0 && i == 0));
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_ss<M, BK>(s_hi, smem_desc(qa + 32 * kk, 16, 1024),
                  smem_desc(ka + 32 * kk, 16, 1024), !(first && kk == 0));
  }
}

// acc (+)= p v over BK / 16 k-slices of 16 key rows (2048 bytes); along the
// DV columns the 64-column chunks are BK * 128 bytes apart (the descriptor's
// leading offset), along keys the 8-row groups 1024 bytes (its stride).
// f32: the six products into a fresh acc, smallest first; 16-bit: p1 v then
// p0 v into o
template <typename T>
__device__ __forceinline__ void issue_pv_split(
    float (&acc)[Split<T>::DV / 2],
    const uint32_t (&p)[Split<T>::NP][Split<T>::BK / 16][4], uint32_t sv) {
  using SP = Split<T>;
  using M = typename SP::M;
  constexpr int BK = SP::BK;
  constexpr int kKBytes = BK * kRowBytes;
  constexpr int kTermBytes = (SP::DV / kChunkCols) * kKBytes;
  constexpr int kProducts = SP::NT > 1 ? 6 : 2;
#pragma unroll
  for (int i = 0; i < kProducts; ++i) {
    const int tp = SP::NT > 1 ? (i < 5 ? small_a(i) : 0) : 1 - i;
    const int tv = SP::NT > 1 ? (i < 5 ? small_b(i) : 0) : 0;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mma_rs<M, SP::DV>(
          acc, p[tp][kk],
          smem_desc(sv + tv * kTermBytes + kk * 16 * kRowBytes, kKBytes,
                    1024),
          SP::NT > 1 ? !(i == 0 && kk == 0) : 1);
    }
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<__nv_bfloat16>(a, b);
}

__device__ __forceinline__ void store2(__half* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<__half>(a, b);
}

template <typename T, bool kQRes>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_fwd_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s_len,
                       int d, int n_qt, int n_sl, float scale_log2,
                       int causal, int window) {
  using SP = Split<T>;
  using SM = SplitSmem<T, kQRes>;
  using M = typename SP::M;
  constexpr int NT = SP::NT;
  constexpr int NP = SP::NP;
  constexpr int BK = SP::BK;
  constexpr int DV = SP::DV;
  constexpr bool kTileAcc = NT > 1;   // f32: each tile's p v apart
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every chunk to it
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const int n_ch = d / kChunkCols;
  const uint32_t sq = base;   // resident q (kQRes)
  const uint32_t ring = sq + (kQRes ? n_ch * NT * kQChunkBytes : 0);
  const uint32_t sv = ring + SM::R * SM::kBuf;

  const int tid = threadIdx.x;
  // consecutive CTAs: one head's output slices, then its query tiles from
  // the last (heaviest under a causal mask) first
  const int per_bh = n_qt * n_sl;
  const int bh = static_cast<int>(blockIdx.x / per_bh);
  const int rem = static_cast<int>(blockIdx.x % per_bh);
  const int q0 = (n_qt - 1 - rem / n_sl) * kSplitBQ;
  const int c0 = (rem % n_sl) * DV;   // this CTA's first output column
  const int64_t head = static_cast<int64_t>(bh) * s_len * d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;

  // kv tile range, as _flash_kernel's fori_loop bounds
  const int n_kt = (s_len + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal) kt_end = min((q0 + kSplitBQ + BK - 1) / BK, n_kt);
  const int kt_begin = (window > 0 && q0 - window > 0) ? (q0 - window) / BK : 0;
  const int n_iter = kt_end - kt_begin;

  // warpgroup wg owns query rows q0 + 64 wg .. + 63; this thread holds rows
  // row_a and row_a + 8 of the accumulator fragments
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int row_lo = q0 + 64 * wg;
  const int row_a = row_lo + 16 * warp + lane / 4;
  const int col_l = 2 * (lane % 4);
  const uint32_t wg_rows = 64 * wg * kRowBytes;   // into each q chunk term

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float tile[kTileAcc ? DV / 2 : 1];
  // s_lo: the five small products of the f32 split (unused for 16-bit)
  float s_hi[BK / 2], s_lo[NT > 1 ? BK / 2 : 1];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_hi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (NT > 1 ? BK / 2 : 1); ++i) s_lo[i] = 0.f;
  uint32_t p[NP][BK / 16][4];
  RowState rs;

  // The walk is a sequence of steps, n_ch + 1 a kv tile: the score's
  // chunks c = 0 .. n_ch - 1 (k, and q where it streams, in ring buffer
  // kc % R, kc counting chunks over the walk), then the softmax and p v
  // (the v slice). Load step j fills what compute step j reads; it is
  // issued P steps ahead, right after compute step j - P is issued, so the
  // copies run under the wgmmas. Every step starts with a barrier that
  // publishes its pieces.
  constexpr int P = SP::P;
  constexpr int R = SM::R;
  const int per_tile = n_ch + 1;
  const int steps = n_iter * per_tile;
  auto load_step = [&](int j) {
    if (j >= steps) return;
    const int kt = kt_begin + j / per_tile;
    const int c = j % per_tile;
    if (c < n_ch) {
      const uint32_t buf = ring + ((j / per_tile * n_ch + c) % R) * SM::kBuf;
      if constexpr (!kQRes) {
        fetch_chunk<T, kSplitBQ>(buf, kQChunkBytes, qh, q0,
                                     kChunkCols * c, s_len, d);
      }
      fetch_chunk<T, BK>(buf + SM::kQBuf, SM::kKBytes, kh, kt * BK,
                             kChunkCols * c, s_len, d);
    } else {
#pragma unroll
      for (int cc = 0; cc < DV / kChunkCols; ++cc) {
        fetch_chunk<T, BK>(sv + cc * SM::kKBytes, SM::kV / NT, vh,
                               kt * BK, c0 + kChunkCols * cc, s_len, d);
      }
    }
  };

  if constexpr (kQRes) {
    for (int c = 0; c < n_ch; ++c) {
      fetch_chunk<T, kSplitBQ>(sq + c * NT * kQChunkBytes, kQChunkBytes,
                                   qh, q0, kChunkCols * c, s_len, d);
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    load_step(j);
    if constexpr (NT == 1) cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    if constexpr (NT == 1) cp_async_wait<P - 1>();   // this step's copies
    publish();
    const int it = st / per_tile;
    const int c = st % per_tile;
    if (c < n_ch) {
      const uint32_t buf = ring + ((it * n_ch + c) % R) * SM::kBuf;
      const uint32_t qa =
          (kQRes ? sq + c * NT * kQChunkBytes : buf) + wg_rows;
      pin(s_hi);
      if constexpr (NT > 1) pin(s_lo);
      wgmma_fence();
      issue_qk_chunk<T>(s_hi, s_lo, qa, buf + SM::kQBuf, c == 0);
      wgmma_commit();
      wgmma_wait<1>();   // this warpgroup's chunk before is read
      load_step(st + P);
      if constexpr (NT == 1) cp_async_commit();
      continue;
    }
    wgmma_wait<0>();
    pin(s_hi);
    if constexpr (NT > 1) {
      pin(s_lo);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s_hi[i] += s_lo[i];
    }
    softmax_tile<BK>(s_hi, rs, (kt_begin + it) * BK, row_a, col_l, row_lo,
                     s_len, causal, window, scale_log2);
    if constexpr (!kTileAcc) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[4 * j + 0] *= rs.corr_a;
        acc[4 * j + 1] *= rs.corr_a;
        acc[4 * j + 2] *= rs.corr_b;
        acc[4 * j + 3] *= rs.corr_b;
      }
    }
    // the f32 p as NP terms of the A operand: k-slice kk is registers
    // {a0, a1, a2, a3} = n8 blocks 2kk, 2kk + 1
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t ta[NP], tb[NP];
      split2<M, NP>(s_hi[4 * j + 0], s_hi[4 * j + 1], ta);
      split2<M, NP>(s_hi[4 * j + 2], s_hi[4 * j + 3], tb);
#pragma unroll
      for (int t = 0; t < NP; ++t) {
        p[t][j / 2][(j % 2) * 2 + 0] = ta[t];
        p[t][j / 2][(j % 2) * 2 + 1] = tb[t];
      }
    }
#pragma unroll
    for (int t = 0; t < NP; ++t) pin(p[t]);
    if constexpr (kTileAcc) {
      pin(tile);
      wgmma_fence();
      issue_pv_split<T>(tile, p, sv);
    } else {
      pin(acc);
      wgmma_fence();
      issue_pv_split<T>(acc, p, sv);
    }
    wgmma_commit();
    load_step(st + P);
    if constexpr (NT == 1) cp_async_commit();
    // p v done before the next step's barrier: the v slice is then free
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NP; ++t) pin(p[t]);
    if constexpr (kTileAcc) {
      pin(tile);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        acc[4 * j + 0] = fmaf(acc[4 * j + 0], rs.corr_a, tile[4 * j + 0]);
        acc[4 * j + 1] = fmaf(acc[4 * j + 1], rs.corr_a, tile[4 * j + 1]);
        acc[4 * j + 2] = fmaf(acc[4 * j + 2], rs.corr_b, tile[4 * j + 2]);
        acc[4 * j + 3] = fmaf(acc[4 * j + 3], rs.corr_b, tile[4 * j + 3]);
      }
    } else {
      pin(acc);
    }
  }
  if constexpr (NT == 1) cp_async_wait<0>();

  float l_a = rs.l_a, l_b = rs.l_b;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  const int row_b = row_a + 8;
  T* oh = o + head;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int col = c0 + 8 * j + col_l;
    if (col >= d) continue;
    if (row_a < s_len) {
      store2(oh + static_cast<int64_t>(row_a) * d + col, acc[4 * j + 0] / den_a,
             acc[4 * j + 1] / den_a);
    }
    if (row_b < s_len) {
      store2(oh + static_cast<int64_t>(row_b) * d + col, acc[4 * j + 2] / den_b,
             acc[4 * j + 3] / den_b);
    }
  }
}

template <typename T, bool kQRes>
cudaError_t launch_split_as(const void* q, const void* k, const void* v,
                            void* o, int n_bh, int s_len, int d, int n_qt,
                            int n_sl, float scale_log2, int causal, int win,
                            cudaStream_t stream) {
  auto kernel = flash_fwd_split_kernel<T, kQRes>;
  const int smem = SplitSmem<T, kQRes>::bytes(d / kChunkCols);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_ctas = static_cast<int64_t>(n_bh) * n_qt * n_sl;
  kernel<<<static_cast<unsigned>(n_ctas), kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, d, n_qt, n_sl,
      scale_log2, causal, win);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         int64_t n_bh, int64_t s_len, int64_t d,
                         int64_t d_scale, int causal, int64_t window,
                         cudaStream_t stream) {
  // the v slice is refilled P steps ahead, inside the next tile's score
  if (d <= 0 || d % kChunkCols || d / kChunkCols < Split<T>::P ||
      d_scale <= 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t n_qt = (s_len + kSplitBQ - 1) / kSplitBQ;
  const int64_t n_sl = (d + Split<T>::DV - 1) / Split<T>::DV;
  if (s_len > 0x7fffffff || d > 0x7fffffff ||
      n_bh * n_qt * n_sl > 0x7fffffff) {
    return cudaErrorInvalidConfiguration;
  }
  // a window of S or more masks nothing
  const int win = window > 0 && window < s_len ? static_cast<int>(window) : 0;
  // exp(x) = exp2(x * log2(e)): the scores are kept in log2 units
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / std::sqrt(static_cast<double>(d_scale)));
  const int args[] = {static_cast<int>(n_bh), static_cast<int>(s_len),
                      static_cast<int>(d), static_cast<int>(n_qt),
                      static_cast<int>(n_sl)};
  if (d / kChunkCols <= Split<T>::kMaxRes) {
    return launch_split_as<T, true>(q, k, v, o, args[0], args[1], args[2],
                                    args[3], args[4], scale_log2, causal, win,
                                    stream);
  }
  return launch_split_as<T, false>(q, k, v, o, args[0], args[1], args[2],
                                   args[3], args[4], scale_log2, causal, win,
                                   stream);
}

}  // namespace

extern "C" {

// The f32 route. q, k, v, o: (bh, s_len, d) f32, contiguous, 16-byte
// aligned; dtype must be 0 (f32); d a positive multiple of 64 (the wrapper
// zero-pads other head dims); d_scale is the true head dim, whose sqrt
// divides the scores; window <= 0 means no sliding window.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int64_t bh, int64_t s_len, int64_t d,
                          int64_t d_scale, int dtype, int causal,
                          int64_t window, void* stream) {
  if (bh <= 0 || s_len <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_split<float>(
      q, k, v, o, bh, s_len, d, d_scale, causal, window,
      static_cast<cudaStream_t>(stream)));
}

// The route above D = 256, every dtype: as repro_flash_attention, with
// dtype 0 = f32, 1 = bf16, 2 = fp16.
int repro_flash_attention_wide(const void* q, const void* k, const void* v,
                               void* o, int64_t bh, int64_t s_len, int64_t d,
                               int64_t d_scale, int dtype, int causal,
                               int64_t window, void* stream) {
  if (bh <= 0 || s_len <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_split<float>(q, k, v, o, bh, s_len, d, d_scale, causal,
                              window, st);
  } else if (dtype == 1) {
    err = launch_split<__nv_bfloat16>(q, k, v, o, bh, s_len, d, d_scale,
                                      causal, window, st);
  } else if (dtype == 2) {
    err = launch_split<__half>(q, k, v, o, bh, s_len, d, d_scale, causal,
                               window, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"

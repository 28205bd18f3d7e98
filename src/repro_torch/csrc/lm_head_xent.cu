// The LM head and its cross-entropy on Hopper tensor cores (sm_90a): wgmma
// + TMA, with the f32 products of the reference kept exact.
//
// Replaces no TPU kernel: the reference computes the vocab-parallel
// cross-entropy of src/repro/models/transformer.py (vocab_parallel_xent)
// as an f32 matmul of x and the f32 master w_out followed by XLA's
// elementwise passes. On the card the plain version of that formula ran
// three f32 GEMMs on the CUDA cores (TF32 is off) and some ten passes over
// a T x V_l f32 logits tensor. These kernels compute the same function:
//
//   forward   per row r of x (T x d) and this rank's columns of w (d x V_l):
//             m_l = max_v logit, s_l = sum_v exp(logit - m_l), ll_l = the
//             label's logit (0 when the label lies on another rank's
//             shard), with the columns at or past n_keep (the padded
//             vocab) masked to -1e30 as the reference masks them;
//   backward  given the cotangents a_r of s_l and b_r of ll_l, the logits'
//             gradient dS = a_r exp(logit - m_l) + b_r onehot(label)
//             (0 on masked columns), dX = dS w^T and dW = x^T dS.
//
// Exactness. Every f32 operand is split into three bf16 pieces, hi + mid +
// lo, by truncation (hi and mid keep the top 8 significant bits of what is
// left, lo rounds the last 8 and is exact), so the pieces sum back to the
// f32 value bitwise wherever lo stays above bf16's smallest subnormal
// (2^-133). A bf16 x bf16 product is exact in f32, so x w = x hi + x mid +
// x lo is the f32 product up to the order of the f32 sums; a bf16 x (the
// model's compute dtype) takes those three products, an f32 or fp16 x is
// split too and takes the six products whose pieces' orders sum to at most
// 2 (the dropped ones lie below 2^-24). dX, which the model rounds to bf16
// at once, takes dS_hi w_hi + dS_hi w_mid + dS_mid w_hi for a bf16 x (2^-16
// relative, far under bf16's 2^-8) and the six products otherwise.
// The tensor cores align and truncate inside their own sums, so each
// 64-deep stage is summed into a fresh register tile and that tile is
// added to the running f32 sum with an ordinary rounded add: the running
// sum sees one rounding a stage, as an f32 GEMM's sees one a product.
//
// What bounds it: tensor-core operations. At BERT-Large's head (T 16,384,
// d 1,024, V_l 30,528) one bf16 product is 1.02 TFLOP: the forward runs 3,
// the backward 9 (3 to recompute the logits, 3 for dX, 3 for dW), 12.4 ms
// at 989 TFLOP/s. Memory is secondary: x, w's pieces and the 4,096-row
// chunk of dS (three bf16 pieces) are read from L2 or HBM once a tile.
//
// What this design does about it:
//   * one CTA of 384 threads, about one an SM, per 128-row tile and a run
//     of 128-column tiles: two consumer warpgroups own 64 rows each, one
//     producer thread issues every TMA load into a ring of 2-3 stages of
//     64-deep slices of every piece (128-byte swizzle, the layout wgmma's
//     descriptors describe) and refills it while the consumers run an
//     epilogue; setmaxnreg moves registers from the producer warpgroup to
//     the consumers;
//   * a stage's products go to a fresh register tile, added to the
//     running sum once they land: two tiles in turn for dX, whose products
//     then run under the add, one for the other kernels, which then spill
//     no register (each the faster form on an H100);
//   * an operand may lie K-major (x and w's transposed pieces in the
//     forward, dS for dX) or MN-major (w's pieces for dX, x and dS for
//     dW): the descriptors' transpose bits take either, so nothing is
//     transposed in memory besides w's split;
//   * the forward never stores the logits: each CTA walks a segment of the
//     vocab tiles for its 128 rows and keeps an online max and sum of
//     exp (flash attention's forward without the P V product); segments
//     split the vocab when there are fewer row tiles than SMs, and the
//     wrapper merges their (m, s, ll) with T-length vectors (every entry
//     point takes its segment count from the wrapper, which alone decides
//     it);
//   * the backward recomputes the logits a tile at a time and writes dS
//     as three bf16 pieces for 4,096 rows at a time (never the whole
//     T x V_l); dX and dW are then two tensor-core products over that
//     chunk, dW accumulated over the chunks in a fixed order (no atomics:
//     the result does not depend on timing).
//
// The tensor maps are encoded on the host per call with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (no
// -lcuda), and passed as __grid_constant__ parameters; each kernel's
// shared-memory opt-in and register check run once a device. Every launch
// runs on the caller's stream, allocates nothing, never synchronises; the entry
// points return a cudaError_t.
#include <atomic>

#include "flash_attn_sm90.cuh"

namespace {

constexpr int kBM = 128;                 // output rows of a tile
constexpr int kBN = 128;                 // output columns of a tile
constexpr int kBK = 64;                  // depth of a stage
constexpr int kConsumers = 256;          // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kChunk = 64 * kRowBytes;   // 64 swizzled rows of 128 bytes
constexpr int kPiece = kBM * kBK * 2;    // one piece's slice of a stage
constexpr int kMaxSmem = 232448;
constexpr int kGroup = 8;                // row tiles a raster group walks
static_assert(kBM == kBN, "a stage holds A and B slices of one size");

enum Epi { kStats = 0, kDlogits = 1, kStore = 2 };

template <int NA, int NB>
struct Ring {
  static constexpr int kStageBytes = (NA + NB) * kPiece;
  static constexpr int kFit = (kMaxSmem - 2048) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 16 * kStages + 1024;
  static_assert(kStages >= 2, "a ring needs two stages");
};

// d (64 x 128, f32) = A (64 x 16) * B (16 x 128) from shared memory; TA / TB
// set the descriptors' transpose bits (1: the operand is MN-major)
template <int TA, int TB>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// the descriptor of k-slice kk (16 deep) of a 64-deep slice: K-major, the
// slice's 128-byte rows hold k, and kk is 32 bytes into them; MN-major, the
// rows hold 64 of m (or n), chunks of 64 lie kChunk apart (the leading
// offset) and kk is 16 rows further on
template <bool MN>
__device__ __forceinline__ uint64_t desc(uint32_t addr, int kk) {
  return MN ? smem_desc(addr + kk * 16 * kRowBytes, kChunk, 1024)
            : smem_desc(addr + kk * 32, 16, 1024);
}

// every product of the stage's slices into t: pairs (i, j) of A piece i and
// B piece j with i + j <= MAXSUM, the smallest first; the first overwrites t
template <int NA, int NB, int MAXSUM, bool AMN, bool BMN>
__device__ __forceinline__ void issue_stage(float (&t)[64], uint32_t stage,
                                            int wg) {
  int acc = 0;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int s = MAXSUM; s >= 0; --s) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int j = s - i;
        if (j < 0 || j >= NB) continue;
        mma128<AMN ? 1 : 0, BMN ? 1 : 0>(
            t, desc<AMN>(stage + i * kPiece + wg * kChunk, kk),
            desc<BMN>(stage + (NA + j) * kPiece, kk), acc);
        acc = 1;
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void add_into(float (&acc)[N], const float (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += t[i];
}

__device__ __forceinline__ void release(uint32_t empty, int it, int stages,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * (it % stages));
}

// one stage of the main loop into t (P picks t0 or t1 at compile time):
// wait for its slices, issue its products, then retire the previous stage
// (its tile is added to acc and its slot handed back to the producer)
template <int P, int NA, int NB, int MAXSUM, bool AMN, bool BMN>
__device__ __forceinline__ void stage_step(float (&acc)[64], float (&t0)[64],
                                           float (&t1)[64], uint32_t ring,
                                           uint32_t full, uint32_t empty,
                                           int& it, bool first, int wg,
                                           int lane) {
  using R = Ring<NA, NB>;
  float(&t)[64] = P ? t1 : t0;
  float(&prev)[64] = P ? t0 : t1;
  const int st = it % R::kStages;
  mbar_wait(full + 8 * st, (it / R::kStages) & 1);
  pin(t);
  wgmma_fence();
  issue_stage<NA, NB, MAXSUM, AMN, BMN>(t, ring + st * R::kStageBytes, wg);
  wgmma_commit();
  if (!first) {
    wgmma_wait<1>();
    pin(prev);
    add_into(acc, prev);
    release(empty, it - 1, R::kStages, lane);
  }
  ++it;
}

// PP: two register tiles take the stages in turn, so one stage's products
// run while the previous stage's tile is added into the running sum; else
// one tile, each stage's products awaited before its add (no register
// spills, and the other warpgroup's products keep the tensor cores busy)
template <bool PP, int NA, int NB, int MAXSUM, bool AMN, bool BMN>
__device__ __forceinline__ void main_loop(float (&acc)[64], float (&t0)[64],
                                          float (&t1)[64], uint32_t ring,
                                          uint32_t full, uint32_t empty,
                                          int& it, int nk, int wg, int lane) {
  using R = Ring<NA, NB>;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if (!PP) {
    for (int c = 0; c < nk; ++c, ++it) {
      const int st = it % R::kStages;
      mbar_wait(full + 8 * st, (it / R::kStages) & 1);
      pin(t0);
      wgmma_fence();
      issue_stage<NA, NB, MAXSUM, AMN, BMN>(t0, ring + st * R::kStageBytes,
                                            wg);
      wgmma_commit();
      wgmma_wait<0>();
      pin(t0);
      add_into(acc, t0);
      release(empty, it, R::kStages, lane);
    }
    return;
  }
  int c = 0;
  for (; c + 1 < nk; c += 2) {
    stage_step<0, NA, NB, MAXSUM, AMN, BMN>(acc, t0, t1, ring, full, empty,
                                            it, c == 0, wg, lane);
    stage_step<1, NA, NB, MAXSUM, AMN, BMN>(acc, t0, t1, ring, full, empty,
                                            it, false, wg, lane);
  }
  if (c < nk) {
    stage_step<0, NA, NB, MAXSUM, AMN, BMN>(acc, t0, t1, ring, full, empty,
                                            it, c == 0, wg, lane);
  }
  wgmma_wait<0>();
  if ((nk - 1) & 1) {
    pin(t1);
    add_into(acc, t1);
  } else {
    pin(t0);
    add_into(acc, t0);
  }
  release(empty, it - 1, R::kStages, lane);
}

struct Params {
  int m_len, n_len, k_len;       // the product's extents
  int n_mt, n_nt, n_seg;         // row tiles, column tiles, column segments
  // forward (kStats) and dS (kDlogits): per row of this launch
  const int* lab;                // local label column, or -1
  int n_keep;                    // columns at or past it are masked
  float* out_m;                  // kStats: (n_seg, m_len) each
  float* out_s;
  float* out_ll;
  const float* m_l;              // kDlogits: the forward's row max
  const float* ca;               // cotangent of s_l
  const float* cb;               // cotangent of ll_l
  uint16_t* ds;                  // (3, m_len, ds_ld) bf16 pieces
  int64_t ds_ld, ds_piece;
  // kStore: out (m_len x n_len, f32, row stride out_ld), += when accumulate
  float* out;
  int64_t out_ld;
  int accumulate;
};

__device__ __forceinline__ void split3(float v, uint16_t& h, uint16_t& m,
                                       uint16_t& l) {
  const uint32_t hv = __float_as_uint(v) & 0xFFFF0000u;
  const float r = v - __uint_as_float(hv);
  const uint32_t mv = __float_as_uint(r) & 0xFFFF0000u;
  const float q = r - __uint_as_float(mv);
  h = static_cast<uint16_t>(hv >> 16);
  m = static_cast<uint16_t>(mv >> 16);
  l = __bfloat16_as_ushort(__float2bfloat16_rn(q));
}

// the forward's online max / sum of exp / label logit of one tile
struct Stats {
  float m_a = -INFINITY, m_b = -INFINITY;  // running max, the row's
  float s_a = 0.f, s_b = 0.f;              // this thread's columns only
  float ll_a = 0.f, ll_b = 0.f;
};

template <bool kMask>
__device__ __forceinline__ void stats_tile(float (&x)[64], Stats& st, int n0,
                                           int col_l, int lab_a, int lab_b,
                                           const Params& p) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + 8 * j + col_l + (e & 1);
      float v = x[4 * j + e];
      if (kMask) {
        if (col >= p.n_len) {
          v = -INFINITY;           // past V_l: no column at all
        } else if (col >= p.n_keep) {
          v = kMaskValue;          // the padded vocab, as the reference
        }
        x[4 * j + e] = v;
      }
      if (e < 2) {
        if (col == lab_a) st.ll_a = v;
        mx_a = fmaxf(mx_a, v);
      } else {
        if (col == lab_b) st.ll_b = v;
        mx_b = fmaxf(mx_b, v);
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    sum_a += expf(x[4 * j + 0] - mn_a) + expf(x[4 * j + 1] - mn_a);
    sum_b += expf(x[4 * j + 2] - mn_b) + expf(x[4 * j + 3] - mn_b);
  }
  const float corr_a = st.m_a == -INFINITY ? 0.f : expf(st.m_a - mn_a);
  const float corr_b = st.m_b == -INFINITY ? 0.f : expf(st.m_b - mn_b);
  st.s_a = st.s_a * corr_a + sum_a;
  st.s_b = st.s_b * corr_b + sum_b;
  st.m_a = mn_a;
  st.m_b = mn_b;
}

__device__ __forceinline__ float dlogit(float x, int col, int lab, float m,
                                        float a, float b, int n_keep) {
  if (col >= n_keep) return 0.f;
  const float g = a * expf(x - m);
  return col == lab ? g + b : g;
}

template <int NA, int NB, int MAXSUM, bool AMN, bool BMN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
lm_head_xent_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const Params p) {
  using R = Ring<NA, NB>;
  // two temporaries for dX (K-major dS against MN-major w, a V_l-deep
  // sum), one for the others: each the faster on an H100 by 7-20 %
  constexpr bool kPP = EPI == kStore && !AMN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t full = ring + R::kBarOffset;
  const uint32_t empty = full + 8 * R::kStages;

  // grouped raster: kGroup row tiles at a time walk the column segments,
  // so the CTAs resident at once share their A and B slices in L2
  const int per_group = kGroup * p.n_seg;
  const int id = static_cast<int>(blockIdx.x);
  const int first = (id / per_group) * kGroup;
  const int gsize = min(p.n_mt - first, kGroup);
  const int local = id % per_group;
  const int mt = first + local % gsize;
  const int seg = local / gsize;
  const int nt_begin =
      static_cast<int>(static_cast<int64_t>(seg) * p.n_nt / p.n_seg);
  const int nt_end =
      static_cast<int>(static_cast<int64_t>(seg + 1) * p.n_nt / p.n_seg);
  const int m0 = mt * kBM;
  const int nk = (p.k_len + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < R::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (tid == kConsumers) {
      int it = 0;
      for (int nt = nt_begin; nt < nt_end; ++nt) {
        const int n0 = nt * kBN;
        for (int c = 0; c < nk; ++c, ++it) {
          const int st = it % R::kStages;
          const int k0 = c * kBK;
          if (it >= R::kStages) {
            mbar_wait(empty + 8 * st, ((it / R::kStages) - 1) & 1);
          }
          const uint32_t bar = full + 8 * st;
          const uint32_t dst = ring + st * R::kStageBytes;
          mbar_expect_tx(bar, R::kStageBytes);
          for (int i = 0; i < NA; ++i) {
            if (AMN) {
              tma_load(dst + i * kPiece, &tm_a, bar, m0, k0, i);
              tma_load(dst + i * kPiece + kChunk, &tm_a, bar, m0 + 64, k0, i);
            } else {
              tma_load(dst + i * kPiece, &tm_a, bar, k0, m0, i);
            }
          }
          for (int j = 0; j < NB; ++j) {
            const uint32_t b = dst + (NA + j) * kPiece;
            if (BMN) {
              tma_load(b, &tm_b, bar, n0, k0, j);
              tma_load(b + kChunk, &tm_b, bar, n0 + 64, k0, j);
            } else {
              tma_load(b, &tm_b, bar, k0, n0, j);
            }
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  // this thread holds rows row_a and row_a + 8 of the fragments, columns
  // 8 j + col_l and + 1
  const int row_a = m0 + 64 * wg + 16 * warp + lane / 4;
  const int row_b = row_a + 8;
  const int col_l = 2 * (lane % 4);
  const bool in_a = row_a < p.m_len, in_b = row_b < p.m_len;

  float acc[64], t0[64], t1[64];
  int it = 0;
  Stats st;
  int lab_a = -1, lab_b = -1;
  if (EPI != kStore) {
    lab_a = in_a ? p.lab[row_a] : -1;
    lab_b = in_b ? p.lab[row_b] : -1;
  }

  for (int nt = nt_begin; nt < nt_end; ++nt) {
    const int n0 = nt * kBN;
    main_loop<kPP, NA, NB, MAXSUM, AMN, BMN>(acc, t0, t1, ring, full, empty,
                                             it, nk, wg, lane);
    if (EPI == kStats) {
      if (n0 + kBN > p.n_keep) {
        stats_tile<true>(acc, st, n0, col_l, lab_a, lab_b, p);
      } else {
        stats_tile<false>(acc, st, n0, col_l, lab_a, lab_b, p);
      }
    } else if (EPI == kDlogits) {
      const float m_a = in_a ? p.m_l[row_a] : 0.f;
      const float m_b = in_b ? p.m_l[row_b] : 0.f;
      const float a_a = in_a ? p.ca[row_a] : 0.f;
      const float a_b = in_b ? p.ca[row_b] : 0.f;
      const float b_a = in_a ? p.cb[row_a] : 0.f;
      const float b_b = in_b ? p.cb[row_b] : 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + col_l;
        if (col >= p.ds_ld) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? in_b : in_a)) continue;
          const int row = h ? row_b : row_a;
          const float v0 = dlogit(acc[4 * j + 2 * h], col, h ? lab_b : lab_a,
                                  h ? m_b : m_a, h ? a_b : a_a, h ? b_b : b_a,
                                  p.n_keep);
          const float v1 = dlogit(acc[4 * j + 2 * h + 1], col + 1,
                                  h ? lab_b : lab_a, h ? m_b : m_a,
                                  h ? a_b : a_a, h ? b_b : b_a, p.n_keep);
          uint16_t h0, d0, l0, h1, d1, l1;
          split3(v0, h0, d0, l0);
          split3(v1, h1, d1, l1);
          uint16_t* dst = p.ds + static_cast<int64_t>(row) * p.ds_ld + col;
          *reinterpret_cast<uint32_t*>(dst) = h0 | (uint32_t(h1) << 16);
          *reinterpret_cast<uint32_t*>(dst + p.ds_piece) =
              d0 | (uint32_t(d1) << 16);
          *reinterpret_cast<uint32_t*>(dst + 2 * p.ds_piece) =
              l0 | (uint32_t(l1) << 16);
        }
      }
    } else {
      const bool pairs = (p.out_ld & 1) == 0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + col_l;
        if (col >= p.n_len) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h ? in_b : in_a)) continue;
          float* dst =
              p.out + static_cast<int64_t>(h ? row_b : row_a) * p.out_ld + col;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pairs && col + 1 < p.n_len) {
            float2* d2 = reinterpret_cast<float2*>(dst);
            if (p.accumulate) {
              const float2 o = *d2;
              v0 += o.x;
              v1 += o.y;
            }
            *d2 = make_float2(v0, v1);
          } else {
            if (p.accumulate) v0 += dst[0];
            dst[0] = v0;
            if (col + 1 < p.n_len) {
              if (p.accumulate) v1 += dst[1];
              dst[1] = v1;
            }
          }
        }
      }
    }
  }

  if (EPI == kStats) {
    float s_a = st.s_a, s_b = st.s_b, ll_a = st.ll_a, ll_b = st.ll_b;
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
      s_b += __shfl_xor_sync(0xffffffffu, s_b, off);
      ll_a += __shfl_xor_sync(0xffffffffu, ll_a, off);
      ll_b += __shfl_xor_sync(0xffffffffu, ll_b, off);
    }
    if (lane % 4 == 0) {
      const int64_t base = static_cast<int64_t>(seg) * p.m_len;
      if (in_a) {
        p.out_m[base + row_a] = st.m_a;
        p.out_s[base + row_a] = s_a;
        p.out_ll[base + row_a] = ll_a;
      }
      if (in_b) {
        p.out_m[base + row_b] = st.m_b;
        p.out_s[base + row_b] = s_b;
        p.out_ll[base + row_b] = ll_b;
      }
    }
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a bf16 operand seen as (inner, outer, pieces), innermost first, rows
// ld elements apart and pieces piece elements apart; boxes of 64 inner x
// box_rows outer land in shared memory in the 128-byte swizzle, and
// whatever lies past an extent arrives as zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t inner,
                     int64_t outer, int64_t pieces, int64_t ld,
                     int64_t piece, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(pieces)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(piece) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Operand {
  const void* ptr;
  int64_t inner, outer, pieces, ld, piece;
};

// A is m x k (K-major: inner k; MN-major: inner m), B is k x n (K-major:
// inner k; MN-major: inner n)
template <int NA, int NB, int MAXSUM, bool AMN, bool BMN, int EPI>
cudaError_t launch(const Operand& a, const Operand& b, Params p,
                   cudaStream_t stream) {
  using R = Ring<NA, NB>;
  if (p.m_len <= 0 || p.n_len <= 0 || p.k_len <= 0) return cudaSuccess;
  CUtensorMap tm_a, tm_b;
  cudaError_t err;
  if ((err = make_map(&tm_a, a.ptr, a.inner, a.outer, a.pieces, a.ld,
                      a.piece, AMN ? 64 : kBM)) != cudaSuccess ||
      (err = make_map(&tm_b, b.ptr, b.inner, b.outer, b.pieces, b.ld,
                      b.piece, BMN ? 64 : kBN)) != cudaSuccess) {
    return err;
  }
  p.n_mt = (p.m_len + kBM - 1) / kBM;
  p.n_nt = (p.n_len + kBN - 1) / kBN;
  if (p.n_seg < 1 || p.n_seg > p.n_nt) return cudaErrorInvalidValue;
  auto kernel = lm_head_xent_kernel<NA, NB, MAXSUM, AMN, BMN, EPI>;
  // once a device (bit dev of ready): the shared-memory opt-in, and the
  // register check (setmaxnreg.inc would wait forever if the CTA's
  // registers at launch could not cover the consumers' count after the
  // producer's release)
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if ((ready.load(std::memory_order_acquire) & bit) == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               R::kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) {
      return err;
    }
    if (attr.numRegs * kThreads <
        kConsumers * kConsumerRegs + (kThreads - kConsumers) * kProducerRegs) {
      return cudaErrorInvalidConfiguration;
    }
    ready.fetch_or(bit, std::memory_order_release);
  }
  const int64_t n_ctas = static_cast<int64_t>(p.n_mt) * p.n_seg;
  if (n_ctas > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_ctas), kThreads, R::kSmem, stream>>>(
      tm_a, tm_b, p);
  return cudaGetLastError();
}

bool fits_int(int64_t v) { return v >= 0 && v <= 0x7fffffff; }

// f32 (rows x cols, row stride ld) -> three bf16 pieces; transposed:
// dst[p][c][r] for r < dst_ld (zeros past rows), else dst[p][r][c] for
// c < dst_ld (zeros past cols)
__global__ void split_transpose_kernel(const float* __restrict__ src,
                                       int rows, int cols, int64_t ld,
                                       uint16_t* __restrict__ dst,
                                       int64_t dst_ld, int64_t piece) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (r < rows && c < cols) ? src[static_cast<int64_t>(r) * ld + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < dst_ld) {
      uint16_t h, m, l;
      split3(tile[threadIdx.x][i], h, m, l);
      const int64_t o = static_cast<int64_t>(c) * dst_ld + r;
      dst[o] = h;
      dst[o + piece] = m;
      dst[o + 2 * piece] = l;
    }
  }
}

__global__ void split_rows_kernel(const float* __restrict__ src, int rows,
                                  int cols, int64_t ld,
                                  uint16_t* __restrict__ dst, int64_t dst_ld,
                                  int64_t piece) {
  const int64_t n = static_cast<int64_t>(rows) * dst_ld;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / dst_ld, c = i % dst_ld;
    uint16_t h, m, l;
    split3(c < cols ? src[r * ld + c] : 0.f, h, m, l);
    dst[i] = h;
    dst[i + piece] = m;
    dst[i + 2 * piece] = l;
  }
}

}  // namespace

extern "C" {

int repro_lm_head_split(const float* src, int64_t rows, int64_t cols,
                        int64_t ld, void* dst, int64_t dst_ld, int64_t piece,
                        int transpose, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (!fits_int(rows) || !fits_int(cols) || !fits_int(dst_ld)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint16_t* out = static_cast<uint16_t*>(dst);
  if (transpose) {
    const dim3 grid(static_cast<unsigned>((cols + 31) / 32),
                    static_cast<unsigned>((dst_ld + 31) / 32));
    split_transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(
        src, static_cast<int>(rows), static_cast<int>(cols), ld, out, dst_ld,
        piece);
  } else {
    const int64_t n = rows * dst_ld;
    const int64_t blocks = (n + 255) / 256 < 65536 ? (n + 255) / 256 : 65536;
    split_rows_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        src, static_cast<int>(rows), static_cast<int>(cols), ld, out, dst_ld,
        piece);
  }
  return static_cast<int>(cudaGetLastError());
}

// forward: x as na (1: bf16 x; 3: its split) pieces of (rows x k_len, row
// stride x_ld), w's pieces transposed (3 x V_l x k_len, row stride w_ld);
// the vocab cut into n_seg segments, writes (n_seg, rows) of m, s and ll
int repro_lm_head_xent_fwd(const void* x, int na, int64_t rows, int64_t x_ld,
                           int64_t x_piece, const void* wt, int64_t v_l,
                           int64_t w_ld, int64_t w_piece, int64_t k_len,
                           const int* lab, int64_t n_keep, int64_t n_seg,
                           float* out_m, float* out_s, float* out_ll,
                           void* stream) {
  if (!fits_int(rows) || !fits_int(v_l) || !fits_int(k_len) ||
      !fits_int(n_seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.m_len = static_cast<int>(rows);
  p.n_len = static_cast<int>(v_l);
  p.k_len = static_cast<int>(k_len);
  p.n_seg = static_cast<int>(n_seg);
  p.lab = lab;
  p.n_keep = static_cast<int>(n_keep);
  p.out_m = out_m;
  p.out_s = out_s;
  p.out_ll = out_ll;
  const Operand a{x, k_len, rows, na, x_ld, x_piece};
  const Operand b{wt, k_len, v_l, 3, w_ld, w_piece};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (na == 1) {
    err = launch<1, 3, 2, false, false, kStats>(a, b, p, st);
  } else if (na == 3) {
    err = launch<3, 3, 2, false, false, kStats>(a, b, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dS of rows x V_l (this chunk's rows; lab, m, ca and cb start at its first
// row) into three bf16 pieces (rows x ds_ld, zeros past V_l), the ds_ld
// columns cut into n_seg segments
int repro_lm_head_xent_dlogits(const void* x, int na, int64_t rows,
                               int64_t x_ld, int64_t x_piece, const void* wt,
                               int64_t v_l, int64_t w_ld, int64_t w_piece,
                               int64_t k_len, const int* lab, int64_t n_keep,
                               const float* m, const float* ca,
                               const float* cb, void* ds, int64_t ds_ld,
                               int64_t ds_piece, int64_t n_seg,
                               void* stream) {
  if (!fits_int(rows) || !fits_int(v_l) || !fits_int(k_len) ||
      !fits_int(ds_ld) || ds_ld < v_l || (ds_ld & 7) || !fits_int(n_seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.m_len = static_cast<int>(rows);
  p.n_len = static_cast<int>(ds_ld);   // the tiles cover the zero padding
  p.k_len = static_cast<int>(k_len);
  p.n_seg = static_cast<int>(n_seg);
  p.lab = lab;
  p.n_keep = static_cast<int>(n_keep < v_l ? n_keep : v_l);
  p.m_l = m;
  p.ca = ca;
  p.cb = cb;
  p.ds = static_cast<uint16_t*>(ds);
  p.ds_ld = ds_ld;
  p.ds_piece = ds_piece;
  const Operand a{x, k_len, rows, na, x_ld, x_piece};
  const Operand b{wt, k_len, v_l, 3, w_ld, w_piece};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (na == 1) {
    err = launch<1, 3, 2, false, false, kDlogits>(a, b, p, st);
  } else if (na == 3) {
    err = launch<3, 3, 2, false, false, kDlogits>(a, b, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dX (rows x d, row stride dx_ld) = dS (rows x V_l) w^T: terms 3 (bf16 x:
// dS_hi w_hi + dS_hi w_mid + dS_mid w_hi) or 6; d cut into n_seg segments
int repro_lm_head_xent_dx(const void* ds, int64_t rows, int64_t v_l,
                          int64_t ds_ld, int64_t ds_piece, const void* wt,
                          int64_t d, int64_t w_ld, int64_t w_piece,
                          float* dx, int64_t dx_ld, int terms, int64_t n_seg,
                          void* stream) {
  if (!fits_int(rows) || !fits_int(v_l) || !fits_int(d) ||
      !fits_int(n_seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.m_len = static_cast<int>(rows);
  p.n_len = static_cast<int>(d);
  p.k_len = static_cast<int>(v_l);
  p.n_seg = static_cast<int>(n_seg);
  p.out = dx;
  p.out_ld = dx_ld;
  const Operand a{ds, v_l, rows, 3, ds_ld, ds_piece};
  const Operand b{wt, d, v_l, 3, w_ld, w_piece};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (terms == 3) {
    err = launch<2, 2, 1, false, true, kStore>(a, b, p, st);
  } else if (terms == 6) {
    err = launch<3, 3, 2, false, true, kStore>(a, b, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// dW (d x V_l, row stride dw_ld) (+)= x^T dS over this chunk's rows: x as
// na pieces (rows x d, row stride x_ld), dS's three pieces; V_l cut into
// n_seg segments
int repro_lm_head_xent_dw(const void* x, int na, int64_t rows, int64_t d,
                          int64_t x_ld, int64_t x_piece, const void* ds,
                          int64_t v_l, int64_t ds_ld, int64_t ds_piece,
                          float* dw, int64_t dw_ld, int accumulate,
                          int64_t n_seg, void* stream) {
  if (!fits_int(rows) || !fits_int(v_l) || !fits_int(d) ||
      !fits_int(n_seg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.m_len = static_cast<int>(d);
  p.n_len = static_cast<int>(v_l);
  p.k_len = static_cast<int>(rows);
  p.n_seg = static_cast<int>(n_seg);
  p.out = dw;
  p.out_ld = dw_ld;
  p.accumulate = accumulate;
  const Operand a{x, d, rows, na, x_ld, x_piece};
  const Operand b{ds, v_l, rows, 3, ds_ld, ds_piece};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (na == 1) {
    err = launch<1, 3, 2, true, true, kStore>(a, b, p, st);
  } else if (na == 3) {
    err = launch<3, 3, 2, true, true, kStore>(a, b, p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"

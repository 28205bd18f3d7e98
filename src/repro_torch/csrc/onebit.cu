// Error-feedback 1-bit compression for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/onebit/kernel.py:
//   ef_compress_fused (body _ef_compress_kernel) -> repro_ef_compress
//   decompress        (body _decompress_kernel)  -> repro_decompress
//
// What bounds it: device-memory bytes. ef_compress reads x and err and
// writes new_err (12 bytes per element) plus the wire payload (1/8 byte per
// element and 4 bytes per scale block); decompress reads the payload and
// writes 4 bytes per element. Both do a handful of operations per element,
// far below the card's arithmetic rate, so the design goal is one pass over
// device memory with coalesced accesses.
//
// Design:
//   * ef_compress runs one CTA per scale block. The first loop sums |x+err|
//     (warp shuffle, then shared memory), the block mean is the sum divided
//     by block_size. The second loop recomputes buf = x+err (the block's
//     x/err lines are still in L2, so device memory is read once), packs the
//     sign bits with one __ballot_sync per 32 elements and writes new_err.
//     Lane l of a warp holds element 32w+l, so byte k of the ballot mask is
//     exactly packed byte 4w+k of the block: bit j of byte i is
//     buf[8i+j] >= 0 (LSB first). -0.0 packs 1 and NaN packs 0, as in the
//     reference. The block size is any multiple of 8, so a block's first
//     packed byte need not be 4-byte aligned and its last ballot may run
//     past the block: lanes 0-3 each store one byte of the mask (one
//     coalesced 4-byte store instruction per warp), and only the bytes that
//     lie inside the block.
//   * decompress: see the note above decompress_kernel.
//   * Kernels launch on the caller's stream, allocate nothing and never
//     synchronise; each entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ef_compress_kernel(const float* __restrict__ x, const float* __restrict__ err,
                   uint8_t* __restrict__ packed, float* __restrict__ scales,
                   float* __restrict__ new_err, int64_t block_size) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block_size;
  const float* xb = x + base;
  const float* eb = err + base;
  float* nb = new_err + base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;

  // block sum of |x + err|
  float s = 0.f;
  for (int64_t i = threadIdx.x; i < block_size; i += kThreads) {
    s += fabsf(xb[i] + eb[i]);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  __shared__ float partial[kWarps];
  __shared__ float scale_sh;
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_down_sync(0xffffffffu, t, off);
    }
    if (lane == 0) {
      const float scale = t / static_cast<float>(block_size);
      scale_sh = scale;
      scales[blockIdx.x] = scale;
    }
  }
  __syncthreads();
  const float scale = scale_sh;

  // sign bitmap (one ballot per 32 elements) and the exact EF residual
  // w0 is uniform across the warp, so every lane reaches the ballot
  uint8_t* pb = packed + base / 8;
  for (int64_t w0 = static_cast<int64_t>(warp) * 32; w0 < block_size;
       w0 += kThreads) {
    const int64_t i = w0 + lane;
    const bool in_block = i < block_size;
    const float buf = in_block ? xb[i] + eb[i] : 0.f;
    const bool pos = in_block && buf >= 0.f;
    const uint32_t mask = __ballot_sync(0xffffffffu, pos);
    if (lane < 4 && w0 + 8 * lane < block_size) {
      pb[w0 / 8 + lane] = static_cast<uint8_t>(mask >> (8 * lane));
    }
    if (in_block) nb[i] = buf - (pos ? scale : -scale);
  }
}

// decompress_kernel replaces _decompress_kernel
// (src/repro/kernels/onebit/kernel.py:95, decompress).
//
// What bounds it: device-memory bytes. It reads 1/8 byte and writes 4
// bytes per element (plus one scale per block): 1.46 GB of stores at the
// main path's d_pad = 364,564,480, a 0.449 ms floor at 3.35 TB/s. The
// stores are all that matters.
//
// What the design does about it: every warp store instruction writes 512
// contiguous bytes. A warp takes chunks of 1024 elements (128 packed
// bytes): lane l loads packed word l of the chunk (one coalesced 4-byte
// load), then in 8 rounds r writes float4 32r + l of the chunk (elements
// 128r + 4l .. + 3, nibble l % 8 of word 4r + l / 8, which it takes from
// lane 4r + l / 8 with __shfl_sync). Each lane has 8 independent
// streaming stores (__stcs: the output does not fit in L2) in flight per
// load; loading 2 or 4 chunks ahead measured no faster. A float4 never
// straddles a scale block (block % 8 == 0), so one scale serves all four
// values; the block index comes from the chunk's first element and two
// compares (a division only for blocks under 1024 elements). The value is
// bit ? s : -s, bitwise the reference's signs * scale. An unaligned
// payload (aligned4 == 0) and the ragged last chunk load byte by byte.
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t n_bytes, int64_t block_size, int aligned4) {
  constexpr int kChunkBytes = 128;                 // 32 lanes x 4 bytes
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t n_chunks = (n_bytes + kChunkBytes - 1) / kChunkBytes;
  const int64_t d = n_bytes * 8;
  for (int64_t c = (static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x) / 32;
       c < n_chunks; c += n_warps) {
    const int64_t b0 = c * kChunkBytes + 4 * lane;
    uint32_t word = 0;
    if (aligned4 && b0 + 4 <= n_bytes) {
      word = __ldcs(reinterpret_cast<const unsigned int*>(packed + b0));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (b0 + k < n_bytes) {
          word |= static_cast<uint32_t>(packed[b0 + k]) << (8 * k);
        }
      }
    }
    const int64_t e0 = c * kChunkBytes * 8;        // the chunk's first element
    const int64_t blk0 = e0 / block_size;
    const int64_t rem0 = e0 - blk0 * block_size;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t w = __shfl_sync(0xffffffffu, word, 4 * r + lane / 8);
      const uint32_t nib = (w >> (4 * (lane % 8))) & 0xFu;
      const int64_t o = 128 * r + 4 * lane;
      if (e0 + o < d) {
        const int64_t t = rem0 + o;
        const int64_t blk = t < block_size ? 0
                            : t < 2 * block_size ? 1 : t / block_size;
        const float s = __ldg(scales + blk0 + blk);
        __stcs(reinterpret_cast<float4*>(out + e0 + o),
               make_float4((nib & 1u) ? s : -s, (nib & 2u) ? s : -s,
                           (nib & 4u) ? s : -s, (nib & 8u) ? s : -s));
      }
    }
  }
}

int grid_for(int64_t work) {
  // enough CTAs to fill 132 SMs several times over; the loop strides the rest
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1)
                                            : 132 * 16);
}

}  // namespace

extern "C" {

// x, err, new_err: (d,) f32; packed: (d/8,) u8; scales: (d/block_size,)
// f32. d % block_size == 0, block_size % 8 == 0.
int repro_ef_compress(const void* x, const void* err, void* packed,
                      void* scales, void* new_err, int64_t d,
                      int64_t block_size, void* stream) {
  const int64_t n_blocks = d / block_size;
  if (n_blocks > 0) {
    ef_compress_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(err),
        static_cast<uint8_t*>(packed), static_cast<float*>(scales),
        static_cast<float*>(new_err), block_size);
  }
  return static_cast<int>(cudaGetLastError());
}

// packed: (d/8,) u8; scales: (d/block_size,) f32; out: (d,) f32, 16-byte
// aligned. d % block_size == 0, block_size % 8 == 0.
int repro_decompress(const void* packed, const void* scales, void* out,
                     int64_t d, int64_t block_size, void* stream) {
  const int64_t n_bytes = d / 8;
  if (n_bytes > 0) {
    // one warp per 128 packed bytes
    decompress_kernel<<<grid_for((n_bytes + 3) / 4), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
        static_cast<float*>(out), n_bytes, block_size,
        reinterpret_cast<uintptr_t>(packed) % 4 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

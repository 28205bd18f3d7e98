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
//   * decompress gives each thread one packed byte and writes its 8 floats
//     as two float4 stores; the value is bit ? s : -s, which is bitwise the
//     reference's signs * scale.
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

__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t n_bytes, int64_t block_size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n_bytes; j += stride) {
    const uint32_t byte = packed[j];
    const float s = scales[(j * 8) / block_size];
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = ((byte >> k) & 1u) ? s : -s;
    float4* o = reinterpret_cast<float4*>(out + j * 8);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
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
    decompress_kernel<<<grid_for(n_bytes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const float*>(scales),
        static_cast<float*>(out), n_bytes, block_size);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

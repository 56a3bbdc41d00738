// Forward NTT over BabyBear (p = 2^31 - 2^27 + 1) for Hopper.
//
// Replaces: the TPU's Pallas level kernel
//   toyni_tpu/ops/ntt_mxu.py::_level_kernel_i8, called through _dft_level
//   (and _apply_rec / apply_mxu_ntt), which runs each four-step DFT level as
//   int8 digit matmuls because the TPU has no 64-bit multiply. Hopper has
//   native 32x32->64 products and __umul64hi, so this kernel is a plain
//   radix-2 decimation-in-time transform with Barrett reduction
//   (mu = floor(2^64 / p)).
//
// Contract (that of toyni_tpu/ops/ntt.py::apply_ntt / ntt_batched): rows of
// a (B, n) array of u32 values < p, n = 2^k with 1 <= k <= 27, natural
// order in and natural order out. Twiddles come in standard form, packed by
// stage: stage s (span 2^s) reads omega_{2^s}^j at tw[2^(s-1) - 1 + j].
//
// Design: one block per tile of T = min(n, 2048) elements gathers its
// inputs in bit-reversed order and runs stages 1..log T in shared memory;
// each later stage is one pass over device memory, one thread per
// butterfly. Bound on this card: memory. Every pass reads and writes each
// 4-byte element once, against 3.35 TB/s, so a size-2^k transform costs
// (k - 10) passes over the array plus the gather pass. Fusing more stages
// per pass (radix-4/8 in registers, or the four-step digit matmul on the
// int8 tensor cores) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t P = 2013265921u;
constexpr uint64_t MU = 0x22222221dull;  // floor(2^64 / p)
constexpr int LOG_TILE = 11;             // 2048 elements per shared tile

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2^32 for a, b < p
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (P - b);
}

// Barrett: q = hi64(x * mu) is floor(x / p) or one less, so r < 2p.
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b) {
  uint64_t x = (uint64_t)a * b;
  uint64_t q = __umul64hi(x, MU);
  uint64_t r = x - q * P;
  return (uint32_t)(r >= P ? r - P : r);
}

// Bit-reversal gather plus stages 1..log_t, one block per tile.
__global__ void ntt_tile_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw,
                                int log_n, int log_t) {
  extern __shared__ uint32_t sh[];
  const uint32_t t_sz = 1u << log_t;
  const uint64_t tile = blockIdx.x;
  const int tiles_log = log_n - log_t;
  const uint64_t row = tile >> tiles_log;
  const uint32_t base =
      (uint32_t)(tile & ((1ull << tiles_log) - 1)) << log_t;
  const uint32_t* src = in + (row << log_n);
  const int rshift = 32 - log_n;
  for (uint32_t p = threadIdx.x; p < t_sz; p += blockDim.x) {
    sh[p] = src[__brev(base + p) >> rshift];
  }
  __syncthreads();
  for (int s = 1; s <= log_t; ++s) {
    const uint32_t half = 1u << (s - 1);
    for (uint32_t k = threadIdx.x; k < t_sz / 2; k += blockDim.x) {
      const uint32_t j = k & (half - 1);
      const uint32_t i0 = ((k >> (s - 1)) << s) + j;
      const uint32_t i1 = i0 + half;
      const uint32_t u = sh[i0];
      const uint32_t v = mul_mod(sh[i1], tw[half - 1 + j]);
      sh[i0] = add_mod(u, v);
      sh[i1] = sub_mod(u, v);
    }
    __syncthreads();
  }
  uint32_t* dst = out + (row << log_n) + base;
  for (uint32_t p = threadIdx.x; p < t_sz; p += blockDim.x) {
    dst[p] = sh[p];
  }
}

// One radix-2 stage s over device memory, in place, one thread per butterfly.
__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw,
                                 int log_n, int s, uint64_t butterflies) {
  const uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= butterflies) return;
  const uint64_t row = t >> (log_n - 1);
  const uint32_t k = (uint32_t)(t & ((1ull << (log_n - 1)) - 1));
  const uint32_t half = 1u << (s - 1);
  const uint32_t j = k & (half - 1);
  const uint64_t i0 = (row << log_n) + (((uint64_t)(k >> (s - 1))) << s) + j;
  const uint64_t i1 = i0 + half;
  const uint32_t u = x[i0];
  const uint32_t v = mul_mod(x[i1], tw[half - 1 + j]);
  x[i0] = add_mod(u, v);
  x[i1] = sub_mod(u, v);
}

}  // namespace

// in, out: (rows, 2^log_n) u32, distinct buffers; tw: packed (2^log_n - 1).
extern "C" int toyni_ntt_forward(const void* in, void* out, const void* tw,
                                 long long rows, int log_n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const uint32_t* t = static_cast<const uint32_t*>(tw);
  const int log_t = log_n < LOG_TILE ? log_n : LOG_TILE;
  const unsigned long long tiles = (unsigned long long)rows << (log_n - log_t);
  const int threads = 1 << (log_t - 1);
  ntt_tile_kernel<<<(unsigned)tiles, threads, (1u << log_t) * sizeof(uint32_t),
                    st>>>(src, dst, t, log_n, log_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bf = (unsigned long long)rows << (log_n - 1);
  const int block = 256;
  const unsigned blocks = (unsigned)((bf + block - 1) / block);
  for (int s = log_t + 1; s <= log_n; ++s) {
    ntt_stage_kernel<<<blocks, block, 0, st>>>(dst, t, log_n, s, bf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

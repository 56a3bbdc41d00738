// Batched SHA-256 of the protocol's three fixed message shapes, for Hopper.
//
// Replaces: toyni_tpu/ops/sha256.py::hash_salted_leaves, hash_unsalted_leaves
//   and hash_nodes, which XLA lowers on the TPU (the TPU's Pallas SHA-256 was
//   retired, toyni_tpu/merkle.py DeviceTree note). The tree's level loop
//   (merkle.py::_device_levels) calls `nodes` once per level.
//
// Messages, composed word by word as in ops/sha256.py:
//   salted leaf    0x00 || salt16 || value8LE   25 bytes, one block
//   unsalted leaf  0x00 || value8LE              9 bytes, one block
//   inner node     0x01 || left32 || right32    65 bytes, two blocks
// Salt words and digests are big-endian u32 words; a value's high 4 bytes
// are zero.
//
// Design: one thread per message, the 64 rounds unrolled with the message
// schedule in a 16-word register window. Bound on this card: integer
// throughput, not memory. A leaf reads 20 bytes and writes 32 for ~2,000
// 32-bit operations, a node reads 64 and writes 32 for twice that, so the
// serial round chain of each lane is the cost and every lane runs
// independently. Digests move as two 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void init_state(uint32_t st[8]) {
  st[0] = 0x6a09e667; st[1] = 0xbb67ae85; st[2] = 0x3c6ef372;
  st[3] = 0xa54ff53a; st[4] = 0x510e527f; st[5] = 0x9b05688c;
  st[6] = 0x1f83d9ab; st[7] = 0x5be0cd19;
}

// One compression of the 16-word block w (consumed) into st.
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__device__ __forceinline__ void store_digest(uint32_t* out, uint64_t i,
                                             const uint32_t st[8]) {
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(st[0], st[1], st[2], st[3]);
  o[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// Bytes 0..2 of a value's little-endian form, as bytes 1..3 of a BE word.
__device__ __forceinline__ uint32_t le_bytes_012(uint32_t v) {
  return ((v & 0xFF) << 16) | (((v >> 8) & 0xFF) << 8) | ((v >> 16) & 0xFF);
}

__global__ void salted_leaves_kernel(const uint32_t* __restrict__ values,
                                     const uint4* __restrict__ salts,
                                     uint32_t* __restrict__ out, uint64_t n) {
  const uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = values[i];
  const uint4 s = salts[i];
  uint32_t w[16];
  w[0] = s.x >> 8;  // 0x00 tag, then salt bytes
  w[1] = (s.x << 24) | (s.y >> 8);
  w[2] = (s.y << 24) | (s.z >> 8);
  w[3] = (s.z << 24) | (s.w >> 8);
  w[4] = (s.w << 24) | le_bytes_012(v);
  w[5] = (v >> 24) << 24;
  w[6] = 0x00800000;
#pragma unroll
  for (int k = 7; k < 15; ++k) w[k] = 0;
  w[15] = 200;  // 25-byte message
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  store_digest(out, i, st);
}

__global__ void unsalted_leaves_kernel(const uint32_t* __restrict__ values,
                                       uint32_t* __restrict__ out, uint64_t n) {
  const uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t v = values[i];
  uint32_t w[16];
  w[0] = le_bytes_012(v);  // 0x00 tag, then value bytes 0..2
  w[1] = (v >> 24) << 24;
  w[2] = 0x00800000;
#pragma unroll
  for (int k = 3; k < 15; ++k) w[k] = 0;
  w[15] = 72;  // 9-byte message
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  store_digest(out, i, st);
}

__global__ void nodes_kernel(const uint4* __restrict__ left,
                             const uint4* __restrict__ right,
                             uint32_t* __restrict__ out, uint64_t m) {
  const uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint4 l0 = left[2 * i], l1 = left[2 * i + 1];
  const uint4 r0 = right[2 * i], r1 = right[2 * i + 1];
  const uint32_t l[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
  const uint32_t r[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  uint32_t w[16];
  w[0] = (l[0] >> 8) | 0x01000000u;  // 0x01 tag
#pragma unroll
  for (int k = 1; k < 8; ++k) w[k] = (l[k - 1] << 24) | (l[k] >> 8);
  w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
  for (int k = 1; k < 8; ++k) w[8 + k] = (r[k - 1] << 24) | (r[k] >> 8);
  uint32_t st[8];
  init_state(st);
  compress(st, w);
  w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
  for (int k = 1; k < 15; ++k) w[k] = 0;
  w[15] = 520;  // 65-byte message
  compress(st, w);
  store_digest(out, i, st);
}

constexpr int BLOCK = 128;

inline unsigned grid_for(long long n) {
  return (unsigned)((n + BLOCK - 1) / BLOCK);
}

}  // namespace

// values: (n,) u32; salts: (n, 4) u32; out: (n, 8) u32.
extern "C" int toyni_sha256_salted_leaves(const void* values, const void* salts,
                                          void* out, long long n, void* stream) {
  if (n > 0) {
    salted_leaves_kernel<<<grid_for(n), BLOCK, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(values), static_cast<const uint4*>(salts),
        static_cast<uint32_t*>(out), (uint64_t)n);
  }
  return (int)cudaGetLastError();
}

// values: (n,) u32; out: (n, 8) u32.
extern "C" int toyni_sha256_unsalted_leaves(const void* values, void* out,
                                            long long n, void* stream) {
  if (n > 0) {
    unsalted_leaves_kernel<<<grid_for(n), BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(values), static_cast<uint32_t*>(out),
        (uint64_t)n);
  }
  return (int)cudaGetLastError();
}

// left, right, out: (m, 8) u32.
extern "C" int toyni_sha256_nodes(const void* left, const void* right,
                                  void* out, long long m, void* stream) {
  if (m > 0) {
    nodes_kernel<<<grid_for(m), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(left), static_cast<const uint4*>(right),
        static_cast<uint32_t*>(out), (uint64_t)m);
  }
  return (int)cudaGetLastError();
}

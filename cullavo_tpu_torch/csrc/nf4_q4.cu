// Byte-packed NF4 weights: the dequant-once pass in front of a dense matmul
// for large M (K11's dequant entry).  The fused dequant-matmul for small M
// (K11) is csrc/nf4_gemv_sm90.cu.
//
// Replaces: the dequant half of XLA's dequant + dot that cullavo_tpu/ops/nf4.py
// leaves the q4 product to at prefill M.  The weight [K, N] is stored as
// bytes q4 [K, N/2]: byte (k, j) holds the NF4 code of element (k, 2j) in its
// high nibble and of (k, 2j + 1) in its low nibble (the flat row-major
// packing of quantize_linear / quantize_nf4 viewed 2-D), with one f32 absmax
// per (row k, 64-column block): scale [K, N/64].
//
//   dequant:  w[k, n] = bf16(code_f32[k, n] * scale[k, n/64])        (bit-exact)
//
// Bound on the H100: bytes.  It reads 0.5625 and writes 2 bytes per weight.
//
// Design.  One thread takes 8 bytes (16 columns of one row, inside one scale
// block) and writes 16 bf16 (32 bytes): every store is coalesced along N.
//
// Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;             // columns per absmax block

// the NF4 codebook (bitsandbytes), f32
__constant__ float kCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void nf4_q4_dequant_kernel(const uint8_t* __restrict__ q4,
                                      const float* __restrict__ scale,
                                      __nv_bfloat16* __restrict__ out, int K, int N) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const int n16 = N / 16;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * n16) return;
  const long long k = idx / n16;
  const int c = static_cast<int>(idx % n16) * 16;
  const uint2 w = *reinterpret_cast<const uint2*>(q4 + k * (N / 2) + c / 2);
  const float s = scale[k * (N / QB) + c / QB];
  const uint32_t wv[2] = {w.x, w.y};
  uint32_t o[8];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t byte = (wv[p] >> (8 * b)) & 0xFF;
      o[p * 4 + b] = pack_bf16(__fmul_rn(lut[byte >> 4], s), __fmul_rn(lut[byte & 15], s));
    }
  uint4* dst = reinterpret_cast<uint4*>(out + k * N + c);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

}  // namespace

// q4 uint8 [K, N/2]; scale f32 [K, N/64]; out bf16 [K, N].  N % 64 == 0.
extern "C" int cullavo_nf4_dequant_q4(const void* q4, const void* scale, void* out, int K, int N,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tasks = static_cast<long long>(K) * (N / 16);
  const int threads = 256;
  nf4_q4_dequant_kernel<<<static_cast<unsigned>((tasks + threads - 1) / threads), threads, 0,
                          st>>>(static_cast<const uint8_t*>(q4),
                                static_cast<const float*>(scale),
                                static_cast<__nv_bfloat16*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

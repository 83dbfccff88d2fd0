// Per-row activation quantizer for the s8s8 prefill GEMMs (kernel K2).
//
// Replaces: cullavo_tpu/ops/nf4.py, quantize_rows_pallas -> _quant_rows_kernel.
// Computes, for each row r of x [M, K] (bf16) and an optional f32 multiplier
// mult [K] (the SmoothQuant sq_inv):
//     v      = f32(x[r, k]) * mult[k]
//     a      = max_k |v|
//     inv    = 127 / max(a, 1e-12)          (IEEE division)
//     sx[r]  = 1 / inv                      (IEEE division)
//     xi[r,k]= clip(rint(v * inv), -127, 127)   (round half to even)
// bit-identical to the JAX chain (nf4._quant_inv_scale): constant numerators
// only, a single rounding point, no FMA contraction (explicit __fmul_rn /
// __fdiv_rn), and this file is built without --use_fast_math.
//
// Bound on the H100: memory.  3 bytes move per element (2 in, 1 out), about
// 110 MB per [9072, 4096] pass, ~33 us at 3.35 TB/s.  Design: one block per
// row; the first pass reads the row with 16-byte loads, keeps it in shared
// memory (22 KB at K = 11008) and reduces the absmax; the second pass reads
// the row back from shared memory, so device memory is read once.
// Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ mult,
                  int8_t* __restrict__ xi, float* __restrict__ sx, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* row = reinterpret_cast<uint4*>(smem);
  __shared__ float warp_max[kThreads / 32];
  __shared__ float inv_shared;

  const long long r = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * K);
  const int nvec = K / 8;  // K % 8 == 0 (checked by the wrapper)

  float a = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = xr[i];
    row[i] = v;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(e[j]);
      if (mult != nullptr) f = __fmul_rn(f, mult[i * 8 + j]);
      a = fmaxf(a, fabsf(f));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    const float inv = __fdiv_rn(127.0f, fmaxf(m, 1e-12f));
    inv_shared = inv;
    sx[r] = __fdiv_rn(1.0f, inv);
  }
  __syncthreads();
  const float inv = inv_shared;

  uint2* out = reinterpret_cast<uint2*>(xi + r * K);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = row[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(e[j]);
      if (mult != nullptr) f = __fmul_rn(f, mult[i * 8 + j]);
      float q = rintf(__fmul_rn(f, inv));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      const uint32_t byte = static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
      packed[j >> 2] |= byte << (8 * (j & 3));
    }
    out[i] = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace

extern "C" int cullavo_quant_rows(const void* x, const void* mult, void* xi,
                                  void* sx, int M, int K, void* stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(__nv_bfloat16);
  quant_rows_kernel<<<M, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mult),
      static_cast<int8_t*>(xi), static_cast<float*>(sx), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cullavo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

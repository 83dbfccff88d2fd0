// Planar NF4 weights: the dequant-once pass in front of a dense matmul for
// large M (kernel K7).  The fused dequant-matmul for small M (K6) is
// csrc/nf4_gemv_sm90.cu.
//
// Replaces: cullavo_tpu/ops/nf4.py, nf4_dequant_planar_pallas ->
// _nf4_dequant_kernel (K7).  The weight [K, N] is stored as int32 words
// [K/8, N]: bits 4i..4i+3 of word[k8, n] are the NF4 code of element
// (i * K/8 + k8, n), with one f32 absmax scale per (row k, 64-column block):
// scale [K, N/64].
//
//   K7:  w[k, n] = bf16(code_f32[k, n] * scale[k, n/64])        (bit-exact)
//
// Bound on the H100: bytes.  K7 reads 0.5625 and writes 2 bytes per weight.
//
// K7 design.  One thread takes 8 adjacent words of a k8 row (32 bytes) and
// writes, for each of the 8 planes, 8 bf16 (16 bytes) of output row
// i * K/8 + k8: every store is coalesced along N.
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

__global__ void nf4_dequant_kernel(const int32_t* __restrict__ words,
                                   const float* __restrict__ scale,
                                   __nv_bfloat16* __restrict__ out, int K8, int N) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const int n8 = N / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K8) * n8) return;
  const int k8 = static_cast<int>(idx / n8);
  const int c = static_cast<int>(idx % n8) * 8;
  const int4* src = reinterpret_cast<const int4*>(words + static_cast<long long>(k8) * N + c);
  const int4 w0 = src[0], w1 = src[1];
  const int w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int NB = N / QB, cb = c / QB;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long k = static_cast<long long>(i) * K8 + k8;
    const float s = scale[k * NB + cb];
    uint32_t o[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      o[p] = pack_bf16(__fmul_rn(lut[(w[2 * p] >> (4 * i)) & 15], s),
                       __fmul_rn(lut[(w[2 * p + 1] >> (4 * i)) & 15], s));
    *reinterpret_cast<uint4*>(out + k * N + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// words int32 [K/8, N]; scale f32 [K, N/64]; out bf16 [K, N]
extern "C" int cullavo_nf4_dequant_planar(const void* words, const void* scale, void* out,
                                          int K, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K8 = K / 8;
  const long long tasks = static_cast<long long>(K8) * (N / 8);
  const int threads = 256;
  nf4_dequant_kernel<<<static_cast<unsigned>((tasks + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), K8, N);
  return static_cast<int>(cudaGetLastError());
}

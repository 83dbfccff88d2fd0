// K14: the decode-shaped product over int8 weights packed four to an int32
// word, the p32 variant of the matmul probe.
//
// Replaces: scripts/matmul_probe.py, p32_pallas -> p32_kernel (Pallas row
// 16):
//     out[m, n] = bf16( scale[n] * sum_j sum_k x[m, j*K/4 + k] * W_j[k, n] )
// where byte j of the int32 word w[k, n] is the int8 weight W[j*K/4 + k, n]
// (sign restored as (b ^ 0x80) - 0x80), x bf16 [M, K], scale f32 [N], out
// bf16 [M, N], products in f32 (a bf16 times an int8 is exact in f32) and
// f32 sums.
//
// Bound on the H100: the weight read, K*N bytes (45.1 MB at K = 4096,
// N = 11008: 0.0135 ms at 3.35 TB/s); x is 64 KB at M = 8.  Design: one
// block of 256 threads per 64 output columns and up to 8 rows of x.  The
// block first stages its rows of x in dynamic shared memory, transposed to
// [K][8] so that the eight rows of one k are one 16-byte load (64 KB at
// K = 4096: above the 48 KB static limit, hence the attribute).  Then 16
// slices of 16 threads walk the K/4 word rows (slice s takes rows s, s + 16,
// ...), each thread reading four neighbouring words with one 16-byte load,
// so every word is read once and its four bytes are applied to the four
// K-quarters of x held in shared memory.  The 16 slices' partial sums are
// added in shared memory in a fixed order (deterministic), scaled per
// column and rounded to bf16 once.  M above 8 takes more blocks along y,
// each reading the weight again (from L2 where it fits).  CUDA cores, no
// tensor cores and no load pipeline yet.  Launches on the caller's stream
// and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MC = 8;              // rows of x per block
constexpr int BN = 64;             // output columns per block
constexpr int CPT = 4;             // columns per thread (one 16-byte load)
constexpr int TPR = BN / CPT;      // threads across a block's columns
constexpr int KS = 16;             // slices along the word rows
constexpr int THREADS = TPR * KS;  // 256
constexpr int kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(THREADS)
p32_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ w,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
           int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [K][MC]
  const int m0 = blockIdx.y * MC;
  const int Kq = K / 4;

  // stage this block's rows of x, transposed; rows past M are zeros
  for (int c = threadIdx.x * 8; c < MC * K; c += THREADS * 8) {
    const int r = c / K, kk = c % K;  // K % 8 == 0: a chunk stays in one row
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + kk);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) xs[(kk + i) * MC + r] = e[i];
  }
  __syncthreads();

  const int tc = threadIdx.x % TPR, s = threadIdx.x / TPR;
  const int col = blockIdx.x * BN + tc * CPT;
  float acc[MC][CPT];
#pragma unroll
  for (int r = 0; r < MC; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  if (col < N) {
#pragma unroll 4
    for (int k = s; k < Kq; k += KS) {
      const int4 wv = __ldg(reinterpret_cast<const int4*>(w + (long long)k * N + col));
      const unsigned wd[CPT] = {static_cast<unsigned>(wv.x), static_cast<unsigned>(wv.y),
                                static_cast<unsigned>(wv.z), static_cast<unsigned>(wv.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + (j * Kq + k) * MC);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
        float xf[MC];
#pragma unroll
        for (int p = 0; p < MC / 2; ++p) {
          const float2 f = __bfloat1622float2(xp[p]);
          xf[2 * p] = f.x;
          xf[2 * p + 1] = f.y;
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          // byte j, sign restored: (b ^ 0x80) - 0x80
          const float wf = static_cast<float>(static_cast<int>(wd[c] << (24 - 8 * j)) >> 24);
#pragma unroll
          for (int r = 0; r < MC; ++r) acc[r][c] = fmaf(xf[r], wf, acc[r][c]);
        }
      }
    }
  }
  __syncthreads();  // every read of xs is done: its space takes the partial sums

  float* red = reinterpret_cast<float*>(smem);  // [KS][MC][BN]
#pragma unroll
  for (int r = 0; r < MC; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) red[(s * MC + r) * BN + tc * CPT + c] = acc[r][c];
  __syncthreads();
  for (int o = threadIdx.x; o < MC * BN; o += THREADS) {
    const int r = o / BN, cc = o % BN, n = blockIdx.x * BN + cc;
    if (m0 + r < M && n < N) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < KS; ++q) sum += red[(q * MC + r) * BN + cc];
      out[(long long)(m0 + r) * N + n] = __float2bfloat16(sum * scale[n]);
    }
  }
}

}  // namespace

// x bf16 [M, K], w int32 [K/4, N], scale f32 [N], out bf16 [M, N], all
// contiguous and 16-byte aligned; K % 8 == 0, N % 4 == 0, 8 * K * 2 bytes
// of x within the block's shared memory (K <= 14528).
extern "C" int cullavo_p32_linear(const void* x, const void* w, const void* scale, void* out,
                                  int M, int K, int N, void* stream) {
  const int smem_bytes = MC * K * 2 > KS * MC * BN * 4 ? MC * K * 2 : KS * MC * BN * 4;
  if (M < 1 || K < 8 || K % 8 || N < 4 || N % 4 || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(p32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + MC - 1) / MC);
  p32_kernel<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

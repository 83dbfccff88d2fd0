// int8 weight-only linear for small M (kernel K3): the decode-step GEMM.
//
// Replaces: cullavo_tpu/ops/nf4.py, int8_linear_pallas -> _int8_matmul_kernel
// (and what nf4.int8_linear computes at decode M):
//     out[m, n] = bf16( (sum_k xs[m, k] * q8[k, n]) * scale8[n] )
//     xs        = bf16(x * sq_inv)           (SmoothQuant undo; optional)
// with f32 accumulation and the per-column scale applied AFTER the dot, then
// one rounding to bf16.
//
// Bound on the H100: memory.  A decode step streams ~6.5 GB of int8 weights
// (32 layers x (4*4096^2 + 3*4096*11008) bytes), ~1.9 ms at 3.35 TB/s; eager
// torch would first write a bf16 copy of every weight (3x the traffic).
// Design: the weight is read once from device memory as int8 with 16-byte
// cp.async copies into a 4-stage shared-memory ring (3 tiles in flight per
// block, so enough bytes are outstanding to cover memory latency) and
// converted to f32 in registers (byte permute into a float's mantissa, no
// I2F); it never exists as bf16 in device memory.  A prologue kernel writes
// xs once as f32 rows padded to 16 into a caller-allocated workspace.  A
// block owns 128 columns x 16 activation rows; its 8 warps split each 64-row
// k tile (8 rows each) and are summed in a fixed order through shared
// memory.  K is split over blockIdx.y so that small-M shapes fill all SMs;
// per-split partial sums go to a caller-allocated f32 workspace and a last
// kernel adds them in split order (deterministic, no atomics), applies
// scale8 and rounds to bf16.  At M = 14 the FMA work per weight byte is
// ~14, so the CUDA-core FMA rate and the memory rate are about even;
// tensor cores (mma/wgmma) are the next step.  Launches on the caller's
// stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // output columns per block (32 lanes x 4)
constexpr int BK = 64;             // k rows per shared-memory tile
constexpr int MT = 16;             // activation rows per block
constexpr int WARPS = 8;           // each warp takes 8 of the tile's 64 rows
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 4;
constexpr int W_STAGE = BK * BN;                       // 8 KB of int8
constexpr int X_STAGE = MT * BK * 4;                   // 4 KB of f32
constexpr int SMEM = STAGES * (W_STAGE + X_STAGE);     // 48 KB
static_assert(WARPS * (MT / 2) * BN * 4 <= SMEM, "reduction buffer fits the ring");

// 4 int8 (one 32-bit word) -> 4 exact floats: byte b is biased to b + 128
// and placed in the mantissa of 2^23, then 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// xs[m, k] = f32(bf16(x[m, k] * sq_inv[k])) for m < M, 0 for M <= m < Mp
__global__ void int8_linear_prep(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ sq_inv,
                                 float* __restrict__ xs, int M, int Mp, int K) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(Mp) * K) return;
  const int m = static_cast<int>(idx / K), k = static_cast<int>(idx % K);
  float v = 0.f;
  if (m < M) {
    v = __bfloat162float(x[idx]);
    if (sq_inv != nullptr)  // the product rounds once to bf16, as in torch/JAX
      v = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, __bfloat162float(sq_inv[k]))));
  }
  xs[idx] = v;
}

__global__ void __launch_bounds__(THREADS, 2)
int8_linear_partial(const float* __restrict__ xs, const int8_t* __restrict__ q8,
                    float* __restrict__ partial, int M, int K, int N,
                    int tiles_per_split) {
  __shared__ __align__(16) unsigned char smem[SMEM];
  int8_t* wring = reinterpret_cast<int8_t*>(smem);                  // [STAGES][BK][BN]
  float* xring = reinterpret_cast<float*>(smem + STAGES * W_STAGE);  // [STAGES][MT][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int n_tiles = (K + BK - 1) / BK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  // one tile: BK x BN weight bytes (512 16-byte chunks, 2 per thread) and
  // MT x BK activations (256 chunks of 4 floats, 1 per thread)
  auto issue = [&](int t, int stage) {
    int8_t* wdst = wring + stage * W_STAGE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * THREADS;
      const int r = c >> 3, col = (c & 7) * 16;
      const int k = t * BK + r;
      const bool ok = k < K && n0 + col < N;
      const int8_t* src = q8 + (ok ? static_cast<long long>(k) * N + n0 + col : 0);
      cp_async16(wdst + r * BN + col, src, ok);
    }
    const int m = tid >> 4, kk = (tid & 15) * 4;
    const int k = t * BK + kk;
    const bool ok = k < K;
    const float* src = xs + (ok ? static_cast<long long>(m0 + m) * K + k : 0);
    cp_async16(xring + stage * (MT * BK) + m * BK + kk, src, ok);
  };

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end) issue(t_begin + s, s);
    cp_async_commit();
  }
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread; stage (t-1) is free
    const int nxt = t + STAGES - 1;
    if (nxt < t_end) issue(nxt, (nxt - t_begin) % STAGES);
    cp_async_commit();

    const int stage = (t - t_begin) % STAGES;
    const int8_t* ws = wring + stage * W_STAGE;
    const float* xt = xring + stage * (MT * BK);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = warp * 8 + h * 4;
      float wf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(ws + (r0 + kk) * BN + lane * 4), wf[kk]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + m * BK + r0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = acc[m][c];
          s = fmaf(xv.x, wf[0][c], s);
          s = fmaf(xv.y, wf[1][c], s);
          s = fmaf(xv.z, wf[2][c], s);
          s = fmaf(xv.w, wf[3][c], s);
          acc[m][c] = s;
        }
      }
    }
  }
  cp_async_wait<0>();

  // sum the 8 warps' partials in warp order, 8 activation rows at a time,
  // through the (now idle) ring
  float* red = reinterpret_cast<float*>(smem);   // [WARPS][MT / 2][BN]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT / 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * (MT / 2) + i) * BN + lane * 4 + c] = acc[half * (MT / 2) + i][c];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < (MT / 2) * BN / THREADS; ++j) {
      const int o = tid + j * THREADS;
      const int i = o / BN, col = o % BN;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * (MT / 2) + i) * BN + col];
      const int m = m0 + half * (MT / 2) + i, n = n0 + col;
      if (m < M && n < N) partial[(static_cast<long long>(split) * M + m) * N + n] = s;
    }
  }
}

__global__ void int8_linear_reduce(const float* __restrict__ partial,
                                   const float* __restrict__ scale8,
                                   __nv_bfloat16* __restrict__ out, int M, int N,
                                   int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(M) * N;
  if (idx >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * total + idx];
  out[idx] = __float2bfloat16_rn(__fmul_rn(s, scale8[idx % N]));
}

}  // namespace

// xs: f32 workspace of ceil(M / 16) * 16 * K floats; partial: splits * M * N
extern "C" int cullavo_int8_linear(const void* x, const void* sq_inv,
                                   const void* q8, const void* scale8,
                                   void* xs, void* partial, void* out, int M,
                                   int K, int N, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Mp = (M + MT - 1) / MT * MT;
  const int threads = 256;
  const long long n_x = static_cast<long long>(Mp) * K;
  int8_linear_prep<<<static_cast<unsigned>((n_x + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(sq_inv),
      static_cast<float*>(xs), M, Mp, K);
  const int n_tiles = (K + BK - 1) / BK;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((N + BN - 1) / BN, splits, Mp / MT);
  int8_linear_partial<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(xs), static_cast<const int8_t*>(q8),
      static_cast<float*>(partial), M, K, N, tiles_per_split);
  const long long total = static_cast<long long>(M) * N;
  int8_linear_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scale8),
      static_cast<__nv_bfloat16*>(out), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// One-token decode attention against a head-major KV cache (kernel K12).
//
// Replaces: cullavo_tpu/ops/flash_attention.py, flash_decode ->
// _decode_kernel (one new token per (b, h) against a KV-grouped cache under
// the kv_valid & s <= q_position mask), in the general form the VL zoo's
// stale-cache decode needs (cullavo_tpu/models/llava/llama.py,
// sdpa_decode_stale: an additive bias, T5's relative-position bias with
// unscaled scores).  For batch row b and head h (kv head g = h / group):
//     s[j] = scale * (q[b, h] . k[b, g, j]) + bias[b, h, j]     (f32)
//     m    = max_j s[j],  p[j] = exp(s[j] - m)  (a key at -inf counts 0)
//     l    = sum_j p[j]
//     o    = sum_j p[j] v[b, g, j] / l                          (f32)
// over the S cache keys (head dim d a multiple of 8 up to 128; f32 or bf16
// inputs); o, m and l come back in f32 so that the caller can
// fold in keys the kernel did not see (the current token of a stale-cache
// step).  A finite mask value (the Pallas kernel's -1e30, the models'
// -1e9) is an ordinary score: a row whose keys are all masked so averages
// v over the S keys, as the Pallas kernel does over its (padded) length.
// Keys past S are never read.
//
// Bound on the H100: bytes.  Each (b, g) cache row is read once per head of
// its group (once in all for the MHA zoo towers), ~4 d operations per key
// and head against 2 d bytes (bf16) or 4 d (f32) per key: far below the
// card's 295 operations per byte.  Design (simple first): one block of 128
// threads per (b, h); the keys go through shared memory in tiles of 32
// rows, loaded with 16-byte vector loads through the caches' strides (the
// stacked zoo caches are read in place for one layer) and widened to f32;
// four threads share a key's dot product; the block keeps an online softmax
// (running max, sum, and one output column per thread).  ~33 KB of shared
// memory per block at d = 128, so six blocks share an SM.  No split over S,
// no TMA or load/compute overlap inside a block yet.  Launches on the
// caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TK = 32;                 // keys per shared-memory tile
constexpr int TPK = THREADS / TK;      // threads per key in the score phase
constexpr int MAX_D = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// one 16-byte vector of T -> f32 values at dst
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = f[j];
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = __bfloat162float(e[j]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    float* __restrict__ o, float* __restrict__ m_out,
                    float* __restrict__ l_out, int H, int group, int S, int d,
                    long long q_sb, long long q_sh, long long k_sb, long long k_sg,
                    long long k_ss, long long v_sb, long long v_sg, long long v_ss,
                    long long b_sb, long long b_sh, long long b_ss, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float ks[TK * (MAX_D + 1)];   // key rows, padded stride d + 1
  __shared__ float vs[TK * MAX_D];
  __shared__ float qs[MAX_D];
  __shared__ float ps[TK];
  __shared__ float red_max[WARPS], red_sum[WARPS];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, g = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldk = d + 1;
  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + g * k_sg;
  const T* vp = v + b * v_sb + g * v_sg;
  const float* bp = bias + b * b_sb + h * b_sh;
  for (int i = tid; i < d; i += THREADS) qs[i] = to_f32(qp[i]);

  const int vec_per_row = d / VEC;
  const int chunk = d / TPK;               // elements of a key's dot per thread
  const int key = tid / TPK, part = tid % TPK;
  float m_run = -INFINITY, l_run = 0.f, acc = 0.f;   // thread tid < d owns column tid

  for (int s0 = 0; s0 < S; s0 += TK) {
    const int n = min(TK, S - s0);
    __syncthreads();                       // the previous tile's readers are done
    for (int c = tid; c < n * vec_per_row; c += THREADS) {
      const int r = c / vec_per_row, col = (c - r * vec_per_row) * VEC;
      const uint4 rk = *reinterpret_cast<const uint4*>(kp + (s0 + r) * k_ss + col);
      const uint4 rv = *reinterpret_cast<const uint4*>(vp + (s0 + r) * v_ss + col);
      float tk[VEC];
      widen(rk, tk, static_cast<const T*>(nullptr));
#pragma unroll
      for (int j = 0; j < VEC; ++j) ks[r * ldk + col + j] = tk[j];
      widen(rv, vs + r * d + col, static_cast<const T*>(nullptr));
    }
    __syncthreads();

    float dot = 0.f;
    if (key < n) {
      const float* kr = ks + key * ldk + part * chunk;
      const float* qq = qs + part * chunk;
      for (int j = 0; j < chunk; ++j) dot = fmaf(qq[j], kr[j], dot);
    }
#pragma unroll
    for (int off = 1; off < TPK; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float s = key < n ? dot * scale + bp[(s0 + key) * b_ss] : -INFINITY;

    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_max[warp] = mx;
    __syncthreads();
    float tile_max = red_max[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) tile_max = fmaxf(tile_max, red_max[w]);
    const float m_new = fmaxf(m_run, tile_max);
    // a key at -inf (or past S) counts 0; with m_new = -inf every key does
    const float p = s == -INFINITY ? 0.f : expf(s - m_new);
    if (part == 0) ps[key] = p;
    float sum = part == 0 ? p : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_sum[warp] = sum;
    __syncthreads();
    float tile_sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tile_sum += red_sum[w];
    const float alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    l_run = l_run * alpha + tile_sum;
    if (tid < d) {
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(ps[j], vs[j * d + tid], a);
      acc = acc * alpha + a;
    }
    m_run = m_new;
  }
  if (tid < d) o[static_cast<long long>(bh) * d + tid] = acc / (l_run == 0.f ? 1.f : l_run);
  if (tid == 0) {
    m_out[bh] = m_run;
    l_out[bh] = l_run;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, void* m,
           void* l, int B, int H, int KV, int S, int d, long long q_sb, long long q_sh,
           long long k_sb, long long k_sg, long long k_ss, long long v_sb, long long v_sg,
           long long v_ss, long long b_sb, long long b_sh, long long b_ss, float scale,
           void* stream) {
  const long long blocks = static_cast<long long>(B) * H;
  if (d < 8 || d > MAX_D || d % 8 || B < 1 || H < 1 || KV < 1 || H % KV || S < 0 ||
      blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_decode_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), H, H / KV, S, d, q_sb, q_sh, k_sb, k_sg, k_ss, v_sb, v_sg, v_ss,
      b_sb, b_sh, b_ss, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K12: q [B, H, d], caches [B, KV, S, d], bias f32 [B, H, S] (strides in
// elements; a stride of 0 broadcasts), all of one type: f32 (is_bf16 = 0)
// or bf16.  Outputs f32: o [B, H, d], m and l [B, H], contiguous.
extern "C" int cullavo_flash_decode(
    const void* q, const void* k, const void* v, const void* bias, void* o, void* m, void* l,
    int is_bf16, int B, int H, int KV, int S, int d, long long q_sb, long long q_sh,
    long long k_sb, long long k_sg, long long k_ss, long long v_sb, long long v_sg,
    long long v_ss, long long b_sb, long long b_sh, long long b_ss, float scale,
    void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, bias, o, m, l, B, H, KV, S, d, q_sb, q_sh, k_sb, k_sg,
                                 k_ss, v_sb, v_sg, v_ss, b_sb, b_sh, b_ss, scale, stream);
  return launch<float>(q, k, v, bias, o, m, l, B, H, KV, S, d, q_sb, q_sh, k_sb, k_sg, k_ss,
                       v_sb, v_sg, v_ss, b_sb, b_sh, b_ss, scale, stream);
}

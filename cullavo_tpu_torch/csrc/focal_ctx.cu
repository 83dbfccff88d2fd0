// The gated focal-modulation context of a FocalNet block (kernel K10).
//
// Replaces: cullavo_tpu/ops/focal_pallas.py, fused_focal_ctx ->
// _fused_focal_fwd -> _focal_kernel (the whole [c_blk, H*W] map of a
// channel slab in VMEM, each depthwise conv as k*k masked lane shifts).
// Computes, per (b, c), with ctx_0 = ctx[b, c] and zero padding:
//     ctx_{l+1} = gelu(dwconv_{k_l}(ctx_l, taps_l[c]))      l = 0..L-1
//     acc       = sum_l ctx_{l+1} * gates[b, l]
//                 + gelu(mean_hw(ctx_L)) * gates[b, L]
//     out       = acc / (L + 1)   (scaling_modulator)   or acc
// all in f32, one rounding to the output dtype; GELU in its tanh form (the
// TPU kernel's) or its erf form (the f32 model's), chosen by the caller.
//
// Bound on the H100: f32 operations, 2 * sum(k^2) per element (328 at
// k = 3, 5, 7, 9): 8.25 GFLOP for FocalNet-L's first stage at batch 8 and
// a 512^2 image, ~0.12 ms at 67 TFLOP/s, while its bytes (ctx, gates and
// output, bf16) take ~0.03 ms.  Design: the conv chain is a stencil whose
// footprint grows by r_l = k_l / 2 per level, so one block takes one
// (b, c) plane and a TILE x TILE output tile, loads the tile with a halo
// of R = sum r_l pixels into shared memory once, and runs every level out
// of shared memory (ping-pong buffers, each level's region shrinking by
// its radius); positions outside the image are never written and stay
// zero, which is the zero padding of every level.  The tile's share of
// the accumulator lives in registers.  The global mean needs the whole
// plane, so the first kernel writes the f32 accumulator and the tile's sum
// of ctx_L; a second, elementwise kernel adds gelu(mean) * gate_L, scales
// and rounds.  Any map size and any L <= 8 (odd k) run: the tile shrinks
// (64, 32, 16) until the taps and the two buffers fit in shared memory, or
// to the map's size.  Launches on the caller's stream and allocates nothing
// (the wrapper passes the f32 scratch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kMaxPerThread = 16;   // TILE^2 / kThreads at TILE = 64

struct Focal {
  int L;
  int k[kMaxLevels];
  int tap_off[kMaxLevels];   // column of level l's first tap in taps [C, sum k^2]
  int n_taps;                // sum k^2
  int R;                     // sum of radii: the halo
  int tile;
  int tiles_x, tiles_y;
  int H, W;
  int C;
  long long ctx_sb, ctx_sc;  // ctx strides of b and c (pixels contiguous)
  long long gate_sb, gate_sl;
  int erf_gelu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float x, int erf_form) {
  if (erf_form) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__host__ __device__ __forceinline__ int taps_padded(int n_taps) { return (n_taps + 3) / 4 * 4; }

// Shared memory of one block at a given tile (taps and the two buffers).
__host__ __device__ __forceinline__ size_t smem_bytes(int tile, int R, int n_taps) {
  const size_t side = tile + 2 * R;
  return (taps_padded(n_taps) + 2 * side * side) * sizeof(float);
}

constexpr size_t kSmemBudget = 200 * 1024;

// One level over the region's in-image positions: out = gelu(dwconv(in)).
// The taps sit in registers (k^2 of them), so each multiply-add reads one
// value from shared memory.
template <int K>
__device__ __forceinline__ void conv_level(const float* in, float* out, const float* w, int side,
                                           int ry0, int rx0, int nw, int cnt, int erf_gelu) {
  float wr[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wr[i] = w[i];
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const int y = ry0 + i / nw, x = rx0 + i % nw;
    const float* base = in + (y - K / 2) * side + (x - K / 2);
    float s = 0.f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) s = fmaf(wr[dy * K + dx], base[dy * side + dx], s);
    out[y * side + x] = gelu(s, erf_gelu);
  }
}

__device__ void conv_level_any(const float* in, float* out, const float* w, int k, int side,
                               int ry0, int rx0, int nw, int cnt, int erf_gelu) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const int y = ry0 + i / nw, x = rx0 + i % nw;
    const float* base = in + (y - k / 2) * side + (x - k / 2);
    float s = 0.f;
    for (int dy = 0; dy < k; ++dy)
      for (int dx = 0; dx < k; ++dx) s = fmaf(w[dy * k + dx], base[dy * side + dx], s);
    out[y * side + x] = gelu(s, erf_gelu);
  }
}

// grid (tiles, C, B).  acc: f32 [B, C, H*W]; partial: f32 [B, C, tiles].
template <typename T>
__global__ void __launch_bounds__(kThreads)
focal_tile_kernel(const T* __restrict__ ctx, const T* __restrict__ gates,
                  const float* __restrict__ taps, float* __restrict__ acc_out,
                  float* __restrict__ partial, Focal f) {
  extern __shared__ __align__(16) float smem[];   // taps, then two side x side buffers
  __shared__ float s_red[kThreads / 32];

  const int tile = f.tile;
  const int side = tile + 2 * f.R;                 // the loaded region's side
  float* s_taps = smem;
  float* buf0 = smem + taps_padded(f.n_taps);
  float* buf1 = buf0 + side * side;
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const long long b = blockIdx.z;
  const int oy = (t / f.tiles_x) * tile, ox = (t % f.tiles_x) * tile;   // tile origin
  const int gy0 = oy - f.R, gx0 = ox - f.R;                              // region origin
  const int HW = f.H * f.W;

  for (int i = threadIdx.x; i < f.n_taps; i += kThreads) s_taps[i] = taps[(long long)c * f.n_taps + i];
  // the input with its halo; zero outside the image (and in buf1)
  const T* src = ctx + b * f.ctx_sb + c * f.ctx_sc;
  for (int i = threadIdx.x; i < side * side; i += kThreads) {
    const int gy = gy0 + i / side, gx = gx0 + i % side;
    float v = 0.f;
    if (gy >= 0 && gy < f.H && gx >= 0 && gx < f.W) v = to_f(src[gy * f.W + gx]);
    buf0[i] = v;
    buf1[i] = 0.f;
  }
  __syncthreads();

  // this thread's output pixels of the tile: p = threadIdx.x + j * kThreads
  const int n_out = tile * tile;
  float acc[kMaxPerThread];
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) acc[j] = 0.f;
  const T* gb = gates + b * f.gate_sb;

  float* in = buf0;
  float* out = buf1;
  int start = 0;                                    // the current input region: [start, side - start)
  for (int l = 0; l < f.L; ++l) {
    const int k = f.k[l], r = k / 2;
    start += r;                                     // this level's output region
    const int n = side - 2 * start;
    // clip the region to the image (outside stays zero)
    const int ry0 = max(start, -gy0), ry1 = min(start + n, f.H - gy0);
    const int rx0 = max(start, -gx0), rx1 = min(start + n, f.W - gx0);
    const int nw = rx1 - rx0;
    const int cnt = (ry1 > ry0 && nw > 0) ? (ry1 - ry0) * nw : 0;
    const float* w = s_taps + f.tap_off[l];
    switch (k) {
      case 3: conv_level<3>(in, out, w, side, ry0, rx0, nw, cnt, f.erf_gelu); break;
      case 5: conv_level<5>(in, out, w, side, ry0, rx0, nw, cnt, f.erf_gelu); break;
      case 7: conv_level<7>(in, out, w, side, ry0, rx0, nw, cnt, f.erf_gelu); break;
      case 9: conv_level<9>(in, out, w, side, ry0, rx0, nw, cnt, f.erf_gelu); break;
      default: conv_level_any(in, out, w, k, side, ry0, rx0, nw, cnt, f.erf_gelu); break;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      const int p = threadIdx.x + j * kThreads;
      if (p < n_out) {
        const int ty = p / tile, tx = p % tile;
        const int gy = oy + ty, gx = ox + tx;
        if (gy < f.H && gx < f.W)
          acc[j] += out[(ty + f.R) * side + (tx + f.R)] * to_f(gb[l * f.gate_sl + gy * f.W + gx]);
      }
    }
    float* tmp = in;
    in = out;
    out = tmp;
    __syncthreads();
  }

  // write the accumulator; sum ctx_L (now in `in`) over the tile
  float* ab = acc_out + (b * f.C + c) * static_cast<long long>(HW);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int p = threadIdx.x + j * kThreads;
    if (p < n_out) {
      const int ty = p / tile, tx = p % tile;
      const int gy = oy + ty, gx = ox + tx;
      if (gy < f.H && gx < f.W) {
        ab[gy * f.W + gx] = acc[j];
        sum += in[(ty + f.R) * side + (tx + f.R)];
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) s += s_red[i];
    partial[(b * f.C + c) * static_cast<long long>(gridDim.x) + t] = s;
  }
}

// grid (ceil(HW / kThreads), C, B): out = (acc + gelu(mean) * gate_L) [/ (L+1)]
template <typename T>
__global__ void __launch_bounds__(kThreads)
focal_finish_kernel(const float* __restrict__ acc, const float* __restrict__ partial,
                    const T* __restrict__ gates, T* __restrict__ out, Focal f, int n_tiles,
                    int scaling) {
  const int HW = f.H * f.W;
  const int c = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = (b * f.C + c) * static_cast<long long>(HW);
  const float* pp = partial + (b * f.C + c) * static_cast<long long>(n_tiles);
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += pp[i];
  const float g = gelu(s / static_cast<float>(HW), f.erf_gelu);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  float v = acc[plane + p] + g * to_f(gates[b * f.gate_sb + f.L * f.gate_sl + p]);
  if (scaling) v = v / static_cast<float>(f.L + 1);
  store(out + plane + p, v);
}

template <typename T>
int launch(const void* ctx, const void* gates, const float* taps, float* acc, float* partial,
           void* out, Focal f, int B, int scaling, cudaStream_t stream) {
  const size_t smem = smem_bytes(f.tile, f.R, f.n_taps);
  cudaError_t e = cudaFuncSetAttribute(focal_tile_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = f.tiles_x * f.tiles_y;
  focal_tile_kernel<T><<<dim3(n_tiles, f.C, B), kThreads, smem, stream>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(gates), taps, acc, partial, f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int HW = f.H * f.W;
  focal_finish_kernel<T><<<dim3((HW + kThreads - 1) / kThreads, f.C, B), kThreads, 0, stream>>>(
      acc, partial, static_cast<const T*>(gates), static_cast<T*>(out), f, n_tiles, scaling);
  return static_cast<int>(cudaGetLastError());
}

// The tile (64, 32 or 16): the largest whose block fits the shared-memory
// budget, and no larger than the map needs (a 16^2 map takes 16, not 64:
// the halo buffers are filled in full); -1 for levels the kernel refuses
// (L outside 1..8, an even k).
int pick_tile(const void* ks_host, int L, int H, int W) {
  if (L < 1 || L > kMaxLevels) return -1;
  const int* ks = static_cast<const int*>(ks_host);
  int R = 0, n_taps = 0;
  for (int l = 0; l < L; ++l) {
    if (ks[l] < 1 || ks[l] % 2 == 0) return -1;
    R += ks[l] / 2;
    n_taps += ks[l] * ks[l];
  }
  const int side = H > W ? H : W;
  int tile = 64;
  while (tile > 16 && (smem_bytes(tile, R, n_taps) > kSmemBudget || tile / 2 >= side)) tile /= 2;
  return smem_bytes(tile, R, n_taps) > kSmemBudget ? -1 : tile;
}

}  // namespace

// The number of tiles the launch will use for an H x W map (the wrapper
// sizes the partial-sum scratch with it); -1 if the levels are refused.
extern "C" int cullavo_focal_ctx_tiles(const void* ks_host, int L, int H, int W) {
  const int tile = pick_tile(ks_host, L, H, W);
  if (tile < 0) return -1;
  return ((H + tile - 1) / tile) * ((W + tile - 1) / tile);
}

// ctx [B, C, H*W] (strides ctx_sb, ctx_sc; pixels contiguous); gates
// [B, L+1, H*W] (strides gate_sb, gate_sl); taps f32 [C, sum k^2]
// contiguous; acc f32 [B, C, H*W] and partial f32 [B, C, tiles] scratch;
// out [B, C, H*W] contiguous in ctx's dtype.
extern "C" int cullavo_focal_ctx(const void* ctx, const void* gates, const void* taps,
                                 void* acc, void* partial, void* out, const void* ks_host,
                                 int L, int B, int C, int H, int W, long long ctx_sb,
                                 long long ctx_sc, long long gate_sb, long long gate_sl,
                                 int scaling, int erf_gelu, int is_bf16, void* stream) {
  const int n_tiles = cullavo_focal_ctx_tiles(ks_host, L, H, W);
  if (n_tiles < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* ks = static_cast<const int*>(ks_host);
  Focal f;
  f.L = L;
  f.R = 0;
  f.n_taps = 0;
  for (int l = 0; l < L; ++l) {
    f.k[l] = ks[l];
    f.tap_off[l] = f.n_taps;
    f.n_taps += ks[l] * ks[l];
    f.R += ks[l] / 2;
  }
  const int tile = pick_tile(ks_host, L, H, W);
  f.tile = tile;
  f.tiles_x = (W + tile - 1) / tile;
  f.tiles_y = (H + tile - 1) / tile;
  f.H = H;
  f.W = W;
  f.C = C;
  f.ctx_sb = ctx_sb;
  f.ctx_sc = ctx_sc;
  f.gate_sb = gate_sb;
  f.gate_sl = gate_sl;
  f.erf_gelu = erf_gelu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  float* ac = static_cast<float*>(acc);
  float* pa = static_cast<float*>(partial);
  if (is_bf16) return launch<__nv_bfloat16>(ctx, gates, tp, ac, pa, out, f, B, scaling, s);
  return launch<float>(ctx, gates, tp, ac, pa, out, f, B, scaling, s);
}

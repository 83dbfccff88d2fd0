// Multi-scale deformable attention, forward (kernel K9).
//
// Replaces: cullavo_tpu/ops/msdeform_pallas.py, ms_deform_attn_pallas ->
// _level_partial -> _level_kernel (one level per launch, bilinear sampling
// written as a dense "tent" matrix times the level's value map, because
// gathers are slow on the TPU).  Computes, for every (b, q, head):
//     out[b, q, h, :] = sum_l sum_p att[b,q,h,l,p] *
//                       bilinear(value_l[b, :, :, h, :], loc[b,q,h,l,p])
// with grid_sample's align_corners=False convention: x = loc_x * W_l - 0.5,
// y = loc_y * H_l - 0.5; a corner outside the map contributes zero.  Sums
// in f32 over all levels and points, one store in the value dtype.
//
// Bound on the H100: memory.  The value map is read once (B*S*Hh*hd
// elements), the locations, weights and output once: about 138 MB at the
// deform encoder's shape (B 8, S = Q = 5376, 8 heads x 64, 3 levels x 4
// points, bf16 value), ~41 us at 3.35 TB/s.  Design: a direct bilinear
// gather, as the reference's CUDA im2col does (Hopper gathers are cheap; the
// tent matrix is not carried over).  One warp per (b, q, head); lane j
// owns channels [j*CPL, (j+1)*CPL) of the head (CPL = hd / 32), so each
// corner of a sampling point is one coalesced read of hd contiguous
// elements (128 bytes at hd 64 bf16), mostly from L2 (the value map is
// ~44 MB).  Every lane reads the same location and weight (one broadcast
// transaction).  Launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int CPL>
__device__ __forceinline__ void corner(const T* __restrict__ base, int yy, int xx, int H, int W,
                                       long long row_stride, float wgt, float* acc) {
  if (yy < 0 || yy > H - 1 || xx < 0 || xx > W - 1) return;
  const T* p = base + (static_cast<long long>(yy) * W + xx) * row_stride;
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] += wgt * to_f(p[c]);
}

// value [B, S, Hh, hd]; loc [B, Q, Hh, L, P, 2] f32; att [B, Q, Hh, L, P] f32;
// out [B, Q, Hh, hd]
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
msdeform_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ att, T* __restrict__ out, Levels lv, int S, int Q,
                int Hh, int P, long long n_warps) {
  const long long wid = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (wid >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int hd = CPL * 32;
  const int h = static_cast<int>(wid % Hh);
  const long long bq = wid / Hh;
  const long long b = bq / Q;
  const long long row_stride = static_cast<long long>(Hh) * hd;   // one spatial position
  const T* vb = value + b * S * row_stride + static_cast<long long>(h) * hd + lane * CPL;
  const float* lp = loc + wid * lv.n * P * 2;
  const float* ap = att + wid * lv.n * P;

  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.h[l], W = lv.w[l];
    const T* vl = vb + lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const float a = ap[l * P + p];
      // two roundings, as the plain version's loc * W - 0.5 (a contracted
      // fma would move x by an ulp, 8e-6 at x ~ 64)
      const float x = __fsub_rn(__fmul_rn(lp[(l * P + p) * 2 + 0], static_cast<float>(W)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(lp[(l * P + p) * 2 + 1], static_cast<float>(H)), 0.5f);
      const float xf = floorf(x), yf = floorf(y);
      // far outside (or not finite): no corner can be inside the map
      if (!(xf >= -1.f && xf <= static_cast<float>(W) && yf >= -1.f &&
            yf <= static_cast<float>(H)))
        continue;
      const int x0 = static_cast<int>(xf), y0 = static_cast<int>(yf);
      const float wx = x - xf, wy = y - yf;
      float s[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) s[c] = 0.f;
      corner<T, CPL>(vl, y0, x0, H, W, row_stride, (1.f - wx) * (1.f - wy), s);
      corner<T, CPL>(vl, y0, x0 + 1, H, W, row_stride, wx * (1.f - wy), s);
      corner<T, CPL>(vl, y0 + 1, x0, H, W, row_stride, (1.f - wx) * wy, s);
      corner<T, CPL>(vl, y0 + 1, x0 + 1, H, W, row_stride, wx * wy, s);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] += a * s[c];
    }
  }
  T* o = out + wid * hd + lane * CPL;
#pragma unroll
  for (int c = 0; c < CPL; ++c) store(o + c, acc[c]);
}

template <typename T>
int launch(const void* value, const void* loc, const void* att, void* out, const Levels& lv,
           int B, int S, int Q, int Hh, int hd, int P, cudaStream_t stream) {
  const long long n_warps = static_cast<long long>(B) * Q * Hh;
  const unsigned blocks = static_cast<unsigned>((n_warps + kWarps - 1) / kWarps);
  const T* v = static_cast<const T*>(value);
  const float* lo = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(att);
  T* o = static_cast<T*>(out);
  switch (hd) {
    case 32:
      msdeform_kernel<T, 1><<<blocks, kWarps * 32, 0, stream>>>(v, lo, at, o, lv, S, Q, Hh, P,
                                                                 n_warps);
      break;
    case 64:
      msdeform_kernel<T, 2><<<blocks, kWarps * 32, 0, stream>>>(v, lo, at, o, lv, S, Q, Hh, P,
                                                                 n_warps);
      break;
    case 128:
      msdeform_kernel<T, 4><<<blocks, kWarps * 32, 0, stream>>>(v, lo, at, o, lv, S, Q, Hh, P,
                                                                 n_warps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host int32 [L, 2] (H_l, W_l); starts: host int64 [L].
// is_bf16: value/out dtype (1 bf16, 0 f32); loc and att are f32.
extern "C" int cullavo_msdeform(const void* value, const void* loc, const void* att, void* out,
                                const void* shapes, const void* starts, int n_levels, int B,
                                int S, int Q, int Hh, int hd, int P, int is_bf16, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = n_levels;
  const int* sh = static_cast<const int*>(shapes);
  const long long* st = static_cast<const long long*>(starts);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = sh[2 * l];
    lv.w[l] = sh[2 * l + 1];
    lv.start[l] = st[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(value, loc, att, out, lv, B, S, Q, Hh, hd, P, s);
  return launch<float>(value, loc, att, out, lv, B, S, Q, Hh, hd, P, s);
}

// Multi-scale deformable attention, forward (kernel K9).
//
// Replaces: cullavo_tpu/ops/msdeform_pallas.py, ms_deform_attn_pallas ->
// _level_partial -> _level_kernel (one level per launch, bilinear sampling
// written as a dense "tent" matrix times the level's value map, because
// gathers are slow on the TPU).  Computes, for every (b, q, head):
//     out[b, q, h, :] = sum_l sum_p att[b,q,h,l,p] *
//                       bilinear(value_l[b, :, :, h, :], loc[b,q,h,l,p])
// with grid_sample's align_corners=False convention: x = loc_x * W_l - 0.5,
// y = loc_y * H_l - 0.5 (two roundings, as the plain version); a corner
// outside the map contributes zero and a point that is not finite is
// skipped.  Sums in f32 over all levels and points, one rounding of the
// output into the value dtype.
//
// Bound on the H100: memory.  The value map is read once (B*S*Hh*hd
// elements), the locations, weights and output once: about 129 MB at the
// deform encoder's shape (B 8, S = Q = 5376, 8 heads x 64, 3 levels x 4
// points, bf16 value and weights), ~39 us at 3.35 TB/s.  The gather itself
// moves far more: B*Q*Hh*L*P*4 corners of hd elements (~2.1 GB at that shape)
// from L2 or L1 to the SMs, and its f32 multiply-adds (two instructions per
// bf16 channel and corner) keep the SMs' issue slots busy for ~70 us.
//
// Design: a direct bilinear gather (Hopper gathers are cheap; the TPU's tent
// matrix is not carried over).  A block of 8 warps serves one (b, head) and
// a tile of 64 queries (grid: tiles x heads x batch), so that neighbouring
// queries, which sample neighbouring cells, share L1 lines; a warp walks
// the tile's queries.
// - Wide loads: a corner's hd elements are one 16-byte load for each of G =
//   hd * size / 16 lanes (8 lanes at hd 64 bf16); the warp's 32 / G lane
//   groups take the corners of a query's points in turn (slot k = corner k %
//   4 of point k / 4 goes to group k % (32 / G)), and each lane issues a
//   batch of kBatch corner loads before it uses any.  A corner outside its
//   map reads the slice's first row with weight 0, so a slot is always one
//   read-only load, with no branch.
// - Shared locations: a query's locations and weights (36 numbers at 3 x 4
//   points) are loaded once, coalesced, by the warp's lanes (two lanes a
//   point, two corners each); each lane writes its corners' (row offset,
//   weight) pairs into the warp's table in shared memory, where the loading
//   lanes read them.  The next query's locations are fetched before this
//   one's corners are gathered.
// - The groups' partial sums meet in a reduce-scatter of shuffles; each lane
//   stores the hd / 32 channels it ends with.
// Staging the coarse levels in shared memory (one (b, head) a block, 16^2
// and 32^2 in 160 KiB) was built and measured slower at both the uniform and
// the encoder's draw: L1 already holds those maps.  So was a tensor-core
// body (each query's 48 corner rows copied by cp.async into a warp tile,
// summed by m16n8k16 products with the weights split into bf16 hi + lo):
// every gathered row then crosses shared memory twice, and that costs more
// than the two instructions a channel it saves.  L and P are template
// parameters at the encoder's 3 x 4, with a generic body for other counts
// (points in chunks of kChunk).  Weights in bf16 or f32, read as they are
// (bf16 widens exactly).  One launch, allocating nothing, on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;
constexpr int kChunk = 16;   // points a warp's table holds
constexpr int kBatch = 6;    // corner loads a lane issues before it uses them

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];   // first position of the level in S
};

// one corner of a point: the element offset of its row in the (b, head)'s
// slice of value, and its weight (the point's attention weight times the
// corner's bilinear weight; 0 for a corner outside the map, whose offset is
// then 0)
struct Corner {
  int off;
  float w;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the 16 bytes of a load as f32 channels (bf16 widens exactly)
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
}

// value [B, S, Hh, HD]; loc [B, Q, Hh, L, P, 2] f32; att [B, Q, Hh, L, P]
// (bf16 if att_bf16, else f32); out [B, Q, Hh * HD].  L_ = P_ = 0: counts
// at run time.
template <typename T, int HD, int L_, int P_>
__global__ void __launch_bounds__(kWarps * 32, 4)
msdeform_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const void* __restrict__ att, T* __restrict__ out, Levels lv, int S, int Q,
                int Hh, int P_rt, int att_bf16, int tile_q) {
  constexpr int VE = 16 / sizeof(T);   // channels a 16-byte load
  constexpr int G = HD / VE;           // lanes a corner row
  constexpr int NG = 32 / G;           // lane groups a warp
  static_assert(G >= 1 && G <= 32 && NG * G == 32 && VE >= NG, "head dim");
  const int P = P_ ? P_ : P_rt;
  const int LP = L_ ? L_ * P_ : lv.n * P_rt;   // points a query
  const int nchunks = L_ ? (L_ * P_ + kChunk - 1) / kChunk : (LP + kChunk - 1) / kChunk;

  // the level table (a lane indexes it by its own point's level) and the
  // warps' corner tables
  __shared__ int lvs[3][kMaxLevels];   // H, W, start
  __shared__ Corner tables[kWarps][kChunk * 4];
  if (threadIdx.x == 0) {   // constant indices: the parameter stays out of local memory
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      lvs[0][l] = lv.h[l];
      lvs[1][l] = lv.w[l];
      lvs[2][l] = lv.start[l];
    }
  }
  __syncthreads();

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_elems = Hh * HD;   // one position; a batch's slice is < 2^31 elements
  const T* vb = value + static_cast<long long>(b) * S * row_elems + h * HD;
  const int q0 = tile * tile_q;
  const int q1 = min(Q, q0 + tile_q);
  if (q0 + warp >= q1) return;
  const int nq = (q1 - q0 - warp + kWarps - 1) / kWarps;   // this warp's queries
  const int nsteps = nq * nchunks;
  Corner* tab = tables[warp];
  const int g = lane / G, gl = lane - g * G;
  const int dy = lane & 1;            // this lane's corners in the producer:
  const int pl = lane >> 1;           // (dx 0 and 1, dy) of chunk point pl

  // the producer's inputs of step s (query, chunk): x, y and weight of
  // chunk point pl
  auto fetch = [&](int s, float& fx, float& fy, float& fa) {
    fx = fy = fa = 0.f;
    const int qi = s / nchunks, p = (s - qi * nchunks) * kChunk + pl;
    if (s < nsteps && p < LP) {
      const long long bqh = (static_cast<long long>(b) * Q + q0 + warp + qi * kWarps) * Hh + h;
      const float2 xy = reinterpret_cast<const float2*>(loc)[bqh * LP + p];
      fx = xy.x;
      fy = xy.y;
      fa = att_bf16 ? to_f(reinterpret_cast<const __nv_bfloat16*>(att)[bqh * LP + p])
                    : reinterpret_cast<const float*>(att)[bqh * LP + p];
    }
  };

  float fx, fy, fa;
  fetch(0, fx, fy, fa);
  float acc[VE];
  for (int s = 0; s < nsteps; ++s) {
    const int qi = s / nchunks, chunk = s - qi * nchunks;
    const int np = min(kChunk, LP - chunk * kChunk);
    if (chunk == 0) {
#pragma unroll
      for (int c = 0; c < VE; ++c) acc[c] = 0.f;
    }
    // producer: this lane's two corners of chunk point pl
    if (pl < np) {
      const int l = (chunk * kChunk + pl) / P;
      const int H = lvs[0][l], W = lvs[1][l], start = lvs[2][l];
      // two roundings, as the plain version's loc * W - 0.5 (a contracted
      // fma would move x by an ulp, 8e-6 at x ~ 64)
      const float x = __fsub_rn(__fmul_rn(fx, static_cast<float>(W)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(fy, static_cast<float>(H)), 0.5f);
      const float xf = floorf(x), yf = floorf(y);
      // far outside (or not finite): no corner can be inside the map
      const bool in = xf >= -1.f && xf <= static_cast<float>(W) && yf >= -1.f &&
                      yf <= static_cast<float>(H);
      const int x0 = in ? static_cast<int>(xf) : 0;
      const int yy = (in ? static_cast<int>(yf) : 0) + dy;
      const float wx = x - xf, wy = y - yf;
      const float wyv = dy ? wy : 1.f - wy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xx = x0 + dx;
        const bool ok = in && xx >= 0 && xx < W && yy >= 0 && yy < H;
        Corner e;
        e.off = ok ? (start + yy * W + xx) * row_elems : 0;
        e.w = ok ? fa * ((dx ? wx : 1.f - wx) * wyv) : 0.f;
        tab[pl * 4 + dy * 2 + dx] = e;
      }
    }
    __syncwarp();
    fetch(s + 1, fx, fy, fa);   // the next step's locations, ahead of the gather

    // consumers: group g takes slots g, g + NG, ... of the chunk's np * 4,
    // kBatch loads in flight before their sums
    const int ns = np * 4;
    constexpr int kUnroll = sizeof(T) == 4 ? 1 : 4;   // f32 spills at 64 registers unrolled
#pragma unroll kUnroll
    for (int k0 = 0; k0 < ns; k0 += NG * kBatch) {
      uint4 v[kBatch];
      float w[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int k = k0 + g + j * NG;
        const Corner e = k < ns ? tab[k] : Corner{0, 0.f};
        w[j] = e.w;
        v[j] = __ldg(reinterpret_cast<const uint4*>(vb + e.off + gl * VE));
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        float f[VE];
        widen<T>(v[j], f);
#pragma unroll
        for (int c = 0; c < VE; ++c) acc[c] = fmaf(w[j], f[c], acc[c]);
      }
    }
    __syncwarp();   // the table is rewritten by the next step's producer

    if (chunk == nchunks - 1) {
      // reduce-scatter over the NG groups: each step halves the channels a
      // lane keeps (the upper half where the step's lane bit is set)
      int sub = 0;
      int width = VE;
#pragma unroll
      for (int off = 16; off >= G; off >>= 1) {
        width >>= 1;
        const bool hi = (lane & off) != 0;
#pragma unroll
        for (int i = 0; i < VE / 2; ++i) {
          if (i < width) {
            const float send = hi ? acc[i] : acc[width + i];
            const float recv = __shfl_xor_sync(0xffffffffu, send, off);
            acc[i] = (hi ? acc[width + i] : acc[i]) + recv;
          }
        }
        if (hi) sub += width;
      }
      constexpr int kept = VE / NG;
      const long long bqh = (static_cast<long long>(b) * Q + q0 + warp + qi * kWarps) * Hh + h;
      T* o = out + bqh * HD + gl * VE + sub;
      if constexpr (sizeof(T) == 2 && kept % 2 == 0) {
#pragma unroll
        for (int i = 0; i < kept; i += 2)
          *reinterpret_cast<__nv_bfloat162*>(o + i) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < kept; ++i) {
          if constexpr (sizeof(T) == 2) o[i] = __float2bfloat16(acc[i]);
          else o[i] = acc[i];
        }
      }
    }
  }
}

template <typename T, int HD, int L_, int P_>
int launch_one(const void* value, const void* loc, const void* att, void* out, const Levels& lv,
               int B, int S, int Q, int Hh, int P, int att_bf16, int tile_q, int tiles,
               cudaStream_t stream) {
  msdeform_kernel<T, HD, L_, P_><<<dim3(tiles, Hh, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc), att, static_cast<T*>(out),
      lv, S, Q, Hh, P, att_bf16, tile_q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_hd(bool path, const void* value, const void* loc, const void* att, void* out,
              const Levels& lv, int B, int S, int Q, int Hh, int P, int att_bf16, int tile_q,
              int tiles, cudaStream_t stream) {
  if (path)
    return launch_one<T, HD, 3, 4>(value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                                   tiles, stream);
  return launch_one<T, HD, 0, 0>(value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                                 tiles, stream);
}

template <typename T>
int launch(int hd, bool path, const void* value, const void* loc, const void* att, void* out,
           const Levels& lv, int B, int S, int Q, int Hh, int P, int att_bf16, int tile_q,
           int tiles, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(path, value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                              tiles, stream);
    case 64:
      return launch_hd<T, 64>(path, value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                              tiles, stream);
    case 128:
      return launch_hd<T, 128>(path, value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                               tiles, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// shapes: host int32 [L, 2] (H_l, W_l); starts: host int32 [L].  is_bf16:
// value/out dtype (1 bf16, 0 f32); att_bf16: the weights' dtype; loc is f32.
// The plan (queries a tile, tiles) from ops/msdeform.msdeform_plan.
extern "C" int cullavo_msdeform(const void* value, const void* loc, const void* att, void* out,
                                const void* shapes, const void* starts, int n_levels, int B,
                                int S, int Q, int Hh, int hd, int P, int is_bf16, int att_bf16,
                                int tile_q, int tiles, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || P < 1 || tile_q < 1 || tiles < 1 ||
      static_cast<long long>(tiles) * tile_q < Q)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  lv.n = n_levels;
  const int* sh = static_cast<const int*>(shapes);
  const int* st = static_cast<const int*>(starts);
  for (int l = 0; l < n_levels; ++l) {
    lv.h[l] = sh[2 * l];
    lv.w[l] = sh[2 * l + 1];
    lv.start[l] = st[l];
  }
  const bool path = n_levels == 3 && P == 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(hd, path, value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16,
                                 tile_q, tiles, s);
  return launch<float>(hd, path, value, loc, att, out, lv, B, S, Q, Hh, P, att_bf16, tile_q,
                       tiles, s);
}

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
// output, bf16) take ~0.03 ms.  So the f32 FMAs should set the pace, and
// shared memory (32 lanes a clock against 128 FMA lanes) must not.
//
// Design:
//  * register blocking along y.  A thread owns a slot: a column strip of
//    S = 16 outputs of one plane.  The buffers are column-major, so per tap
//    column dx the strip's rows y0 - 4 .. y0 + 19 are six 16-byte loads
//    (no address arithmetic per row) and the column's k taps are broadcasts;
//    then S k FMAs per tap column.  The lanes of a warp take consecutive
//    slots (x fastest) and a column pitch of 4 modulo 8 floats puts any
//    eight columns' 16-byte loads on distinct banks; global loads and stores
//    of a row coalesce.  A slot's gates load ahead of its conv and stay raw
//    until used, so their latency hides behind FMAs.
//  * one pass where the plane fits.  The block holds whole (b, c) planes in
//    shared memory, each inside a zero ring as wide as the widest radius
//    (never written, so every level reads zero padding), stacked with shared
//    gap rows; two such buffers ping-pong between levels.  Every level runs
//    over the whole map, the gated sum stays in registers (up to 3 slots a
//    thread), each slot sums its ctx_L, the block adds the slots' sums per
//    plane in a fixed order, and the same kernel adds gelu(mean) * gate_L,
//    scales and rounds: one launch, no f32 scratch.  Small maps put several
//    planes of one b in a block, so every thread has a slot and a block's
//    prologue (both buffers zeroed under the first loads of the planes) and
//    reductions are paid once for several planes.
//  * tiles where it does not.  A block takes one tile of one plane with a
//    halo of R = sum of radii, clipped to the image; level l is valid on the
//    window shrunk by the radii of levels 0..l on its sides inside the
//    image, so the last level is valid on the tile.  Same slots, same body;
//    the tile writes its gated sum (f32) and its sum of ctx_L, and a second,
//    elementwise kernel adds the global term.
//  * the plan (planes a block, tile, gap, pitch, slots a thread) comes from
//    the wrapper's pure planner (ops/focal.focal_plan); this entry checks it.
// What bounds it (clock64 phases by scripts/focal_phases.py on an H100):
// per slot and level a fixed cost that does not scale with k^2 (two SFU
// operations of GELU per output, the gate loads, the output stores, the
// level's barrier) beside the conv, at 16 warps an SM (512 threads of at
// most 128 registers).  No integer division per element: a slot's plane,
// row group and column are found once per slot and level.  Any map size,
// bf16 or f32, 1 to 8 levels of odd k (k = 1, 3, 5, 7, 9 unrolled over 16-
// byte strips; larger k, or maps whose height is not a multiple of 4, by a
// loop with one load per FMA).  Launches on the caller's stream and
// allocates nothing (the wrapper passes the tiled path's scratch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int S = 16;                  // outputs of a slot (rows of its column strip)
constexpr int kMaxSlots = 3;           // slots a thread
constexpr int kSmemLimit = 232448;     // a block's opt-in shared memory (227 KB)
constexpr int kFinishThreads = 256;

struct Focal {
  int L;
  int k[kMaxLevels];
  int tap_off[kMaxLevels];   // column of level l's first tap in taps [C, sum k^2]
  int rcum[kMaxLevels];      // radii of levels 0..l, summed
  int n_taps, tap_pitch;     // sum k^2; a plane's taps in shared memory
  int ring, halo;            // widest radius; sum of radii
  int H, W, C;
  int one_pass, planes, tile_h, tile_w, tiles_x, n_tiles;
  int gap, pitch, cols;      // a buffer: `cols` columns of `pitch` floats (column-major)
  long long ctx_sb, ctx_sc;  // ctx strides of b and c (pixels contiguous)
  long long gate_sb, gate_sl;
  int erf_gelu, scaling;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// GELU, erf form, or tanh form through 0.5 (1 + tanh(u)) = 1 / (1 + e^-2u):
// __expf (ex2, a few ulp) and a fast division keep it within ~1e-6 relative
// of tanhf's value, far inside the f32 tolerance, at a third of tanhf's
// instructions (e^-2u overflows to inf for very negative x: x * 1/inf = 0)
__device__ __forceinline__ float gelu(float x, int erf_form) {
  if (erf_form) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + __expf(-2.f * u));
}

// A slot's S gate values (rows y0 .. y0 + S - 1 of one column), loaded
// together and unconditionally (rows past the window read its last row) and
// kept raw until after the conv: converting (or packing) a value next to its
// load would wait out the load's latency there, before the conv.
template <typename T>
struct Gates {
  T v[S];
  __device__ __forceinline__ void load(const T* p, int W, int rows) {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = p[static_cast<long long>(min(s, rows - 1)) * W];
  }
  __device__ __forceinline__ float get(int s) const { return to_f(v[s]); }
};

// 4 bytes global -> shared, asynchronously (no register, no wait)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The k x k depthwise conv of a slot, in the column-major buffer (column
// stride Pt floats).  conv4<K> (K <= 9): col is the input at (column x - r,
// row y0 - 4), 16-byte aligned; per tap column the strip's rows y0 - 4 ..
// y0 + 19 as six 16-byte loads and the column's K taps (broadcasts) into
// registers, then S K FMAs; o the S outputs of rows y0 .. y0 + S - 1.
template <int K>
__device__ __forceinline__ void conv4(const float* __restrict__ col, int Pt,
                                      const float* __restrict__ w, float (&o)[S]) {
  constexpr int R = K / 2;
#pragma unroll
  for (int s = 0; s < S; ++s) o[s] = 0.f;
#pragma unroll 1
  for (int dx = 0; dx < K; ++dx) {
    float wc[K], seg[S + 8];
#pragma unroll
    for (int dy = 0; dy < K; ++dy) wc[dy] = w[dy * K + dx];
    const float4* c = reinterpret_cast<const float4*>(col + dx * Pt);
#pragma unroll
    for (int t = 0; t < (S + 8) / 4; ++t) {
      const float4 v = c[t];
      seg[4 * t] = v.x;
      seg[4 * t + 1] = v.y;
      seg[4 * t + 2] = v.z;
      seg[4 * t + 3] = v.w;
    }
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int s = 0; s < S; ++s) o[s] = fmaf(wc[dy], seg[s + dy + 4 - R], o[s]);
  }
}

// any k, one load per FMA: col is the input at (column x - r, row y0 - r)
__device__ __forceinline__ void conv_any(const float* __restrict__ col, int Pt,
                                         const float* __restrict__ w, int k, float (&o)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) o[s] = 0.f;
  for (int dx = 0; dx < k; ++dx)
    for (int dy = 0; dy < k; ++dy) {
      const float wv = w[dy * k + dx];
      const float* c = col + dx * Pt + dy;
#pragma unroll
      for (int s = 0; s < S; ++s) o[s] = fmaf(wv, c[s], o[s]);
    }
}

// planes [0, np) of wh x ww values, plane p's value (y, x) at src[p * sp +
// (wy0 + y) * W + wx0 + x], into dst[p * dp + y + x * dx] as f32.  V
// consecutive x a load (V = 4 where W, ww, wx0, sp and src allow: 8 or 16
// bytes), U loads in flight a thread (kept raw until all are issued).  Unit
// e = tid + kThreads u is stepped by kThreads in mixed radix (one division a
// thread) over (p, y, x) with x fastest at V = 1 (coalesced loads), over (p,
// x / V, y) with y fastest at V = 4, so that a warp's stores of one of its V
// columns are consecutive words (x fastest would put them Pt apart: with Pt
// = 4 mod 8, 16 to a bank).  `first` (every thread calls it once, between
// its first batch's loads and their stores) may prepare the destination
// meanwhile.
template <int V, typename T, typename First>
__device__ __forceinline__ void load_planes(float* dst, int dp, int dx, const T* src,
                                            long long sp, int W, int wy0, int wx0, int np,
                                            int wh, int ww, int tid, First&& first) {
  constexpr int U = V == 1 ? 8 : 4;
  using Raw = typename std::conditional<
      V == 1, T,
      typename std::conditional<sizeof(T) * V == 16, uint4, uint2>::type>::type;
  const int r0 = V == 1 ? ww : wh, r1 = V == 1 ? wh : ww / V;   // the fast digits' radices
  const int area = r0 * r1, n = np * area;
  const int stp = kThreads / area, rs = kThreads - stp * area, st1 = rs / r0, st0 = rs - st1 * r0;
  int p = tid / area, d1 = (tid - p * area) / r0;
  int d0 = tid - p * area - d1 * r0;
  src += static_cast<long long>(wy0) * W + wx0;
  Raw raw[U];
  int at[U];
  auto issue = [&](int e) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = e + u * kThreads < n;
      const int y = V == 1 ? d1 : d0, x = V == 1 ? d0 : d1 * V;
      at[u] = ok ? p * dp + y + x * dx : -1;
      raw[u] = *reinterpret_cast<const Raw*>(
          src + (ok ? p * sp + static_cast<long long>(y) * W + x : 0));
      d0 += st0;
      d1 += st1;
      p += stp;
      if (d0 >= r0) {
        d0 -= r0;
        ++d1;
      }
      if (d1 >= r1) {
        d1 -= r1;
        ++p;
      }
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (at[u] < 0) continue;
      T v[V];
      memcpy(v, &raw[u], sizeof(v));
#pragma unroll
      for (int i = 0; i < V; ++i) dst[at[u] + i * dx] = to_f(v[i]);
    }
  };
  issue(tid);
  first();
  put();
  for (int e = tid + U * kThreads; e < n; e += U * kThreads) {
    issue(e);
    put();
  }
}

// One-pass: grid (ceil(C / planes), 1, B), the block's planes c0 .. c0 +
// planes - 1 whole.  Tiled: grid (tiles, C, B), planes = 1, and acc_out f32
// [B, C, H*W] / partial f32 [B, C, tiles] take the tile's gated sum and its
// sum of ctx_L.  Shared memory: two column-major buffers of cols x pitch
// floats, the planes' taps, then [planes][kWarps] floats for the sums.
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads, 1)
focal_kernel(const T* __restrict__ ctx, const T* __restrict__ gates,
             const float* __restrict__ taps, T* __restrict__ out, float* __restrict__ acc_out,
             float* __restrict__ partial, Focal f) {
  extern __shared__ __align__(16) float smem[];
  const int Pt = f.pitch, ring = f.ring, gap = f.gap;
  float* const buf0 = smem;
  float* const buf1 = smem + f.cols * Pt;
  float* const s_taps = buf1 + f.cols * Pt;
  float* const s_red = s_taps + f.planes * f.tap_pitch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long b = blockIdx.z;

  // the block's planes, its tile and the window (the tile and its halo,
  // clipped to the image; the whole map in one-pass)
  int c0, tile = 0, ty0 = 0, tx0 = 0;
  if (f.one_pass) {
    c0 = blockIdx.x * f.planes;
  } else {
    tile = blockIdx.x;
    c0 = blockIdx.y;
    const int ty = tile / f.tiles_x;
    ty0 = ty * f.tile_h;
    tx0 = (tile - ty * f.tiles_x) * f.tile_w;
  }
  const int np = min(f.planes, f.C - c0);
  const int th = min(f.tile_h, f.H - ty0), tw = min(f.tile_w, f.W - tx0);
  const int wy0 = max(0, ty0 - f.halo), wx0 = max(0, tx0 - f.halo);
  const int WH = min(f.H, ty0 + th + f.halo) - wy0, WW = min(f.W, tx0 + tw + f.halo) - wx0;
  const bool top = wy0 > 0, left = wx0 > 0;
  const bool bottom = wy0 + WH < f.H, right = wx0 + WW < f.W;
  const int ty_w = ty0 - wy0, tx_w = tx0 - wx0;   // the tile within the window
  const int ng = (WH + S - 1) / S;           // row groups of a plane
  const int per_plane = ng * WW;             // slots of a plane
  const int n_slots = np * per_plane;
  const int prow = WH + gap;                 // buffer rows from one plane to the next
  // 16-byte strips: planes and row groups start at rows that are multiples of 4
  const bool vec = ring <= 4 && (WH & 3) == 0 && (gap & 3) == 0 && (Pt & 3) == 0;
  const long long HW = static_cast<long long>(f.H) * f.W;
  const float scale = f.scaling ? 1.f / static_cast<float>(f.L + 1) : 1.f;

  // the planes' taps by cp.async; the planes' interiors into buffer 0, their
  // first loads in flight while both buffers are zeroed (the ring, the gaps
  // and the rows past the last plane stay so), four floats a store
  {
    // tap i of the block's planes (contiguous in taps) as (plane, j), stepped
    // by kThreads in mixed radix
    const int n = np * f.n_taps, sp = kThreads / f.n_taps, sj = kThreads - sp * f.n_taps;
    int p = tid / f.n_taps, j = tid - p * f.n_taps;
    const float* src = taps + static_cast<long long>(c0) * f.n_taps;
    for (int i = tid; i < n; i += kThreads) {
      cp_async4(s_taps + p * f.tap_pitch + j, src + i);
      j += sj;
      p += sp;
      if (j >= f.n_taps) {
        j -= f.n_taps;
        ++p;
      }
    }
  }
  const T* const plane0 = ctx + b * f.ctx_sb + static_cast<long long>(c0) * f.ctx_sc;
  auto zero = [&]() {
    const int n = 2 * f.cols * Pt;
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < n / 4; i += kThreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = n / 4 * 4 + tid; i < n; i += kThreads) smem[i] = 0.f;
    __syncthreads();
  };
  if (((f.W | WW | wx0 | f.ctx_sb | f.ctx_sc) & 3) == 0 &&
      reinterpret_cast<uintptr_t>(plane0) % (4 * sizeof(T)) == 0)
    load_planes<4>(buf0 + ring * Pt + gap, prow, Pt, plane0, f.ctx_sc, f.W, wy0, wx0, np, WH, WW,
                   tid, zero);
  else
    load_planes<1>(buf0 + ring * Pt + gap, prow, Pt, plane0, f.ctx_sc, f.W, wy0, wx0, np, WH, WW,
                   tid, zero);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // slot i of this thread, q = tid + i * kThreads: plane p, rows y0 .. y0 +
  // S - 1 and column x of the window
  auto slot = [&](int q, int& p, int& y0, int& x) {
    p = q / per_plane;
    const int rem = q - p * per_plane, j = rem / WW;
    y0 = j * S;
    x = rem - j * WW;
  };
  // the gated sum of this thread's slots, and (last level) their sums of
  // ctx_L over the tile
  float g0[S], g1[S], g2[S];
  float ps[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < S; ++s) g0[s] = g1[s] = g2[s] = 0.f;
  auto add = [](float (&g)[S], const float (&v)[S]) {
#pragma unroll
    for (int s = 0; s < S; ++s) g[s] += v[s];
  };

  float* in = buf0;
  float* nxt = buf1;
  for (int l = 0; l < f.L; ++l) {
    const int k = f.k[l], r = k >> 1, rc = f.rcum[l];
    const bool last = l == f.L - 1;
    // where this level is right: the window less the radii so far on sides
    // that lie inside the image
    const int ylo = top ? rc : 0, yhi = bottom ? WH - rc : WH;
    const int xlo = left ? rc : 0, xhi = right ? WW - rc : WW;
    const T* gl = gates + b * f.gate_sb + static_cast<long long>(l) * f.gate_sl;
#pragma unroll 1
    for (int i = 0; i < NS; ++i) {
      const int q = tid + i * kThreads;
      if (q >= n_slots) break;
      int p, y0, x;
      slot(q, p, y0, x);
      if (x < xlo || x >= xhi || y0 >= yhi || y0 + S <= ylo) continue;
      const int row0 = gap + p * prow + y0;   // buffer row of the slot's first output
      const int col = ring + x;                // and its column
      const float* w = s_taps + p * f.tap_pitch + f.tap_off[l];
      // the gates ahead of the conv (f32 at three slots a thread has no
      // registers left for them: after it)
      constexpr bool kEarly = sizeof(T) == 2 || NS < 3;
      const T* gp = gl + static_cast<long long>(wy0 + y0) * f.W + wx0 + x;
      Gates<T> gv;
      if (kEarly) gv.load(gp, f.W, WH - y0);
      float o[S];
      if (vec) {
        const float* c = in + (col - r) * Pt + row0 - 4;
        switch (k) {
          case 1: conv4<1>(c, Pt, w, o); break;
          case 3: conv4<3>(c, Pt, w, o); break;
          case 5: conv4<5>(c, Pt, w, o); break;
          case 7: conv4<7>(c, Pt, w, o); break;
          default: conv4<9>(c, Pt, w, o); break;
        }
      } else {
        conv_any(in + (col - r) * Pt + row0 - r, Pt, w, k, o);
      }
      if (!kEarly) gv.load(gp, f.W, WH - y0);
#pragma unroll
      for (int s = 0; s < S; ++s) o[s] = gelu(o[s], f.erf_gelu);
      // the level's output: 16-byte stores of the window's rows (the zero
      // gap below the plane stays; the strip's rows outside this level's
      // valid rows are never read by a valid output); else row by row
      float* dst = nxt + col * Pt + row0;
      if (vec) {
#pragma unroll
        for (int c4 = 0; c4 < S / 4; ++c4)
          if (y0 + 4 * c4 < WH)
            *reinterpret_cast<float4*>(dst + 4 * c4) =
                make_float4(o[4 * c4], o[4 * c4 + 1], o[4 * c4 + 2], o[4 * c4 + 3]);
      }
      const bool in_cols = x >= tx_w && x < tx_w + tw;
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int y = y0 + s;
        const float a = o[s];
        o[s] = 0.f;
        if (y >= ylo && y < yhi) {
          if (!vec) dst[s] = a;
          o[s] = a * gv.get(s);
          if (last && in_cols && y >= ty_w && y < ty_w + th) sum += a;
        }
      }
      if (NS == 1 || i == 0) {
        add(g0, o);
        ps[0] = sum;
      } else if (NS == 2 || i == 1) {
        add(g1, o);
        ps[1] = sum;
      } else {
        add(g2, o);
        ps[2] = sum;
      }
    }
    __syncthreads();
    float* t = in;
    in = nxt;
    nxt = t;
  }

  // the output gates of the first slot, loaded ahead of the reduction
  Gates<T> gv0;
  const T* gL = gates + b * f.gate_sb + static_cast<long long>(f.L) * f.gate_sl;
  if (f.one_pass && tid < n_slots) {
    int p, y0, x;
    slot(tid, p, y0, x);
    gv0.load(gL + static_cast<long long>(y0) * f.W + x, f.W, WH - y0);
  }
  // ctx_L summed over each plane's tile in a fixed order: the slots' sums
  // (in the free buffer, slot order), a plane to every wpp warps, then (by
  // each reader) their sums in order
  float* const slot_sum = nxt;
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (tid + i * kThreads < n_slots) slot_sum[tid + i * kThreads] = ps[i];
  __syncthreads();
  const int wpp = np < kWarps ? kWarps / np : 1;   // warps a plane
  for (int p = warp / wpp; p < np && warp < wpp * (kWarps / wpp); p += kWarps / wpp) {
    const int w = warp - (warp / wpp) * wpp;
    float s = 0.f;
    for (int i = w * 32 + lane; i < per_plane; i += 32 * wpp) s += slot_sum[p * per_plane + i];
    s = warp_sum(s);
    if (lane == 0) s_red[p * kWarps + w] = s;
  }
  __syncthreads();
  auto plane_sum = [&](int p) {
    float s = 0.f;
    for (int w = 0; w < wpp; ++w) s += s_red[p * kWarps + w];
    return s;
  };
  if (!f.one_pass && tid == 0) partial[(b * f.C + c0) * f.n_tiles + tile] = plane_sum(0);

  // one-pass: out = (acc + gelu(mean) * gate_L) [* 1 / (L + 1)], rounded once;
  // tiled: the tile's acc to the scratch
#pragma unroll 1
  for (int i = 0; i < NS; ++i) {
    const int q = tid + i * kThreads;
    if (q >= n_slots) break;
    int p, y0, x;
    slot(q, p, y0, x);
    auto emit = [&](const float (&g)[S]) {
      if (f.one_pass) {
        const float gm = gelu(plane_sum(p) * (1.f / static_cast<float>(HW)), f.erf_gelu);
        const long long pix = static_cast<long long>(y0) * f.W + x;
        T* const dst = out + (b * f.C + c0 + p) * HW + pix;
        Gates<T> gv = gv0;
        if (i > 0) gv.load(gL + pix, f.W, WH - y0);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (y0 + s < WH) {
            store(dst + s * f.W, (g[s] + gm * gv.get(s)) * scale);
          }
        }
      } else if (x >= tx_w && x < tx_w + tw) {
        float* a = acc_out + (b * f.C + c0) * HW + static_cast<long long>(wy0 + y0) * f.W + wx0 + x;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (y0 + s >= ty_w && y0 + s < ty_w + th) a[s * f.W] = g[s];
      }
    };
    if (NS == 1 || i == 0) emit(g0);
    else if (NS == 2 || i == 1) emit(g1);
    else emit(g2);
  }
}

// the tiled path's second pass, grid (ceil(HW / 256), C, B):
// out = (acc + gelu(sum of the tiles' sums / HW) * gate_L) [* 1 / (L + 1)]
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
focal_finish_kernel(const float* __restrict__ acc, const float* __restrict__ partial,
                    const T* __restrict__ gates, T* __restrict__ out, Focal f) {
  const long long HW = static_cast<long long>(f.H) * f.W;
  const int c = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = (b * f.C + c) * HW;
  const float* pp = partial + (b * f.C + c) * static_cast<long long>(f.n_tiles);
  float s = 0.f;
  for (int i = 0; i < f.n_tiles; ++i) s += pp[i];
  const float g = gelu(s / static_cast<float>(HW), f.erf_gelu);
  const long long p = static_cast<long long>(blockIdx.x) * kFinishThreads + threadIdx.x;
  if (p >= HW) return;
  const float v = acc[plane + p] + g * to_f(gates[b * f.gate_sb + f.L * f.gate_sl + p]);
  store(out + plane + p, f.scaling ? v * (1.f / static_cast<float>(f.L + 1)) : v);
}

template <typename T, int NS>
int launch_ns(const void* ctx, const void* gates, const float* taps, void* out, float* acc,
              float* partial, const Focal& f, int B, size_t smem, cudaStream_t stream) {
  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        focal_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr = true;
  }
  const dim3 grid = f.one_pass ? dim3((f.C + f.planes - 1) / f.planes, 1, B)
                               : dim3(f.n_tiles, f.C, B);
  focal_kernel<T, NS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(gates), taps, static_cast<T*>(out), acc,
      partial, f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || f.one_pass) return static_cast<int>(e);
  const long long HW = static_cast<long long>(f.H) * f.W;
  focal_finish_kernel<T><<<dim3(static_cast<unsigned>((HW + kFinishThreads - 1) / kFinishThreads),
                                f.C, B),
                           kFinishThreads, 0, stream>>>(acc, partial, static_cast<const T*>(gates),
                                                        static_cast<T*>(out), f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* ctx, const void* gates, const float* taps, void* out, float* acc,
           float* partial, const Focal& f, int B, int ns, size_t smem, cudaStream_t stream) {
  if (ns == 1) return launch_ns<T, 1>(ctx, gates, taps, out, acc, partial, f, B, smem, stream);
  if (ns == 2) return launch_ns<T, 2>(ctx, gates, taps, out, acc, partial, f, B, smem, stream);
  return launch_ns<T, 3>(ctx, gates, taps, out, acc, partial, f, B, smem, stream);
}

}  // namespace

// ctx [B, C, H*W] (strides ctx_sb, ctx_sc; pixels contiguous); gates
// [B, L+1, H*W] (strides gate_sb, gate_sl); taps f32 [C, sum k^2]
// contiguous; out [B, C, H*W] contiguous in ctx's dtype.  The plan (from
// ops/focal.focal_plan): planes a block, the tile (tile_h >= H and tile_w >=
// W: one pass over whole planes; else tiles of one plane, planes = 1, and
// acc f32 [B, C, H*W] and partial f32 [B, C, tiles] scratch), the buffer's
// gap rows and row pitch, slots a thread.  A plan that breaks the kernel's
// limits (shared memory, slots, ring) is refused: cudaErrorInvalidValue.
extern "C" int cullavo_focal_ctx(const void* ctx, const void* gates, const void* taps,
                                 void* acc, void* partial, void* out, const void* ks_host,
                                 int L, int B, int C, int H, int W, long long ctx_sb,
                                 long long ctx_sc, long long gate_sb, long long gate_sl,
                                 int scaling, int erf_gelu, int is_bf16, int planes, int tile_h,
                                 int tile_w, int gap, int pitch, int ns, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (L < 1 || L > kMaxLevels || B < 1 || C < 1 || H < 1 || W < 1 || planes < 1 || ns < 1 ||
      ns > kMaxSlots || tile_h < 1 || tile_w < 1)
    return bad;
  const int* ks = static_cast<const int*>(ks_host);
  Focal f;
  f.L = L;
  f.n_taps = 0;
  f.ring = 0;
  f.halo = 0;
  for (int l = 0; l < L; ++l) {
    if (ks[l] < 1 || ks[l] % 2 == 0) return bad;
    f.k[l] = ks[l];
    f.tap_off[l] = f.n_taps;
    f.n_taps += ks[l] * ks[l];
    f.halo += ks[l] / 2;
    f.rcum[l] = f.halo;
    f.ring = ks[l] / 2 > f.ring ? ks[l] / 2 : f.ring;
  }
  // a plane's taps: a multiple of 16 floats, an odd one, so that two planes'
  // taps sit 16 banks apart
  f.tap_pitch = (f.n_taps + 15) / 16 * 16;
  if (f.tap_pitch % 32 == 0) f.tap_pitch += 16;
  f.H = H;
  f.W = W;
  f.C = C;
  f.one_pass = tile_h >= H && tile_w >= W;
  f.tile_h = f.one_pass ? H : (tile_h < H ? tile_h : H);
  f.tile_w = f.one_pass ? W : (tile_w < W ? tile_w : W);
  if (!f.one_pass && (planes != 1 || acc == nullptr || partial == nullptr)) return bad;
  f.planes = planes;
  f.tiles_x = (W + f.tile_w - 1) / f.tile_w;
  f.n_tiles = f.tiles_x * ((H + f.tile_h - 1) / f.tile_h);
  const int wh = f.tile_h + 2 * f.halo < H ? f.tile_h + 2 * f.halo : H;   // the widest window
  const int ww = f.tile_w + 2 * f.halo < W ? f.tile_w + 2 * f.halo : W;
  const int ngw = (wh + S - 1) / S;
  // a column: the planes and their gaps, the last plane's overhang to whole
  // row groups, and the 16-byte strips' overreach of 4 rows
  if (gap < f.ring || pitch < gap + planes * (wh + gap) + ngw * S - wh + 4 ||
      static_cast<long long>(planes) * ngw * ww > static_cast<long long>(kThreads) * ns)
    return bad;
  f.gap = gap;
  f.pitch = pitch;
  f.cols = ww + 2 * f.ring;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(f.cols) * pitch +
                                       static_cast<size_t>(planes) * (f.tap_pitch + kWarps));
  if (smem > static_cast<size_t>(kSmemLimit) || (!f.one_pass && C > 65535) || B > 65535)
    return bad;
  f.ctx_sb = ctx_sb;
  f.ctx_sc = ctx_sc;
  f.gate_sb = gate_sb;
  f.gate_sl = gate_sl;
  f.erf_gelu = erf_gelu;
  f.scaling = scaling;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(taps);
  float* ac = static_cast<float*>(acc);
  float* pa = static_cast<float*>(partial);
  if (is_bf16) return launch<__nv_bfloat16>(ctx, gates, tp, out, ac, pa, f, B, ns, smem, s);
  return launch<float>(ctx, gates, tp, out, ac, pa, f, B, ns, smem, s);
}

// W-window decode attention over the stacked S-major int8 KV cache with bf16
// scale planes: the cache part of the stale-cache decode step (kernel K5).
// K4, the bf16 cache's form, is csrc/wwin_decode_sm90.cu; K5 moves onto that
// body once it stages codes and scale planes.
//
// Replaces: cullavo_tpu/ops/wwin_decode.py, _run_cache_part_q8 ->
// _cache_kernel_q8.  For layer li, batch row b and kv head g, the R = n_rep *
// W query rows that share the kv head (row r is head g * n_rep + r / W,
// window position r % W) attend over all S cache slots:
//     s[r, j]  = (q[r] . codes_k[li, j, b, g]) * (k_s[li, j, b, g] * scale)
//                + bias[b, r % W, j]
//     m[r]     = max_j s[r, j]            (floor: the mask value NEG_INF)
//     p[r, j]  = s[r, j] > NEG_INF / 2 ? exp(s[r, j] - m[r]) : 0
//     l[r]     = sum_j p[r, j]
//     acc[r]   = sum_j bf16(p[r, j] * v_s[li, j, b, g]) codes_v[li, j, b, g]
// and the kernel returns the UNNORMALISED acc with m and l; the caller merges
// them with the W x W intra-window part and divides.  A masked slot is gated
// to p = 0 (a wholly masked row would otherwise see exp(NEG_INF - NEG_INF)
// = 1 per slot) and comes back as m = NEG_INF, l = 0, acc = 0.
//
// Bound on the H100: bytes.  One launch reads layer li's codes and planes
// once (44 MB of int8 at S = 768, B = 14, KV = 32) for ~4 * B * KV * R * S *
// 128 operations, far below the card's 295 operations per byte.  The cache
// is read in place through the layer index and its strides (no per-layer
// slice, no copy, no f32 staging), every byte is fetched once per block with
// 16-byte loads, and scores and probabilities never leave the SM.
// One block of 4 warps per (16-row query tile, kv head, batch row); a tile
// of 64 slots is staged in padded shared memory (int8 codes are widened to
// bf16 on the way, exactly), each warp takes 16 of the 64 slots and keeps its
// own online-softmax state (m, l, f32 accumulator in mma fragments), and the
// four states are merged through shared memory at the end.  S . K^T and
// P . V run as mma.sync m16n8k16 bf16 -> f32.  The ragged end of S is
// bounds-checked (any S >= 1).  No split over S, no TMA/wgmma and no
// load/compute overlap inside a block yet.  Launches on the caller's stream
// and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // head dim
constexpr int ROWS = 16;     // query rows per block (one mma M tile)
constexpr int BKV = 64;      // cache slots per tile (4 warps x 16)
constexpr int LDS = D + 8;   // padded shared-memory row stride (bf16 elements)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// the port's NEG_INF: -0.7 * FLT_MAX, rounded once from double as torch rounds it
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kValidFloor = 0.5f * kNegInf;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four int8 codes (one 32-bit word, lowest byte first) -> four bf16, exact
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const float f0 = static_cast<float>(static_cast<int>(static_cast<int8_t>(w & 0xffu)));
  const float f1 = static_cast<float>(static_cast<int>(static_cast<int8_t>((w >> 8) & 0xffu)));
  const float f2 = static_cast<float>(static_cast<int>(static_cast<int8_t>((w >> 16) & 0xffu)));
  const float f3 = static_cast<float>(static_cast<int>(static_cast<int8_t>(w >> 24)));
  lo = pack_bf16(f0, f1);
  hi = pack_bf16(f2, f3);
}

// Stage cache slots [slot0, slot0 + BKV) of one (layer, batch row, kv head)
// into shared memory as bf16 rows of LDS elements (int8 codes widened
// exactly); slots past S load as zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const void* base,
                                          long long stride_s, int slot0, int S) {
  const int8_t* src = static_cast<const int8_t*>(base);
#pragma unroll
  for (int i = 0; i < (BKV * D / 16) / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c >> 3, col = (c & 7) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (slot0 + r < S)
      raw = *reinterpret_cast<const uint4*>(src + (slot0 + r) * stride_s + col);
    uint4 a, b;
    widen4(raw.x, a.x, a.y);
    widen4(raw.y, a.z, a.w);
    widen4(raw.z, b.x, b.y);
    widen4(raw.w, b.z, b.w);
    *reinterpret_cast<uint4*>(dst + r * LDS + col) = a;
    *reinterpret_cast<uint4*>(dst + r * LDS + col + 8) = b;
  }
}

__global__ void __launch_bounds__(THREADS)
wwin_decode_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ kc, const void* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ ksc,
                   const __nv_bfloat16* __restrict__ vsc,
                   const float* __restrict__ bias, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int li, int n_rep, int W, int S,
                   long long q_sb, long long q_sh, long long q_sw,
                   long long c_sl, long long c_ss, long long c_sb, long long c_sg,
                   long long p_sl, long long p_ss, long long p_sb, long long p_sg,
                   long long b_sb, long long b_sw, float scale) {
  // k and v tiles; reused as the merge buffer once the slot loop is over
  __shared__ __align__(16) unsigned char smem[2 * BKV * LDS * sizeof(__nv_bfloat16)];
  __shared__ float ks_scale[BKV];   // k_s * scale per slot of the tile
  __shared__ float vs_scale[BKV];   // v_s per slot of the tile
  static_assert(sizeof(smem) >= (WARPS * ROWS * D + 2 * WARPS * ROWS) * sizeof(float),
                "merge buffer must fit in the tile buffers");
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BKV * LDS;

  const int rt = blockIdx.x, gh = blockIdx.y, b = blockIdx.z;
  const int KV = gridDim.y;
  const int R = n_rep * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // this thread's two query rows of the tile
  const int r0 = rt * ROWS + g, r1 = r0 + 8;
  const bool ok0 = r0 < R, ok1 = r1 < R;
  const int w0 = ok0 ? r0 % W : 0, w1 = ok1 ? r1 % W : 0;
  const __nv_bfloat16* q0 = q + b * q_sb + (gh * n_rep + (ok0 ? r0 / W : 0)) * q_sh + w0 * q_sw;
  const __nv_bfloat16* q1 = q + b * q_sb + (gh * n_rep + (ok1 ? r1 / W : 0)) * q_sh + w1 * q_sw;
  const float* bias0 = bias + b * b_sb + w0 * b_sw;
  const float* bias1 = bias + b * b_sb + w1 * b_sw;

  // Q as A fragments (16 x 128 = 8 chunks of 16 along d); rows past R are zero
  uint32_t qf[8][4];
#pragma unroll
  for (int kc8 = 0; kc8 < 8; ++kc8) {
    const int c = kc8 * 16 + 2 * t4;
    qf[kc8][0] = ok0 ? ld32(q0 + c) : 0u;
    qf[kc8][1] = ok1 ? ld32(q1 + c) : 0u;
    qf[kc8][2] = ok0 ? ld32(q0 + c + 8) : 0u;
    qf[kc8][3] = ok1 ? ld32(q1 + c + 8) : 0u;
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int8_t* kbase = static_cast<const int8_t*>(kc) + li * c_sl + b * c_sb + gh * c_sg;
  const int8_t* vbase = static_cast<const int8_t*>(vc) + li * c_sl + b * c_sb + gh * c_sg;
  const long long pbase = li * p_sl + b * p_sb + gh * p_sg;

  for (int slot0 = 0; slot0 < S; slot0 += BKV) {
    __syncthreads();  // the previous tile's shared-memory reads are done
    load_tile(ks, kbase, c_ss, slot0, S);
    load_tile(vs, vbase, c_ss, slot0, S);
    {
      const int j = threadIdx.x & (BKV - 1);
      const bool in = slot0 + j < S;
      if (threadIdx.x < BKV)
        ks_scale[j] = in ? __bfloat162float(ksc[pbase + (slot0 + j) * p_ss]) * scale : 0.f;
      else
        vs_scale[j] = in ? __bfloat162float(vsc[pbase + (slot0 + j) * p_ss]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 slots of the tile (2 n-tiles of 8)
    const int wj = warp * 16;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = ks + (wj + nt * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int kc8 = 0; kc8 < 8; ++kc8)
        mma_bf16(s[nt], qf[kc8], ld32(kr + kc8 * 16), ld32(kr + kc8 * 16 + 8));
    }

    // per-slot key scale (folded with scale), bias, row max
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = wj + nt * 8 + 2 * t4 + (e & 1);
        const int slot = slot0 + j;
        const bool ok = (e < 2 ? ok0 : ok1) && slot < S;
        float val = kNegInf;
        if (ok) {
          val = s[nt][e] * ks_scale[j] + (e < 2 ? bias0 : bias1)[slot];
        }
        s[nt][e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m) gated to 0 on masked slots (f32 row sums); the PV A
    // operand is bf16(P * v_s)
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = s[nt][e] > kValidFloor ? expf(s[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
      ls0 += p[0] + p[1];
      ls1 += p[2] + p[3];
      {
        const int j = wj + nt * 8 + 2 * t4;
        const float v0 = vs_scale[j], v1 = vs_scale[j + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      pa[nt * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, off);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, off);
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // acc += P V over the warp's 16 slots: V fragments via ldmatrix.trans,
    // two 8-column d tiles per load
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int dt = 0; dt < 16; dt += 2) {
      const __nv_bfloat16* p =
          vs + (wj + (mat & 1) * 8 + mrow) * LDS + dt * 8 + (mat >> 1) * 8;
      const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
      uint32_t b0, b1, b2, b3;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
          : "r"(addr));
      mma_bf16(acc[dt], pa, b0, b1);
      mma_bf16(acc[dt + 1], pa, b2, b3);
    }
  }

  // merge the four warps' partial softmax states through shared memory
  __syncthreads();  // every warp is done with the k/v tiles
  float* macc = reinterpret_cast<float*>(smem);   // [WARPS][ROWS][D]
  float* mm = macc + WARPS * ROWS * D;            // [WARPS][ROWS]
  float* ml = mm + WARPS * ROWS;                  // [WARPS][ROWS]
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int c = dt * 8 + 2 * t4;
    float* a0 = macc + (warp * ROWS + g) * D + c;
    float* a1 = macc + (warp * ROWS + g + 8) * D + c;
    a0[0] = acc[dt][0];
    a0[1] = acc[dt][1];
    a1[0] = acc[dt][2];
    a1[1] = acc[dt][3];
  }
  if (t4 == 0) {
    mm[warp * ROWS + g] = m0;
    mm[warp * ROWS + g + 8] = m1;
    ml[warp * ROWS + g] = l0;
    ml[warp * ROWS + g + 8] = l1;
  }
  __syncthreads();

  // thread t owns column t of every row of the tile
  const long long out_row0 = (static_cast<long long>(b) * KV + gh) * R + rt * ROWS;
  for (int row = 0; row < ROWS && rt * ROWS + row < R; ++row) {
    float mt = mm[row];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, mm[w * ROWS + row]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(mm[w * ROWS + row] - mt);
      a += macc[(w * ROWS + row) * D + threadIdx.x] * c;
      lsum += ml[w * ROWS + row] * c;
    }
    acc_out[(out_row0 + row) * D + threadIdx.x] = a;
    if (threadIdx.x == 0) {
      m_out[out_row0 + row] = mt;
      l_out[out_row0 + row] = lsum;
    }
  }
}

int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* bias, void* acc, void* m, void* l,
           int li, int B, int KV, int n_rep, int W, int S, int d,
           long long q_sb, long long q_sh, long long q_sw,
           long long c_sl, long long c_ss, long long c_sb, long long c_sg,
           long long p_sl, long long p_ss, long long p_sb, long long p_sg,
           long long b_sb, long long b_sw, float scale, void* stream) {
  if (d != D || B < 1 || KV < 1 || n_rep < 1 || W < 1 || S < 1 || KV > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rep * W + ROWS - 1) / ROWS, KV, B);
  wwin_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), kc, vc,
      static_cast<const __nv_bfloat16*>(ksc), static_cast<const __nv_bfloat16*>(vsc),
      static_cast<const float*>(bias), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), li, n_rep, W, S,
      q_sb, q_sh, q_sw, c_sl, c_ss, c_sb, c_sg, p_sl, p_ss, p_sb, p_sg,
      b_sb, b_sw, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: int8 codes kc/vc [L, S, B, KV, 128] and bf16 scale planes ksc/vsc
// [L, S, B, KV] (strides p_*).
extern "C" int cullavo_wwin_decode_q8(
    const void* q, const void* kc, const void* vc, const void* ksc,
    const void* vsc, const void* bias, void* acc, void* m, void* l, int li,
    int B, int KV, int n_rep, int W, int S, int d,
    long long q_sb, long long q_sh, long long q_sw,
    long long c_sl, long long c_ss, long long c_sb, long long c_sg,
    long long p_sl, long long p_ss, long long p_sb, long long p_sg,
    long long b_sb, long long b_sw, float scale, void* stream) {
  return launch(q, kc, vc, ksc, vsc, bias, acc, m, l, li, B, KV, n_rep, W, S, d, q_sb, q_sh,
                q_sw, c_sl, c_ss, c_sb, c_sg, p_sl, p_ss, p_sb, p_sg, b_sb, b_sw, scale, stream);
}

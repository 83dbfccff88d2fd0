// W-window decode attention over the stacked S-major KV cache: the cache
// part of the stale-cache decode step, over a bf16 cache (kernel K4) or an
// int8 cache with bf16 per-slot scale planes (kernel K5).
//
// Replaces: cullavo_tpu/ops/wwin_decode.py, _run_cache_part -> _cache_kernel
// (K4) and _cache_kernel_q8 (K5).  For layer li, batch row b and kv head g,
// the R = n_rep * W query rows that share the kv head (row r is head g *
// n_rep + r / W, window position r % W) attend over all S cache slots:
//     K4: s[r, j] = (q[r] . k[li, j, b, g]) * scale + bias[b, r % W, j]
//     K5: s[r, j] = (q[r] . codes_k[li, j, b, g]) * (k_s[li, j, b, g] * scale)
//                   + bias[b, r % W, j]
//     m[r]     = max_j s[r, j]            (floor: the mask value NEG_INF)
//     p[r, j]  = s[r, j] > NEG_INF / 2 ? exp(s[r, j] - m[r]) : 0
//     l[r]     = sum_j p[r, j]
//     K4: acc[r] = sum_j bf16(p[r, j]) v[li, j, b, g]                  (f32)
//     K5: acc[r] = sum_j bf16(p[r, j] * v_s[li, j, b, g]) codes_v[li, j, b, g]
// and the kernel returns the UNNORMALISED acc with m and l; the caller merges
// them with the W x W intra-window part and divides.  A masked slot is gated
// to p = 0 (a wholly masked row would otherwise see exp(NEG_INF - NEG_INF)
// = 1 per slot) and comes back as m = NEG_INF, l = 0, acc = 0.
//
// Bound on the H100: bytes.  One launch reads layer li's k and v once
// (2 * S * B * KV * 128 values; 88 MB of bf16 at S = 768, B = 14, KV = 32;
// K5 half of it, plus 4 bytes of scales a slot) for ~4 * B * KV * R * S * 128
// operations, far below the card's 295 operations per byte.  The cache is
// read in place through the layer index and its strides (no per-layer slice,
// no copy).  A block walks all S slots of its (b, g): the greedy step's 448
// (b, g) blocks fill the card alone.  (The suffix prefills' 128 blocks
// measured faster with S split in two and the parts folded by a second pass;
// they run over the bf16 cache, which the serving engine does not decode
// from.)  Two bodies, by R, each over either cache:
//   * R = 1 (the greedy step): decode_rows.cuh's lane-group body in its
//     kWindow mode, the body of K12: a slot row (256 bytes of bf16, 128 of
//     int8) is a group of lanes x 16 bytes, each lane dots its 8 (16) values
//     with q held in registers and shuffles the sum, so the step computes
//     the products it needs and no more; per-warp cp.async rings keep two
//     stages of slots in flight, K5's two scales riding along with its codes.
//   * R > 1 (the speculative windows, the serving engine's suffix prefills,
//     W up to 128): wwin_mma_kernel, mma.sync m16n8k16 bf16 -> f32 on
//     16-row tiles.  A block of four warps holds WR row tiles (16 * WR
//     rows) and splits each 64-slot stage among WS = 4 / WR warps, so a wide
//     window reads each slot once per 64 rows (not once per 16), and a
//     narrow one still has four warps on its slots.  The 64-slot k/v stages
//     come through a ring of NST cp.async stages shared by the block: one
//     __syncthreads per stage, NST - 1 stages in flight.  Each warp keeps its
//     own online-softmax state, merged through shared memory at the end.
//     (At R = 4 the tile computes 4x the products it needs; the tensor cores
//     make that cheaper than the lane-group body's four rows of shuffles,
//     which measured slower.)
//     - K4: padded bf16 rows, ldmatrix.trans for V; 3 stages.
//     - K5: the stage holds int8 codes (8 KB of k or v, rows padded to 144
//       bytes) and each tile's 64 k-scales and 64 v-scales (the bf16 planes
//       are strided by B * KV: each is fetched as the aligned 4-byte word
//       that holds it), so 4 stages fit where K4 has 3.  Codes widen to
//       bf16 exactly (a byte permute into the mantissa of 2^23, one
//       subtraction, the high half).  With one row tile (the speculative
//       windows) they widen as the mma fragments are built: the head dim of
//       Q K^T is taken in a permuted order, the same for q and k, so a
//       thread's k fragments are 32 contiguous bytes (two 16-byte loads); V
//       goes through ldmatrix.trans, its 16-bit elements being pairs of
//       columns, so a load gives each thread two columns' fragments and the
//       output's columns come in a permuted order that the merge undoes.
//       With several row tiles (the suffix prefills) every warp would widen
//       the same codes, so the block widens each stage once into bf16 rows
//       (one more barrier a stage) and runs K4's fragment code on them.  The
//       scores take k_s * scale per slot, the probabilities v_s before
//       their bf16 rounding.  On an H100 80GB HBM3 at 700 W (flash_bench.py,
//       card alone): W = 4, S = 768, B = 14 0.078 ms against K4's 0.088 on
//       the bf16 cache; W = 1 0.059 against 0.069-0.077.
// Launches on the caller's stream and allocates nothing.

#include "decode_rows.cuh"

namespace {

using decode_rows::Params;
using decode_rows::cp_async16;
using decode_rows::cp_async4;
using decode_rows::cp_async_commit;
using decode_rows::cp_async_wait;
using decode_rows::half_at;
using decode_rows::hi_pair;
using decode_rows::i8x4_bits;
using decode_rows::odd_base;
using decode_rows::kNegInf;
using decode_rows::kValidFloor;
using decode_rows::word_of;

constexpr int D = 128;       // head dim
constexpr int MAX_W = 128;   // widest window
constexpr int ROWS = 16;     // query rows per warp (one mma M tile)
constexpr int BKV = 64;      // cache slots per ring stage
constexpr int LDS = D + 8;   // padded shared-memory row stride (bf16 elements)
constexpr int LDQ = D + 16;  // K5: padded row stride (int8 bytes; a multiple of 16)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// ring stages and their bytes: K4 k and v as bf16 rows; K5 k and v codes
// and the tile's k and v scale words
// and of wider K5 blocks (WR > 1), one stage widened to bf16 rows after the ring
template <bool Q8, int WR>
struct Ring {
  static constexpr int NST = Q8 ? 4 : 3;
  static constexpr int STAGE = Q8 ? 2 * BKV * LDQ + 2 * BKV * 4 : 2 * BKV * LDS * 2;
  static constexpr bool WIDEN = Q8 && WR > 1;
  static constexpr int BYTES = NST * STAGE + (WIDEN ? 2 * BKV * LDS * 2 : 0);
  static_assert(NST * STAGE >= (WARPS * ROWS * D + 2 * WARPS * ROWS) * 4,
                "merge buffer must fit in the ring");
};

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

template <int WR, bool kQ8>
__global__ void __launch_bounds__(THREADS) wwin_mma_kernel(const Params p) {
  constexpr int WS = WARPS / WR;   // warps sharing one row tile's slots
  constexpr int NST = Ring<kQ8, WR>::NST;
  constexpr int STAGE = 2 * BKV * LDS;          // K4: k and v, bf16 elements
  constexpr int STAGE8 = Ring<true, WR>::STAGE;  // K5: bytes
  // K5 with several row tiles widens each stage once into bf16 rows that
  // its warps share (each would widen the same codes); one row tile widens
  // its own codes as it builds the fragments
  constexpr bool kWiden = Ring<kQ8, WR>::WIDEN;
  constexpr bool kFrag = kQ8 && !kWiden;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int rb = blockIdx.x, gh = blockIdx.y, b = blockIdx.z;
  const int R = p.n_rep * p.W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / WS, ws = warp - wr * WS;
  const int g = lane >> 2, t4 = lane & 3;

  // this thread's two query rows of its warp's tile
  const int r0 = (rb * WR + wr) * ROWS + g, r1 = r0 + 8;
  const bool ok0 = r0 < R, ok1 = r1 < R;
  const int w0 = ok0 ? r0 % p.W : 0, w1 = ok1 ? r1 % p.W : 0;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* q0 =
      q + b * p.q_sb + (gh * p.n_rep + (ok0 ? r0 / p.W : 0)) * p.q_sh + w0 * p.q_sw;
  const __nv_bfloat16* q1 =
      q + b * p.q_sb + (gh * p.n_rep + (ok1 ? r1 / p.W : 0)) * p.q_sh + w1 * p.q_sw;
  const float* bias0 = p.bias + b * p.b_sb + w0 * p.b_sw;
  const float* bias1 = p.bias + b * p.b_sb + w1 * p.b_sw;

  // Q as A fragments (16 x 128 = 8 chunks of 16 along d); rows past R are
  // zero.  K5 widening in the fragments takes d in a permuted order: column
  // 2 t + e (+ 8 h) of chunk kc8 is d = 32 t + 4 kc8 + 2 h + e, so a
  // thread's k bytes are contiguous.
  uint32_t qf[8][4];
#pragma unroll
  for (int kc8 = 0; kc8 < 8; ++kc8) {
    if constexpr (kFrag) {
      const int c = 32 * t4 + 4 * kc8;
      qf[kc8][0] = ok0 ? ld32(q0 + c) : 0u;
      qf[kc8][1] = ok1 ? ld32(q1 + c) : 0u;
      qf[kc8][2] = ok0 ? ld32(q0 + c + 2) : 0u;
      qf[kc8][3] = ok1 ? ld32(q1 + c + 2) : 0u;
    } else {
      const int c = kc8 * 16 + 2 * t4;
      qf[kc8][0] = ok0 ? ld32(q0 + c) : 0u;
      qf[kc8][1] = ok1 ? ld32(q1 + c) : 0u;
      qf[kc8][2] = ok0 ? ld32(q0 + c + 8) : 0u;
      qf[kc8][3] = ok1 ? ld32(q1 + c + 8) : 0u;
    }
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  using CT = typename std::conditional<kQ8, int8_t, __nv_bfloat16>::type;
  const CT* kb = static_cast<const CT*>(p.k) + b * p.k_sb + gh * p.k_sg;
  const CT* vb = static_cast<const CT*>(p.v) + b * p.v_sb + gh * p.v_sg;
  const __nv_bfloat16* ksb = nullptr;
  const __nv_bfloat16* vsb = nullptr;
  int kodd = 0, vodd = 0, sodd = 0;
  if constexpr (kQ8) {
    ksb = static_cast<const __nv_bfloat16*>(p.ks) + b * p.s_sb + gh * p.s_sg;
    vsb = static_cast<const __nv_bfloat16*>(p.vs) + b * p.s_sb + gh * p.s_sg;
    kodd = odd_base(ksb);
    vodd = odd_base(vsb);
    sodd = static_cast<int>(p.s_ss & 1);
  }
  const int n_st = (p.S + BKV - 1) / BKV;

  // stage t: slots [t * BKV, + BKV) as padded rows (K5: then the k and v
  // scale words of the 64 slots); past S zeros
  auto issue = [&](int t) {
    if (t < n_st) {
      if constexpr (kQ8) {
        int8_t* ks = reinterpret_cast<int8_t*>(smem + (t % NST) * STAGE8);
        int8_t* vs = ks + BKV * LDQ;
#pragma unroll
        for (int i = 0; i < (BKV * D / 16) / THREADS; ++i) {
          const int c = threadIdx.x + i * THREADS;
          const int r = c >> 3, col = (c & 7) * 16;
          const int slot = t * BKV + r;
          const bool in = slot < p.S;
          const long long j = in ? slot : 0;
          cp_async16(ks + r * LDQ + col, kb + j * p.k_ss + col, in);
          cp_async16(vs + r * LDQ + col, vb + j * p.v_ss + col, in);
        }
        // threads 0-63: the k scale of slot t * 64 + tid; 64-127: the v scale
        const int r = threadIdx.x & (BKV - 1), slot = t * BKV + r;
        const bool in = slot < p.S;
        const long long j = in ? slot : 0;
        cp_async4(reinterpret_cast<uint32_t*>(vs + BKV * LDQ) + threadIdx.x,
                  word_of((threadIdx.x < BKV ? ksb : vsb) + j * p.s_ss), in);
      } else {
        __nv_bfloat16* ks = ring + (t % NST) * STAGE;
        __nv_bfloat16* vs = ks + BKV * LDS;
#pragma unroll
        for (int i = 0; i < (BKV * D / 8) / THREADS; ++i) {
          const int c = threadIdx.x + i * THREADS;
          const int r = c >> 4, col = (c & 15) * 8;
          const int slot = t * BKV + r;
          const bool in = slot < p.S;
          const long long j = in ? slot : 0;
          cp_async16(ks + r * LDS + col, kb + j * p.k_ss + col, in);
          cp_async16(vs + r * LDS + col, vb + j * p.v_ss + col, in);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();   // stage t is in for every thread; stage t - 1 is read by all
    issue(t + NST - 1);
    const __nv_bfloat16* ks = ring + (t % NST) * STAGE;
    const __nv_bfloat16* vs = ks + BKV * LDS;
    const unsigned char* stg = smem + (t % NST) * STAGE8;   // K5's stage
    if constexpr (kWiden) {
      // the stage's 128 rows of codes (k, then v) -> bf16 rows of LDS, exactly
      __nv_bfloat16* wk = reinterpret_cast<__nv_bfloat16*>(smem + NST * STAGE8);
#pragma unroll
      for (int i = 0; i < (2 * BKV * D / 16) / THREADS; ++i) {
        const int c = threadIdx.x + i * THREADS;
        const int r = c >> 3, col = (c & 7) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(stg + r * LDQ + col);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t f[4];
          i8x4_bits(w[k], f);
          o[2 * k] = hi_pair(f[0], f[1]);
          o[2 * k + 1] = hi_pair(f[2], f[3]);
        }
        uint4* dst = reinterpret_cast<uint4*>(wk + r * LDS + col);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
      ks = wk;
      vs = wk + BKV * LDS;
    }

    for (int sub = ws; sub < BKV / 16; sub += WS) {
      const int wj = sub * 16;
      if (t * BKV + wj >= p.S) break;
      // S = Q K^T for these 16 slots (2 n-tiles of 8)
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
        if constexpr (kFrag) {
          // slot wj + 8 nt + g: bytes 32 t4 .. + 31 of its row, word kc8 the
          // d values of chunk kc8 (columns 2 t4, 2 t4 + 1 | 2 t4 + 8, + 9)
          const unsigned char* kr = stg + (wj + nt * 8 + g) * LDQ + 32 * t4;
          const uint4 lo = *reinterpret_cast<const uint4*>(kr);
          const uint4 hi = *reinterpret_cast<const uint4*>(kr + 16);
          const uint32_t wd[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int kc8 = 0; kc8 < 8; ++kc8) {
            uint32_t f[4];
            i8x4_bits(wd[kc8], f);
            mma_bf16(s[nt], qf[kc8], hi_pair(f[0], f[1]), hi_pair(f[2], f[3]));
          }
        } else {
          const __nv_bfloat16* kr = ks + (wj + nt * 8 + g) * LDS + 2 * t4;
#pragma unroll
          for (int kc8 = 0; kc8 < 8; ++kc8)
            mma_bf16(s[nt], qf[kc8], ld32(kr + kc8 * 16), ld32(kr + kc8 * 16 + 8));
        }
      }

      // K5: the scales of this thread's slots wj + 8 nt + 2 t4 + {0, 1}
      float ksc[2][2], vsc[2][2];
      if constexpr (kQ8) {
        const uint32_t* sw = reinterpret_cast<const uint32_t*>(stg + 2 * BKV * LDQ);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = wj + nt * 8 + 2 * t4 + e, slot = t * BKV + j;
            ksc[nt][e] = __fmul_rn(half_at(sw[j], kodd ^ (slot & sodd)), p.scale);
            vsc[nt][e] = half_at(sw[BKV + j], vodd ^ (slot & sodd));
          }
      }

      // scale, bias, row max (K5: the scale of slot j is k_s[j] * scale)
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if constexpr (kQ8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int slot = t * BKV + wj + nt * 8 + 2 * t4 + (e & 1);
            const bool ok = (e < 2 ? ok0 : ok1) && slot < p.S;
            s[nt][e] = ok ? s[nt][e] * ksc[nt][e & 1] + (e < 2 ? bias0 : bias1)[slot * p.b_ss]
                          : kNegInf;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int slot = t * BKV + wj + nt * 8 + 2 * t4 + (e & 1);
            const bool ok = (e < 2 ? ok0 : ok1) && slot < p.S;
            s[nt][e] = ok ? s[nt][e] * p.scale + (e < 2 ? bias0 : bias1)[slot * p.b_ss] : kNegInf;
          }
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
      const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // P = exp(S - m) gated to 0 on masked slots (f32 row sums); the PV A
      // operand is bf16(P) (K5: bf16(P * v_s))
      float ls0 = 0.f, ls1 = 0.f;
      uint32_t pa[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pr[e] = s[nt][e] > kValidFloor ? __expf(s[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        ls0 += pr[0] + pr[1];
        ls1 += pr[2] + pr[3];
        if constexpr (kQ8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pr[e] = __fmul_rn(pr[e], vsc[nt][e & 1]);
        }
        pa[nt * 2 + 0] = pack_bf16(pr[0], pr[1]);
        pa[nt * 2 + 1] = pack_bf16(pr[2], pr[3]);
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

      // acc += P V over the 16 slots: V fragments via ldmatrix.trans
      const int mat = lane >> 3, mrow = lane & 7;
      if constexpr (kFrag) {
        // load i: slots wj + 8 (mat & 1) + mrow, bytes 32 i + 16 (mat >> 1);
        // register m holds (slots 2 t4, 2 t4 + 1 [+ 8 for odd m]) x (columns
        // 2g, 2g + 1 of its 16 bytes): n-tile 4 i + q is column d = 32 i +
        // 16 (q >> 1) + 2 (its column) + (q & 1)
        const unsigned char* vq = stg + BKV * LDQ;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned char* vp =
              vq + (wj + (mat & 1) * 8 + mrow) * LDQ + 32 * i + (mat >> 1) * 16;
          uint32_t r[4];
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
              : "r"(decode_rows::smem_u32(vp)));
          uint32_t f[4][4];
#pragma unroll
          for (int m = 0; m < 4; ++m) i8x4_bits(r[m], f[m]);
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int m = 2 * (qq >> 1), e = qq & 1;
            mma_bf16(acc[4 * i + qq], pa, hi_pair(f[m][e], f[m][e + 2]),
                     hi_pair(f[m + 1][e], f[m + 1][e + 2]));
          }
        }
      } else {
        // two 8-column d tiles per load
#pragma unroll
        for (int dt = 0; dt < 16; dt += 2) {
          const __nv_bfloat16* vp =
              vs + (wj + (mat & 1) * 8 + mrow) * LDS + dt * 8 + (mat >> 1) * 8;
          const uint32_t addr = decode_rows::smem_u32(vp);
          uint32_t b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(addr));
          mma_bf16(acc[dt], pa, b0, b1);
          mma_bf16(acc[dt + 1], pa, b2, b3);
        }
      }
    }
  }

  // merge the WS warps of each row tile through shared memory
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring
  float* macc = reinterpret_cast<float*>(smem);   // [WARPS][ROWS][D]
  float* mm = macc + WARPS * ROWS * D;            // [WARPS][ROWS]
  float* ml = mm + WARPS * ROWS;                  // [WARPS][ROWS]
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    if constexpr (kFrag) {
      // entries 0 / 2 at column c, entries 1 / 3 two columns on
      const int c = 32 * (dt >> 2) + 16 * ((dt >> 1) & 1) + 4 * t4 + (dt & 1);
      float* a0 = macc + (warp * ROWS + g) * D + c;
      float* a1 = macc + (warp * ROWS + g + 8) * D + c;
      a0[0] = acc[dt][0];
      a0[2] = acc[dt][1];
      a1[0] = acc[dt][2];
      a1[2] = acc[dt][3];
    } else {
      const int c = dt * 8 + 2 * t4;
      float* a0 = macc + (warp * ROWS + g) * D + c;
      float* a1 = macc + (warp * ROWS + g + 8) * D + c;
      a0[0] = acc[dt][0];
      a0[1] = acc[dt][1];
      a1[0] = acc[dt][2];
      a1[1] = acc[dt][3];
    }
  }
  if (t4 == 0) {
    mm[warp * ROWS + g] = m0;
    mm[warp * ROWS + g + 8] = m1;
    ml[warp * ROWS + g] = l0;
    ml[warp * ROWS + g + 8] = l1;
  }
  __syncthreads();

  const long long row0 = (static_cast<long long>(b) * p.KV + gh) * R;
  // thread t owns column t of every row of the block
  for (int tile = 0; tile < WR; ++tile) {
    for (int row = 0; row < ROWS; ++row) {
      const int r = (rb * WR + tile) * ROWS + row;
      if (r >= R) break;
      const int w_first = tile * WS;
      float mt = mm[w_first * ROWS + row];
#pragma unroll
      for (int w = 1; w < WS; ++w) mt = fmaxf(mt, mm[(w_first + w) * ROWS + row]);
      float a = 0.f, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < WS; ++w) {
        const float c = expf(mm[(w_first + w) * ROWS + row] - mt);
        a += macc[((w_first + w) * ROWS + row) * D + threadIdx.x] * c;
        lsum += ml[(w_first + w) * ROWS + row] * c;
      }
      p.o[(row0 + r) * D + threadIdx.x] = a;
      if (threadIdx.x == 0) {
        p.m[row0 + r] = mt;
        p.l[row0 + r] = lsum;
      }
    }
  }
}

template <int WR, bool kQ8>
int launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int BYTES = Ring<kQ8, WR>::BYTES;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wwin_mma_kernel<WR, kQ8>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const int R = p.n_rep * p.W;
  const dim3 grid((R + WR * ROWS - 1) / (WR * ROWS), p.KV, p.B);
  wwin_mma_kernel<WR, kQ8><<<grid, THREADS, BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the cache type's body by R = n_rep * W
template <typename T>
int launch(const Params& p, cudaStream_t st) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  const int R = p.n_rep * p.W;
  if (R == 1) return decode_rows::launch_rows<T, decode_rows::kWindow>(p, st);
  if (R <= ROWS) return launch_mma<1, kQ8>(p, st);
  if (R <= 2 * ROWS) return launch_mma<2, kQ8>(p, st);
  return launch_mma<4, kQ8>(p, st);
}

Params window_params(const void* q, const void* bias, void* acc, void* m, void* l, int B, int KV,
                     int n_rep, int W, int S, int d, long long q_sb, long long q_sh,
                     long long q_sw, long long c_ss, long long c_sb, long long c_sg,
                     long long b_sb, long long b_sw, float scale) {
  Params p{};
  p.q = q;
  p.bias = static_cast<const float*>(bias);
  p.o = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.B = B;
  p.KV = KV;
  p.n_rep = n_rep;
  p.W = W;
  p.S = S;
  p.d = d;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_sw = q_sw;
  p.k_sb = p.v_sb = c_sb;
  p.k_sg = p.v_sg = c_sg;
  p.k_ss = p.v_ss = c_ss;
  p.b_sb = b_sb;
  p.b_sw = b_sw;
  p.b_ss = 1;
  p.scale = scale;
  return p;
}

bool bad_window(int li, int B, int KV, int n_rep, int W, int S, int d) {
  return d != D || B < 1 || B > 65535 || KV < 1 || KV > 65535 || n_rep < 1 || W < 1 ||
         W > MAX_W || S < 1 || li < 0;
}

}  // namespace

// K4: bf16 cache kc/vc [L, S, B, KV, 128] (strides c_* in elements), q [B,
// H, W, 128] (strides q_*), bias f32 [B, W, S] (strides b_*, unit slot
// stride).  Outputs f32, contiguous: acc [B, H, W, 128], m and l [B, H, W].
extern "C" int cullavo_wwin_decode(
    const void* q, const void* kc, const void* vc, const void* bias, void* acc,
    void* m, void* l, int li, int B, int KV, int n_rep, int W, int S, int d,
    long long q_sb, long long q_sh, long long q_sw,
    long long c_sl, long long c_ss, long long c_sb, long long c_sg,
    long long b_sb, long long b_sw, float scale, void* stream) {
  if (bad_window(li, B, KV, n_rep, W, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = window_params(q, bias, acc, m, l, B, KV, n_rep, W, S, d, q_sb, q_sh, q_sw, c_ss,
                           c_sb, c_sg, b_sb, b_sw, scale);
  p.k = static_cast<const __nv_bfloat16*>(kc) + li * c_sl;
  p.v = static_cast<const __nv_bfloat16*>(vc) + li * c_sl;
  return launch<__nv_bfloat16>(p, static_cast<cudaStream_t>(stream));
}

// K5: int8 codes kc/vc [L, S, B, KV, 128] (strides c_*) and bf16 scale
// planes ksc/vsc [L, S, B, KV] (strides p_*); the rest as K4.
extern "C" int cullavo_wwin_decode_q8(
    const void* q, const void* kc, const void* vc, const void* ksc,
    const void* vsc, const void* bias, void* acc, void* m, void* l, int li,
    int B, int KV, int n_rep, int W, int S, int d,
    long long q_sb, long long q_sh, long long q_sw,
    long long c_sl, long long c_ss, long long c_sb, long long c_sg,
    long long p_sl, long long p_ss, long long p_sb, long long p_sg,
    long long b_sb, long long b_sw, float scale, void* stream) {
  if (bad_window(li, B, KV, n_rep, W, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  Params p = window_params(q, bias, acc, m, l, B, KV, n_rep, W, S, d, q_sb, q_sh, q_sw, c_ss,
                           c_sb, c_sg, b_sb, b_sw, scale);
  p.k = static_cast<const int8_t*>(kc) + li * c_sl;
  p.v = static_cast<const int8_t*>(vc) + li * c_sl;
  p.ks = static_cast<const __nv_bfloat16*>(ksc) + li * p_sl;
  p.vs = static_cast<const __nv_bfloat16*>(vsc) + li * p_sl;
  p.s_sb = p_sb;
  p.s_sg = p_sg;
  p.s_ss = p_ss;
  return launch<int8_t>(p, static_cast<cudaStream_t>(stream));
}

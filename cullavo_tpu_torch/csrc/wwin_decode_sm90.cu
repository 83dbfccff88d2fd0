// W-window decode attention over the stacked S-major bf16 KV cache: the cache
// part of the stale-cache decode step (kernel K4).
//
// Replaces: cullavo_tpu/ops/wwin_decode.py, _run_cache_part -> _cache_kernel.
// For layer li, batch row b and kv head g, the R = n_rep * W query rows that
// share the kv head (row r is head g * n_rep + r / W, window position r % W)
// attend over all S cache slots:
//     s[r, j]  = (q[r] . k[li, j, b, g]) * scale + bias[b, r % W, j]
//     m[r]     = max_j s[r, j]            (floor: the mask value NEG_INF)
//     p[r, j]  = s[r, j] > NEG_INF / 2 ? exp(s[r, j] - m[r]) : 0
//     l[r]     = sum_j p[r, j]
//     acc[r]   = sum_j bf16(p[r, j]) v[li, j, b, g]      (f32 accumulation)
// and the kernel returns the UNNORMALISED acc with m and l; the caller merges
// them with the W x W intra-window part and divides.  A masked slot is gated
// to p = 0 (a wholly masked row would otherwise see exp(NEG_INF - NEG_INF)
// = 1 per slot) and comes back as m = NEG_INF, l = 0, acc = 0.
//
// Bound on the H100: bytes.  One launch reads layer li's k and v once
// (2 * S * B * KV * 128 values; 88 MB of bf16 at S = 768, B = 14, KV = 32)
// for ~4 * B * KV * R * S * 128 operations, far below the card's 295
// operations per byte.  The cache is read in place through the layer index
// and its strides (no per-layer slice, no copy).  A block walks all S slots
// of its (b, g): the greedy step's 448 (b, g) blocks fill the card alone.
// (The suffix prefills' 128 blocks measured faster with S split in two and
// the parts folded by a second pass; they run over the bf16 cache, which
// the serving engine does not decode from.)  Two bodies, by R:
//   * R = 1 (the greedy step): decode_rows.cuh's lane-group body in its
//     kWindow mode, the body of K12: a 256-byte slot row is 16 lanes x 16
//     bytes, each lane dots its 8 values with q held in registers and
//     shuffles the sum, so the step computes the products it needs and no
//     more; per-warp cp.async rings keep two stages of slots in flight.
//   * R > 1 (the speculative windows, the serving engine's suffix prefills,
//     W up to 128): wwin_mma_kernel, mma.sync m16n8k16 bf16 -> f32 on
//     16-row tiles.  A block of four warps holds WR row tiles (16 * WR
//     rows) and splits each 64-slot stage among WS = 4 / WR warps, so a wide
//     window reads each slot once per 64 rows (not once per 16), and a
//     narrow one still has four warps on its slots.  The 64-slot k/v stages
//     (padded rows, ldmatrix.trans for V) come through a ring of NST
//     cp.async stages shared by the block: one __syncthreads per stage, NST - 1
//     stages in flight.  Each warp keeps its own online-softmax state, merged
//     through shared memory at the end.  (At R = 4 the tile computes 4x the
//     products it needs; the tensor cores make that cheaper than the
//     lane-group body's four rows of shuffles, which measured slower.)
// K5 (the int8 cache with bf16 scale planes, csrc/wwin_decode.cu) can move
// onto wwin_mma_kernel behind an `if constexpr`: its stage load widens the
// codes to bf16 and stages the two scale planes beside each tile, and its
// scores and probabilities take the per-slot scales, the only two places
// the forms differ.  Launches on the caller's stream and allocates nothing.

#include "decode_rows.cuh"

namespace {

using decode_rows::Params;
using decode_rows::cp_async16;
using decode_rows::cp_async_commit;
using decode_rows::cp_async_wait;
using decode_rows::kNegInf;
using decode_rows::kValidFloor;

constexpr int D = 128;       // head dim
constexpr int MAX_W = 128;   // widest window
constexpr int ROWS = 16;     // query rows per warp (one mma M tile)
constexpr int BKV = 64;      // cache slots per ring stage
constexpr int LDS = D + 8;   // padded shared-memory row stride (bf16 elements)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NST = 3;       // ring stages
constexpr int STAGE = 2 * BKV * LDS;                         // k and v, bf16 elements
constexpr int SMEM_BYTES = NST * STAGE * 2;                  // 104,448
static_assert(SMEM_BYTES >= (WARPS * ROWS * D + 2 * WARPS * ROWS) * 4,
              "merge buffer must fit in the ring");

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

template <int WR>
__global__ void __launch_bounds__(THREADS) wwin_mma_kernel(const Params p) {
  constexpr int WS = WARPS / WR;   // warps sharing one row tile's slots
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

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + gh * p.k_sg;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + gh * p.v_sg;
  const int n_st = (p.S + BKV - 1) / BKV;

  // stage t: slots [t * BKV, + BKV) as padded bf16 rows; past S zeros
  auto issue = [&](int t) {
    if (t < n_st) {
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

    for (int sub = ws; sub < BKV / 16; sub += WS) {
      const int wj = sub * 16;
      if (t * BKV + wj >= p.S) break;
      // S = Q K^T for these 16 slots (2 n-tiles of 8)
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

      // scale, bias, row max
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = t * BKV + wj + nt * 8 + 2 * t4 + (e & 1);
          const bool ok = (e < 2 ? ok0 : ok1) && slot < p.S;
          s[nt][e] = ok ? s[nt][e] * p.scale + (e < 2 ? bias0 : bias1)[slot * p.b_ss] : kNegInf;
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
      // operand is bf16(P)
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

      // acc += P V over the 16 slots: V fragments via ldmatrix.trans, two
      // 8-column d tiles per load
      const int mat = lane >> 3, mrow = lane & 7;
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

  // merge the WS warps of each row tile through shared memory
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring
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

template <int WR>
int launch_mma(const Params& p, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        wwin_mma_kernel<WR>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const int R = p.n_rep * p.W;
  const dim3 grid((R + WR * ROWS - 1) / (WR * ROWS), p.KV, p.B);
  wwin_mma_kernel<WR><<<grid, THREADS, SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  if (d != D || B < 1 || B > 65535 || KV < 1 || KV > 65535 || n_rep < 1 || W < 1 ||
      W > MAX_W || S < 1 || li < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = static_cast<const __nv_bfloat16*>(kc) + li * c_sl;
  p.v = static_cast<const __nv_bfloat16*>(vc) + li * c_sl;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = n_rep * W;
  if (R == 1) return decode_rows::launch_rows<__nv_bfloat16, decode_rows::kWindow>(p, st);
  if (R <= ROWS) return launch_mma<1>(p, st);
  if (R <= 2 * ROWS) return launch_mma<2>(p, st);
  return launch_mma<4>(p, st);
}

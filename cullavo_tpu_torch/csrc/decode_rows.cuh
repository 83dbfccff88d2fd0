// One-token decode attention over the heads that share one kv head: the
// body of K12 (csrc/flash_decode.cu) and of the one-row forms of K4 and K5
// (csrc/wwin_decode_sm90.cu, the greedy step: W = 1, n_rep = 1).
//
// For batch row b, kv head g and one chunk of that kv head's n_rep query
// heads h = g * n_rep + r, over the S cache slots:
//     s[r, j] = scale * (q[b, h] . k[b, g, j]) + bias[b, h, j]          (f32)
//     m[r]    = max_j s[r, j];  p[r, j] = exp(s[r, j] - m[r]);  l[r] = sum_j p
//     acc[r]  = sum_j p[r, j] v[b, g, j]                               (f32)
// Two modes.  kFlash (K12): a key at -inf counts 0 (a row of such keys gives
// m = -inf, l = 0, acc = 0) and the output is normalised, o = acc / l.
// kWindow (K4): m starts at the mask value NEG_INF, a score at or below
// NEG_INF / 2 is gated to p = 0, acc takes bf16(p) (the probability rounded
// as the PV product's operand) and stays unnormalised.  Over an int8 cache
// (K5: T = int8_t, bf16 queries) with bf16 per-slot scale planes k_s, v_s:
//     s[j] = (q . codes_k[j]) * (k_s[j] * scale) + bias[j]
//     acc  = sum_j bf16(p[j] * v_s[j]) codes_v[j]
// the two scales fetched with the codes, NST - 1 stages ahead.
//
// Bound on the H100: bytes (each k/v slot is read once per block; ~4 d
// operations per slot and row against 2 d or 4 d bytes).  Design:
//   * one block per (b, g) and chunk of heads walks all of S (a split of S
//     across blocks with a combine pass measured slower at the 7B decode
//     shape, whose 448 blocks fill the card, and at KOSMOS-2's 32);
//   * each warp streams its own slots through a private ring of NST stages
//     of cp.async 16-byte copies (zero-filled past S), so NST - 1 stages are
//     in flight while one is computed; no block barrier inside the loop;
//   * a key row is whole in one group of LPK lanes (LPK = the next power of
//     two of d / VEC, VEC elements of 16 bytes per lane), each lane copies
//     and reads only its own 16 bytes, so the ring needs no barrier, and the
//     dot reduces with log2(LPK) shuffles;
//   * bf16 and int8 stay narrow in shared memory and are widened in the
//     dot, an int8 code exactly by a byte permute into the mantissa of 2^23
//     and one subtraction;
//   * each lane group keeps its own online softmax, merged by shuffles
//     within the warp and through shared memory across the four warps, once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace decode_rows {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 2;            // lane-group steps per ring stage
constexpr int MAX_D = 128;
constexpr int kFlash = 0, kWindow = 1;
// the port's NEG_INF: -0.7 * FLT_MAX, rounded once from double as torch rounds it
constexpr float kNegInf = static_cast<float>(-0.7 * 3.4028234663852886e38);
constexpr float kValidFloor = 0.5f * kNegInf;

struct Params {
  const void* q;
  const void* k;              // slot (b, g, j) at k + b * k_sb + g * k_sg + j * k_ss
  const void* v;
  const float* bias;          // (b, h, w, j) at bias + b * b_sb + h * b_sh + w * b_sw + j * b_ss
  float* o;                   // [rows, d] (rows = B * H * W, row (b * H + h) * W + w;
                              // rows_kernel takes W = 1 only)
  float* m;                   // [rows]
  float* l;                   // [rows]
  int B, KV, n_rep, W, S, d;
  int chunks;                 // chunks of NR rows per (b, g)
  long long q_sb, q_sh, q_sw;
  long long k_sb, k_sg, k_ss, v_sb, v_sg, v_ss;
  long long b_sb, b_sh, b_sw, b_ss;
  float scale;
  // K5's bf16 scale planes: slot (b, g, j) at ks + b * s_sb + g * s_sg + j * s_ss
  const void* ks;
  const void* vs;
  long long s_sb, s_sg, s_ss;
};


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// one 16-byte vector of T -> f32 values
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = f[j];
}
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const __nv_bfloat16*) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}
// four int8 codes (lowest byte first) -> the f32 bit patterns of their
// values, exactly: a byte biased by 128 becomes the mantissa of 2^23, and
// 2^23 + 128 is subtracted; the high half of each is the value in bf16
__device__ __forceinline__ void i8x4_bits(uint32_t w, uint32_t (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) -
                           8388736.0f);
}
// the bf16 pair (low: a's value, high: b's) from two such f32 patterns
__device__ __forceinline__ uint32_t hi_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632u);
}
// 16 int8 codes
__device__ __forceinline__ void widen(const uint4& raw, float* dst, const int8_t*) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t f[4];
    i8x4_bits(w[j], f);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[4 * j + i] = __uint_as_float(f[i]);
  }
}

// the 4-byte aligned word holding a bf16 (cp.async copies at least 4 bytes;
// a tensor's storage starts 4-byte aligned, so the word lies inside it) and
// the bf16 as f32 from that word: its high half where the element's index
// from an aligned base is odd.  Element j of a plane row at `row` with
// stride s is odd where odd_base(row) ^ (j & s) is 1.
__device__ __forceinline__ const void* word_of(const __nv_bfloat16* p) {
  return reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
}
__device__ __forceinline__ int odd_base(const __nv_bfloat16* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) >> 1) & 1;
}
__device__ __forceinline__ float half_at(uint32_t word, int odd) {
  return __uint_as_float(odd & 1 ? word & 0xFFFF0000u : word << 16);
}

// K5's scale ring (the k and v scale words of every lane's keys), in shared
// memory only in the kernels that read it
template <int NST, int U, int WARPS>
__device__ __forceinline__ uint32_t* scale_ring() {
  __shared__ uint32_t ring[NST * U * 2 * WARPS * 32];
  return ring;
}

// weight of a partial softmax state with maximum m against the joint maximum
// M: exp(m - M), 0 for a state that saw only -inf keys
__device__ __forceinline__ float rescale(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename T, int NR, int MODE>
__global__ void __launch_bounds__(THREADS) rows_kernel(const Params p) {
  constexpr bool kQ8 = std::is_same<T, int8_t>::value;   // K5: int8 codes, bf16 q and planes
  using QT = typename std::conditional<kQ8, __nv_bfloat16, T>::type;
  static_assert(!kQ8 || (MODE == kWindow && NR == 1), "the int8 cache is K5's, one row a block");
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int NST = NR == 2 ? 4 : 3;            // ring stages per warp (< 48 KB in all)
  const float kInit = MODE == kFlash ? -INFINITY : kNegInf;
  // lane-private ring: lane x of warp w only ever touches [.][.][w][x]
  __shared__ uint4 ring_k[NST][U][WARPS][32];
  __shared__ uint4 ring_v[NST][U][WARPS][32];
  __shared__ float ring_b[NST][U][NR][WARPS][32];
  __shared__ float red_o[WARPS][NR][MAX_D];
  __shared__ float red_m[WARPS][NR], red_l[WARPS][NR];

  const int g = blockIdx.x / p.chunks, chunk = blockIdx.x - g * p.chunks;
  const int b = blockIdx.y;
  const int H = p.KV * p.n_rep;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = p.d / VEC;                       // 16-byte chunks per key row
  int lg = 0;                                     // lanes per key: 2^lg >= nv
  while ((1 << lg) < nv) ++lg;
  const int lpk = 1 << lg, kpw = 32 >> lg;        // keys per warp step
  const int grp = lane >> lg, sub = lane & (lpk - 1);
  const bool active = sub < nv;

  const QT* q = static_cast<const QT*>(p.q);
  float qf[NR][VEC];
  const float* brow[NR];
  long long orow[NR];
  bool rok[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = chunk * NR + i;
    rok[i] = r < p.n_rep;
    const int h = g * p.n_rep + (rok[i] ? r : 0);
    // q is read once, element by element (its strides need no alignment)
    const QT* qp = q + b * p.q_sb + h * p.q_sh + sub * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) qf[i][e] = rok[i] && active ? to_f32(qp[e]) : 0.f;
    brow[i] = p.bias + b * p.b_sb + h * p.b_sh;
    orow[i] = static_cast<long long>(b) * H + h;
  }
  const T* krow = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sg;
  const T* vrow = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sg;
  // K5: this lane's slot of the scale ring is [st][u][k or v][warp][lane]
  const __nv_bfloat16* ksrow = nullptr;
  const __nv_bfloat16* vsrow = nullptr;
  uint32_t* sring = nullptr;
  int kodd = 0, vodd = 0, sodd = 0;
  if constexpr (kQ8) {
    ksrow = static_cast<const __nv_bfloat16*>(p.ks) + b * p.s_sb + g * p.s_sg;
    vsrow = static_cast<const __nv_bfloat16*>(p.vs) + b * p.s_sb + g * p.s_sg;
    sring = scale_ring<NST, U, WARPS>() + warp * 32 + lane;
    kodd = odd_base(ksrow);
    vodd = odd_base(vsrow);
    sodd = static_cast<int>(p.s_ss & 1);
  }

  const int bk = WARPS * U * kpw;                 // keys per block stage
  const int n_st = (p.S + bk - 1) / bk;
  auto issue = [&](int t) {
    if (t < n_st) {
      const int st = t % NST;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int key = t * bk + (warp * U + u) * kpw + grp;
        const bool in = key < p.S;
        const long long j = in ? key : 0;
        cp_async16(&ring_k[st][u][warp][lane], krow + j * p.k_ss + (active ? sub * VEC : 0),
                   in && active);
        cp_async16(&ring_v[st][u][warp][lane], vrow + j * p.v_ss + (active ? sub * VEC : 0),
                   in && active);
#pragma unroll
        for (int i = 0; i < NR; ++i)
          cp_async4(&ring_b[st][u][i][warp][lane], brow[i] + j * p.b_ss, in && rok[i]);
        if constexpr (kQ8) {
          uint32_t* sr = sring + (st * U + u) * 2 * WARPS * 32;
          cp_async4(sr, word_of(ksrow + j * p.s_ss), in);
          cp_async4(sr + WARPS * 32, word_of(vsrow + j * p.s_ss), in);
        }
      }
    }
    cp_async_commit();
  };

  float m_run[NR], l_run[NR], acc[NR][VEC];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m_run[i] = kInit;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue(t);
  for (int t = 0; t < n_st; ++t) {
    __syncwarp();   // this lane's reads of the slot about to be refilled are done
    issue(t + NST - 1);
    cp_async_wait<NST - 1>();
    const int st = t % NST;
    float s[U][NR], vf[U][VEC], v_s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = t * bk + (warp * U + u) * kpw + grp;
      float kf[VEC];
      widen(ring_k[st][u][warp][lane], kf, static_cast<const T*>(nullptr));
      widen(ring_v[st][u][warp][lane], vf[u], static_cast<const T*>(nullptr));
      float kscale = p.scale;
      if constexpr (kQ8) {
        const uint32_t* sr = sring + (st * U + u) * 2 * WARPS * 32;
        kscale = __fmul_rn(half_at(sr[0], kodd ^ (key & sodd)), p.scale);
        v_s[u] = half_at(sr[WARPS * 32], vodd ^ (key & sodd));
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(qf[i][e], kf[e], dot);
        for (int off = lpk >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][i] = key < p.S ? dot * kscale + ring_b[st][u][i][warp][lane] : kInit;
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float mx = s[0][i];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][i]);
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = MODE == kFlash ? rescale(m_run[i], m_new) : expf(m_run[i] - m_new);
      float pu[U], psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (MODE == kFlash)
          pu[u] = s[u][i] == -INFINITY ? 0.f : expf(s[u][i] - m_new);
        else
          pu[u] = s[u][i] > kValidFloor ? expf(s[u][i] - m_new) : 0.f;
        psum += pu[u];
        if constexpr (kQ8) pu[u] = __fmul_rn(pu[u], v_s[u]);
        if (MODE == kWindow) pu[u] = __bfloat162float(__float2bfloat16_rn(pu[u]));
      }
      l_run[i] = l_run[i] * alpha + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(pu[u], vf[u][e], a);
        acc[i][e] = fmaf(acc[i][e], alpha, a);
      }
      m_run[i] = m_new;
    }
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (lanes with the same sub), fixed tree
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l_run[i], off);
      const float M = fmaxf(m_run[i], mo);
      const float ca = rescale(m_run[i], M), cb = rescale(mo, M);
      l_run[i] = l_run[i] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * ca + ao * cb;
      }
      m_run[i] = M;
    }
  }
  if (grp == 0 && active) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red_o[warp][i][sub * VEC + e] = acc[i][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      red_m[warp][i] = m_run[i];
      red_l[warp][i] = l_run[i];
    }
  }
  __syncthreads();

  // merge the four warps; thread c owns column c
  const int c = threadIdx.x;
  if (c >= p.d) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (!rok[i]) continue;
    float M = red_m[0][i];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) M = fmaxf(M, red_m[w][i]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float cw = rescale(red_m[w][i], M);
      a += red_o[w][i][c] * cw;
      lsum += red_l[w][i] * cw;
    }
    p.o[orow[i] * p.d + c] = MODE == kFlash ? a / (lsum == 0.f ? 1.f : lsum) : a;
    if (c == 0) {
      p.m[orow[i]] = M;
      p.l[orow[i]] = lsum;
    }
  }
}

// Launch rows_kernel on p, whose W is 1: NR = 1, 2 or 4 of a kv head's n_rep
// heads per block (kWindow, K4's greedy step, has n_rep = 1).
template <typename T, int MODE>
int launch_rows(Params p, cudaStream_t stream) {
  const int nr = p.n_rep <= 1 ? 1 : p.n_rep <= 2 ? 2 : 4;
  p.chunks = (p.n_rep + nr - 1) / nr;
  const long long gx = static_cast<long long>(p.KV) * p.chunks;
  if (p.W != 1 || (MODE == kWindow && nr != 1) || p.B > 65535 || gx > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), p.B);
  if constexpr (MODE == kWindow) {
    rows_kernel<T, 1, MODE><<<grid, THREADS, 0, stream>>>(p);
  } else {
    if (nr == 1)
      rows_kernel<T, 1, MODE><<<grid, THREADS, 0, stream>>>(p);
    else if (nr == 2)
      rows_kernel<T, 2, MODE><<<grid, THREADS, 0, stream>>>(p);
    else
      rows_kernel<T, 4, MODE><<<grid, THREADS, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_rows

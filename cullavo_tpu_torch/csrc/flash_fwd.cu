// Flash-attention forward on the mma.sync body: the masked forward with
// explicit query positions and key validity (K8) and the causal forward on
// the packed-heads layout (K13).  One kernel template.
//
// K1 and K1-lse, the bias-free causal forward of Pallas row 1 and its lse
// form, ran on this body until they moved to csrc/flash_fwd_sm90.cu (TMA
// loads, an mbarrier ring, wgmma); K8 and K13 move there next.  K13 is
// that causal form on the packed layout, K8 adds masks to it:
//     o[b, h, i] = sum_{j <= i} softmax_j(q_i . k_j * d^-0.5) v_j
// bf16 q/k/v/o with head dim 128, f32 scores and online-softmax state
// (running max m, running sum l, f32 accumulator), and the probabilities
// rounded to bf16 before the P.V product, as the TPU kernel does.  Key tiles
// above the diagonal are skipped; the ragged end of T (648 is not a multiple
// of the 64-row tile) is handled in the kernel: rows past T load as zeros,
// are causally invisible to every valid query, and are not stored.  Heads
// are read through strides, so q/k/v can be [B, T, H, d] projection outputs
// viewed as [B, H, T, d] and the output is written the same way (no
// transposes around the call).
//
// Bound on the H100: tensor-core math.  The 7B prefill at B = 14, T = 648 is
// ~48 GFLOP per layer (4*B*H*T^2*d / 2), ~1.5 TFLOP over 32 layers.
// Design (FlashAttention-2 shape): one block of 4 warps per (b, h, 64-query
// tile); each warp owns 16 query rows with Q in registers as mma fragments;
// 64-key K and V tiles are staged in padded shared memory (row stride 136
// bf16: conflict-free fragment loads); S = Q K^T and O += P V run as
// mma.sync m16n8k16 bf16 -> f32, V fragments through ldmatrix.trans.  The
// heaviest query tiles launch first.  No TMA/wgmma and no load/compute
// overlap yet: that is later work.  Launches on the caller's stream and
// allocates nothing.
//
// kLse: the same launch also writes lse[b, h, i] = m_i + log(l_i), f32
// [B, H, T] contiguous, which the backward of the autograd function needs to
// recompute the probabilities (K8 with an lse).  One value per query row
// (the TPU kernel replicates it over 128 lanes for its output tiling; there
// is no such rule here).
//
// K8 (kRows).  Replaces: cullavo_tpu/ops/flash_attention.py, _flash_fwd_core
// -> _fwd_kernel_rows (and the key-validity bias of _fwd_kernel_iota):
//     visible(i, j) = kvalid[b, j] != 0 and (not causal or qpos[b, i] >= j)
// over q [B, H, T, d] and k/v [B, H, S, d], S and T independent and ragged.
// qpos int32 [B, T] (null: the row index) and kvalid int32 [B, S] (null: all
// valid) are read per batch row: no copy per head and no padding of T or S
// to 128 in device memory.  A masked score is the FINITE -1e30, as in the TPU
// kernel, so a row with no visible key gets p = exp(0) = 1 for every key
// and returns the mean of v with lse = -1e30 + log(S); keys past S (the
// ragged last tile) are excluded outright (score -inf, p = 0).  Because a
// wholly masked row needs every key, no key tile is skipped: the kernel does
// the full T x S work where the causal mask would allow half.  Same tiles,
// fragments and numerics as the causal form (bf16 P for the PV product, f32
// state).
//
// K13 (kPacked).  Replaces: cullavo_tpu/ops/flash_attention.py,
// _packed_fwd_core -> _fwd_kernel_iota with batch groups (Pallas row 3,
// CULLAVO_FLASH_PACKED_BG=1) and _fwd_kernel_iota_packed (row 4, G heads per
// program): the causal forward on the packed-heads projection layout, q
// [B, T, H*d] and k/v [B, S, H*d] with S >= T, head h in columns
// [h*d, (h+1)*d), output [B, T, H*d].  Query i sees keys j <= i (global iota
// positions, no key mask), so keys past T never reach a valid row.  Rows 3
// and 4 compute one function and differ only in how the TPU tiles lanes
// (one 128-lane head per program, or G heads sliced inside the program);
// Hopper has no lane blocks, so one kernel serves both and
// CULLAVO_FLASH_PACKED_BG has no meaning here.  The kernel derives the
// head's column offset h*d and the row stride H*d from its grid and T, S
// itself (no stride arguments); everything else is the causal form's body
// (same tiles, causal tile skip, f32 online softmax, bf16 P) and bound
// (tensor-core math at training and prefill shapes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // head dim
constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BKV = 64;      // keys per tile
constexpr int LDS = D + 8;   // padded shared-memory row stride (bf16 elements)
constexpr int THREADS = 128;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

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

template <bool kRows, bool kLse, bool kPacked>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ qpos, const int* __restrict__ kvalid,
                 int causal, int T, int S,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 long long o_sb, long long o_sh, long long o_st, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[BKV * LDS];
  __shared__ int kflag[BKV];  // K8: 1 valid key, 0 masked key, -1 past S

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest (last) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  if (kPacked) {  // K13: [B, T|S, H*d] rows, head h at column h*d
    const long long row = (long long)gridDim.y * D;
    q_sb = o_sb = (long long)T * row;
    k_sb = v_sb = (long long)S * row;
    q_sh = k_sh = v_sh = o_sh = D;
    q_st = k_st = v_st = o_st = row;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  const int row0 = qt * BQ + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;
  // K8: the logical positions of this thread's two query rows
  int qp0 = row0, qp1 = row1;
  if (kRows && qpos != nullptr) {
    qp0 = row0 < T ? qpos[(long long)b * T + row0] : 0;
    qp1 = row1 < T ? qpos[(long long)b * T + row1] : 0;
  }

  // Q as A fragments (16 x 128 per warp = 8 chunks of 16 along d)
  uint32_t qf[8][4];
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const int c = kc * 16 + 2 * t4;
    qf[kc][0] = row0 < T ? ld32(qb + row0 * q_st + c) : 0u;
    qf[kc][1] = row1 < T ? ld32(qb + row1 * q_st + c) : 0u;
    qf[kc][2] = row0 < T ? ld32(qb + row0 * q_st + c + 8) : 0u;
    qf[kc][3] = row1 < T ? ld32(qb + row1 * q_st + c + 8) : 0u;
  }

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_kt = kRows ? (S + BKV - 1) / BKV : qt + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's shared-memory reads are done
    if (kRows && threadIdx.x < BKV) {
      const int key = kt * BKV + threadIdx.x;
      kflag[threadIdx.x] =
          key >= S ? -1
                   : (kvalid == nullptr || kvalid[(long long)b * S + key] != 0);
    }
#pragma unroll
    for (int i = 0; i < (BKV * D / 8) / THREADS; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int r = c >> 4, col = (c & 15) * 8;
      const int key = kt * BKV + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < S) {
        kv = *reinterpret_cast<const uint4*>(kb + key * k_st + col);
        vv = *reinterpret_cast<const uint4*>(vb + key * v_st + col);
      }
      *reinterpret_cast<uint4*>(ks + r * LDS + col) = kv;
      *reinterpret_cast<uint4*>(vs + r * LDS + col) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc)
        mma_bf16(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // scale, causal mask (only the diagonal tile straddles it), row max
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale;
        const int kk = nt * 8 + 2 * t4 + (e & 1);
        if (kRows) {
          const int flag = kflag[kk];
          if (flag < 0)
            val = -INFINITY;
          else if (flag == 0 || (causal && kt * BKV + kk > (e < 2 ? qp0 : qp1)))
            val = kNegInf;
        } else if (kt == qt) {
          if (kt * BKV + kk > (e < 2 ? row0 : row1)) val = kNegInf;
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

    // P = exp(S - m) (f32 row sums), rounded to bf16 as the PV A operand
    float ls0 = 0.f, ls1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - mn0), p1 = expf(s[nt][1] - mn0);
      const float p2 = expf(s[nt][2] - mn1), p3 = expf(s[nt][3] - mn1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      const int kc = nt >> 1, hi = nt & 1;
      pa[kc][hi * 2 + 0] = pack_bf16(p0, p1);
      pa[kc][hi * 2 + 1] = pack_bf16(p2, p3);
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

    // O += P V: V fragments via ldmatrix.trans, two 8-column d tiles per load
    const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dt = 0; dt < 16; dt += 2) {
        const __nv_bfloat16* p =
            vs + (kc * 16 + (mat & 1) * 8 + mrow) * LDS + dt * 8 + (mat >> 1) * 8;
        const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(acc[dt], pa[kc], b0, b1);
        mma_bf16(acc[dt + 1], pa[kc], b2, b3);
      }
    }
  }

  // O / l -> bf16 (l > 0 for every valid row: key 0 is always visible, or,
  // in K8, counted with p = 1 when the whole row is masked)
  l0 = l0 == 0.f ? 1.f : l0;
  l1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (kLse && t4 == 0) {
    float* lb = lse + ((long long)b * gridDim.y + h) * T;
    if (row0 < T) lb[row0] = m0 + logf(l0);
    if (row1 < T) lb[row1] = m1 + logf(l1);
  }
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(ob + row0 * o_st + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(ob + row1 * o_st + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <bool kRows, bool kLse, bool kPacked = false>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* qpos, const void* kvalid, int causal, int B, int H, int T,
           int S, int d, const long long* st, float scale, void* stream) {
  if (d != D || T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<kRows, kLse, kPacked>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
          static_cast<float*>(lse), static_cast<const int*>(qpos),
          static_cast<const int*>(kvalid), causal, T, S, st[0], st[1], st[2], st[3],
          st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: masked forward.  qpos int32 [B, T] or null, kvalid int32 [B, S] or
// null, lse f32 [B, H, T] or null.
extern "C" int cullavo_flash_rows(const void* q, const void* k, const void* v,
                                  void* o, void* lse, const void* qpos,
                                  const void* kvalid, int causal, int B, int H, int T,
                                  int S, int d,
                                  long long q_sb, long long q_sh, long long q_st,
                                  long long k_sb, long long k_sh, long long k_st,
                                  long long v_sb, long long v_sh, long long v_st,
                                  long long o_sb, long long o_sh, long long o_st,
                                  float scale, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                            v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  if (lse != nullptr)
    return launch<true, true>(q, k, v, o, lse, qpos, kvalid, causal, B, H, T, S, d,
                              st, scale, stream);
  return launch<true, false>(q, k, v, o, nullptr, qpos, kvalid, causal, B, H, T, S, d,
                             st, scale, stream);
}

// K13: causal forward on the packed layout, q [B, T, H*d] and k/v/o
// [B, S|T, H*d] contiguous, S >= T (query i sees keys j <= i).
extern "C" int cullavo_flash_packed(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int T, int S, int d, float scale,
                                    void* stream) {
  if (S < T) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return launch<false, false, true>(q, k, v, o, nullptr, nullptr, nullptr, 1, B, H, T, S,
                                    d, st, scale, stream);
}

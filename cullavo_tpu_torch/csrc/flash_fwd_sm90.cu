// The forward flash-attention kernels on Hopper: one template written for the
// H100 with TMA loads, an mbarrier ring, wgmma and warp specialisation.
//
// Replaces, in cullavo_tpu/ops/flash_attention.py (Pallas rows 1-4):
//  * K1 / K1-lse: _flash_fwd_core -> _fwd_kernel_iota (row 1), the bias-free
//    causal path for right-padded batches with S == T:
//        o[b, h, i] = sum_{j <= i} softmax_j(q_i . k_j * d^-0.5) v_j
//    K1-lse (kLse) also writes lse[b, h, i] = m_i + log(l_i), f32 [B, H, T]
//    contiguous, one value per row (the TPU kernel's need_lse output); K1 has
//    no lse code at all, and K1-lse's o is bit-equal to K1's.
//  * K8 / K8-lse (kMasked): _flash_fwd_core -> _fwd_kernel_rows (row 2), the
//    masked form over q [B, H, T, d] and k/v [B, H, S, d], S and T
//    independent:
//        visible(i, j) = kvalid[b, j] != 0 and (not causal or qpos[b, i] >= j)
//    qpos int32 [B, T] (null: the row index), kvalid int32 [B, S] (null: all
//    valid).  A masked score is the FINITE -1e30 in scaled units, as in the
//    TPU kernel, so a row with no visible key averages v over the S keys with
//    lse = -1e30 + log(S); keys past S are excluded outright (-inf).
//  * K13: _packed_fwd_core -> _fwd_kernel_iota in batch groups (row 3) and
//    _fwd_kernel_iota_packed (row 4): K1's function on the packed-heads
//    projection layout, q [B, T, H*d] and k/v [B, S, H*d] with S >= T, head h
//    at columns [h*d, (h+1)*d).  It IS the K1 instantiation behind tensor
//    maps that its entry point encodes from (B, H, T, S); keys in [T, S) only
//    reach the diagonal tile, where causality masks them.  Rows 3 and 4
//    differ only in how the TPU tiles lanes, so one kernel serves both.
// bf16 q/k/v/o with head dim 128, f32 scores and online-softmax state (running
// max m, running sum l, f32 accumulator), the probabilities rounded to bf16
// before the P.V product, as the TPU kernels do.  q/k/v/o are read and
// written through tensor maps built from the tensors' own strides, so
// [B, H, T, d] views of [B, T, H, d] projection outputs need no transposes.
// Deterministic: one block owns a query tile and walks its key tiles in a
// fixed order (no split over keys, no atomics).
//
// Bounds on the H100 (3.35 TB/s, 989 TFLOP/s bf16):
//  * K1 / K1-lse / K13: at the train shape [8, 32, 1024, 128] the 268 MB of
//    q/k/v/o take 0.080 ms and the 68.7 GFLOP of causal products 0.069 ms,
//    so bytes and tensor-core math are close; at the prefill [7, 32, 648]
//    bytes (0.044 ms).  The kernel reads each K/V tile from L2 for every
//    query tile of its head, and the softmax's exponentials compete with the
//    products for issue slots.
//  * K8: the bound counts the visible pairs (0.038 ms at the probe shape
//    [6, 32, 648, 128]: bytes), but a row with no visible key needs every
//    key (p = 1 for each), so the kernel computes the full T x S products
//    (41.3 GFLOP there), about twice the causal work, plus the mask.
//
// Design (FlashAttention-3 shape):
//  * a block of three warpgroups per (128-row query tile, head, batch row),
//    the heaviest query tiles of each head first.  Warpgroup 0 is the
//    producer: it gives up registers (setmaxnreg.dec 40) and one thread
//    issues every TMA load.  Warpgroups 1 and 2 are consumers, 64 query rows
//    each (setmaxnreg.inc 232); a consumer whose rows all lie past T leaves
//    at once and the other runs alone.
//  * TMA: one 4-D tensor map (d, H, T, B) per tensor with a 128-byte swizzle,
//    so a 128-column row is two 64-column boxes.  Rows past T (keys past S)
//    load as zeros (the hardware's out-of-bounds fill) and are not stored.
//    A head or batch axis of extent 1 (a broadcast axis) is read at
//    coordinate 0.
//  * ring: Q is loaded once per block (32 KB); K and V tiles of 128 keys
//    (32 KB each) go through two stages with full and empty mbarriers of
//    their own, so K of tile j+1 loads while tile j is computed and V is
//    released only after its product.  160 KB of dynamic shared memory.
//  * wgmma: S = Q K^T as m64n128k16 over 8 k-steps, Q and K K-major in
//    shared memory (descriptors: 128-byte swizzle, 8-row groups 1024 B
//    apart, a k-step 32 B into the swizzle atom).  O += P V takes P from
//    registers: the f32 S accumulator packs in place into bf16 A fragments
//    (the accumulator and A-fragment layouts coincide); V is the B operand in
//    MN-major form with the transpose bit (the second 64 columns of d are the
//    next box: LBO 16 KB, 8-key groups SBO 1024 B), so V is never transposed.
//  * overlap: within a consumer, S of tile j+1 is issued before P V of tile
//    j, and the softmax of tile j+1 runs while that product is in flight.
//    The two consumers take turns at the tensor cores (named barriers 1 and
//    2), so one's softmax runs under the other's products.
//  * softmax: exp2 with scale * log2(e) folded into one FMA; the row max is
//    reduced across the quad by shuffles, the row sum per thread until the
//    end.  K1: tiles above the diagonal are never loaded; only the diagonal
//    tile, processed first, is masked (-inf: every row sees its own key).
//  * K8 walks every key tile 0 .. ceil(S/128) - 1 (no causal skip) and masks
//    each: a producer warp writes the tile's key-validity bits (four ballots
//    over kvalid) beside the K stage and arrives on its full barrier; each
//    consumer thread reads its two rows' positions once.  Tile 0 holds key
//    0 < S, so no row's running max stays -inf.  Its exponent takes (s - m)
//    exactly before the scale: the FMA form leaves the rounding error of
//    m * scale * log2(e) (~1e23 at m ~ -1e30 / scale), which would turn a
//    wholly masked row's p = 1 into 0 or inf.  K1's instruction stream is
//    the kMasked = false instantiation, untouched by any of this.
//  * epilogue: O / l to bf16 into the consumer's own Q rows of shared memory
//    (swizzled as the map expects), then two TMA stores, which clip rows
//    past T.  Launches on the caller's stream and allocates nothing.
//
// The host side reaches cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint (no -lcuda on the link line).  An entry point
// returns cudaErrorInvalidValue if the encoder refuses a layout (the wrapper
// raises on such layouts before it calls), else cudaGetLastError() after the
// launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;               // head dim
constexpr int BM = 128;              // query rows per block (two consumers x 64)
constexpr int BN = 128;              // keys per tile
constexpr int THREADS = 384;         // producer + two consumer warpgroups
constexpr int BOX_COLS = 64;         // bf16 columns in one 128-byte swizzled box row
constexpr uint32_t Q_BYTES = BM * D * 2;       // [consumer][half][64 rows][128 B]
constexpr uint32_t Q_HALF = 64 * 128;          // one consumer's 64-column half
constexpr uint32_t KV_BYTES = BN * D * 2;      // [half][128 rows][128 B]
constexpr uint32_t KV_HALF = BN * 128;
constexpr int STAGES = 2;
constexpr uint32_t OFF_KV = Q_BYTES;           // stage s: K, then V
constexpr uint32_t OFF_BAR = Q_BYTES + STAGES * 2 * KV_BYTES;
// barriers: q_full; full_k[2]; full_v[2]; empty_k[2]; empty_v[2]; then K8's
// key-validity words, 4 x 32 bits per K stage (written and released with it)
constexpr uint32_t BAR_FULL_K = 8, BAR_FULL_V = 24, BAR_EMPTY_K = 40, BAR_EMPTY_V = 56;
constexpr uint32_t BAR_FLAGS = 80;
constexpr int SMEM_BYTES = OFF_BAR + 128 + 1024;   // + barriers + 1024-B alignment slack
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;   // the TPU kernel's finite mask value (scaled units)

// ---- shared-memory barriers and TMA -----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one arrival per warp: lane 0's, predicated (no divergent branch before the
// warp's next .aligned instruction)
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n"
      " @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// one thread's arrival (release: its shared-memory stores before it are seen
// by a thread whose wait completes the phase)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers that an in-flight wgmma owns
__device__ __forceinline__ void fence_regs(float (&x)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&x)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
}

#define CULLAVO_ACC_REGS                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "    \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define CULLAVO_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CULLAVO_F16(i) CULLAVO_F4(i), CULLAVO_F4(i + 4), CULLAVO_F4(i + 8), CULLAVO_F4(i + 12)
#define CULLAVO_ACC_OPERANDS CULLAVO_F16(0), CULLAVO_F16(16), CULLAVO_F16(32), CULLAVO_F16(48)

// d (+)= A B, A and B from shared memory (both K-major), m64n128k16 bf16 -> f32
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CULLAVO_ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CULLAVO_ACC_OPERANDS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (bf16 pairs) from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CULLAVO_ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : CULLAVO_ACC_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T over d = 128: 8 k-steps of 16 columns, 4 in each 64-column box
__device__ __forceinline__ void gemm_qk(float (&s)[64], uint32_t sq, uint32_t sk) {
  const uint64_t dq = smem_desc(sq, 16, 1024), dk = smem_desc(sk, 16, 1024);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t oq = (ks >> 2) * Q_HALF + (ks & 3) * 32;
    const uint32_t ok = (ks >> 2) * KV_HALF + (ks & 3) * 32;
    wgmma_ss(s, dq + (oq >> 4), dk + (ok >> 4), ks > 0);
  }
}

// O += P V over 128 keys: 8 k-steps of 16 keys (2048 B of V rows each)
__device__ __forceinline__ void gemm_pv(float (&o)[64], const uint32_t (&p)[8][4], uint32_t sv) {
  const uint64_t dv = smem_desc(sv, KV_HALF, 1024);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) wgmma_rs(o, p[ks], dv + ((ks * 16 * 128) >> 4));
}

// ---- softmax ------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of m64nN: thread (warp w, lane = 4 g + t) holds rows
// 16 w + g (entries 4 j, 4 j + 1) and 16 w + g + 8 (4 j + 2, 4 j + 3) at
// columns 8 j + 2 t, 8 j + 2 t + 1.
// The diagonal tile: key column > query row (both relative to the tile) is
// masked; r0 is this thread's first row within the 128-row tile.
__device__ __forceinline__ void mask_diagonal(float (&s)[64], int r0, int t4) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (8 * j + 2 * t4 + (e & 1) > r0 + 8 * (e >> 1)) s[4 * j + e] = -INFINITY;
}

// K8's mask of one key tile.  w: the tile's four key-validity words shifted
// right by 2 t4, so bit 8 (j & 3) + (e & 1) of w[j >> 2] is entry (j, e)'s
// key.  lim0 / lim1: the last causally visible key of this thread's two rows,
// lim_s the first key past S, all relative to the tile's key 2 t4.  A key
// past S is -inf; an invisible one the finite mask value in unscaled units.
__device__ __forceinline__ void mask_tile(float (&s)[64], const uint32_t (&w)[4], int lim0,
                                          int lim1, int lim_s, float neg) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + (e & 1);
      const bool valid = (w[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
      const bool ok = valid && col <= (e < 2 ? lim0 : lim1);
      s[4 * j + e] = col >= lim_s ? -INFINITY : (ok ? s[4 * j + e] : neg);
    }
}

// K8: the four validity words of a stage, shifted right by 2 t4 (see mask_tile)
__device__ __forceinline__ void load_flags(uint32_t (&w)[4], uint32_t addr, int t4) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(addr)
               : "memory");
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] >>= 2 * t4;
}

// online softmax of one tile: s becomes exp(scale (s - m_new)); m, the
// per-thread partial l and the factor alpha = exp(scale (m_old - m_new)) by
// which O must be rescaled before this tile's P V is added.  kExact (K8)
// takes s - m_new exactly before scaling (a wholly masked row: 0, so p = 1).
template <bool kExact>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * sl2);   // m = -inf before the first tile: 0
    m[r] = mx[r];
  }
  float sum0 = 0.f, sum1 = 0.f;
  if constexpr (kExact) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2((s[4 * j] - mx[0]) * sl2);
      s[4 * j + 1] = ex2((s[4 * j + 1] - mx[0]) * sl2);
      s[4 * j + 2] = ex2((s[4 * j + 2] - mx[1]) * sl2);
      s[4 * j + 3] = ex2((s[4 * j + 3] - mx[1]) * sl2);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
  } else {
    const float ms0 = mx[0] * sl2, ms1 = mx[1] * sl2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], sl2, -ms0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -ms0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -ms1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -ms1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
}

// P as the A fragments of the P V product, in place of the accumulator:
// k-step kk covers columns 16 kk .. 16 kk + 15, i.e. accumulator entries
// 8 kk .. 8 kk + 7 in the A-fragment order (g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8)
__device__ __forceinline__ void to_bf16_frags(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// ---- the kernel ---------------------------------------------------------------

// bcast: bit 2i / 2i + 1 set when tensor i (q, k, v) has a head / batch axis
// of extent 1 in its map (read at coordinate 0).  qpos, kvalid (either may be
// null), S and causal are K8's (kMasked); K1 and K13 never read them.
template <bool kLse, bool kMasked>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse,
                      const int* __restrict__ qpos, const int* __restrict__ kvalid, int T,
                      int S, int causal, float scale, int bcast) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t bar = base + OFF_BAR;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  // K1: key tiles qt, qt - 1, ..., 0; K8: every key tile 0, 1, ...
  const int n_kt = kMasked ? (S + BN - 1) / BN : qt + 1;
  const int n_live = qt * BM + 64 < T ? 2 : 1; // consumers with a row < T
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      // K8: the TMA thread's arrival and the validity warp's
      mbar_init(bar + BAR_FULL_K + 8 * s, kMasked ? 2 : 1);
      mbar_init(bar + BAR_FULL_V + 8 * s, 1);
      mbar_init(bar + BAR_EMPTY_K + 8 * s, 4 * n_live);   // one arrival per consumer warp
      mbar_init(bar + BAR_EMPTY_V + 8 * s, 4 * n_live);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int qh = bcast & 1 ? 0 : h, qb = bcast & 2 ? 0 : b;
      const int kh = bcast & 4 ? 0 : h, kb = bcast & 8 ? 0 : b;
      const int vh = bcast & 16 ? 0 : h, vb = bcast & 32 ? 0 : b;
      mbar_expect_tx(bar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          tma_load(base + (2 * c + half) * Q_HALF, &tm_q, bar, half * BOX_COLS, qh,
                   qt * BM + c * 64, qb);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i & 1, row = (kMasked ? i : qt - i) * BN;
        const uint32_t parity = ((i >> 1) & 1) ^ 1;   // the first round finds the stage free
        const uint32_t sk = base + OFF_KV + s * 2 * KV_BYTES, sv = sk + KV_BYTES;
        mbar_wait(bar + BAR_EMPTY_K + 8 * s, parity);
        mbar_expect_tx(bar + BAR_FULL_K + 8 * s, KV_BYTES);
        tma_load(sk, &tm_k, bar + BAR_FULL_K + 8 * s, 0, kh, row, kb);
        tma_load(sk + KV_HALF, &tm_k, bar + BAR_FULL_K + 8 * s, BOX_COLS, kh, row, kb);
        mbar_wait(bar + BAR_EMPTY_V + 8 * s, parity);
        mbar_expect_tx(bar + BAR_FULL_V + 8 * s, KV_BYTES);
        tma_load(sv, &tm_v, bar + BAR_FULL_V + 8 * s, 0, vh, row, vb);
        tma_load(sv + KV_HALF, &tm_v, bar + BAR_FULL_V + 8 * s, BOX_COLS, vh, row, vb);
      }
    } else if (kMasked && threadIdx.x / 32 == 1) {
      // K8's validity warp: bit k of word j is key 32 j + k of the tile
      // (valid and < S), stored beside the K stage and released with it
      const int lane = threadIdx.x & 31;
      const int* kv = kvalid == nullptr ? nullptr : kvalid + static_cast<long long>(b) * S;
      for (int i = 0; i < n_kt; ++i) {
        const int s = i & 1;
        mbar_wait(bar + BAR_EMPTY_K + 8 * s, ((i >> 1) & 1) ^ 1);
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = i * BN + 32 * j + lane;
          w[j] = __ballot_sync(0xffffffffu, key < S && (kv == nullptr || kv[key] != 0));
        }
        if (lane == 0) {
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(bar + BAR_FLAGS +
                                                                          16 * s),
                       "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                       : "memory");
          mbar_arrive(bar + BAR_FULL_K + 8 * s);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int row_base = qt * BM + c * 64;
    if (row_base >= T) return;   // every row past T: the other consumer runs alone
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const bool pingpong = n_live == 2;
    const uint32_t bar_mine = 1 + c, bar_other = 2 - c;   // turns at the tensor cores
    const uint32_t sq = base + c * 2 * Q_HALF;
    const float sl2 = scale * kLog2e;

    float o[64], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[8][4];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    // K8: the last visible key of this thread's two rows (positions clamped
    // to [-1, S], which sees the same keys and cannot overflow below), the
    // mask value in unscaled units, the tile's validity words
    int qp0 = S, qp1 = S;
    float neg = 0.f;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if constexpr (kMasked) {
      const int r0 = row_base + warp * 16 + g, r1 = r0 + 8;
      if (causal) {
        const int* qp = qpos == nullptr ? nullptr : qpos + static_cast<long long>(b) * T;
        qp0 = qp == nullptr ? r0 : (r0 < T ? qp[r0] : 0);
        qp1 = qp == nullptr ? r1 : (r1 < T ? qp[r1] : 0);
        qp0 = min(max(qp0, -1), S);
        qp1 = min(max(qp1, -1), S);
      }
      neg = kNegInf / scale;
    }
    if (pingpong && c == 1) named_arrive(1, 256);   // consumer 0 goes first

    mbar_wait(bar, 0);
    // the first tile (i = 0, stage 0; K1: the diagonal): S, the mask, the
    // first softmax
    mbar_wait(bar + BAR_FULL_K, 0);
    if constexpr (kMasked) load_flags(w, bar + BAR_FLAGS, t4);
    if (pingpong) named_sync(bar_mine, 256);
    wg_fence();
    gemm_qk(s, sq, base + OFF_KV);
    wg_commit();
    if (pingpong) named_arrive(bar_other, 256);
    wg_wait<0>();
    fence_regs(s);
    mbar_arrive_lane0(bar + BAR_EMPTY_K, lane);
    if constexpr (kMasked)
      mask_tile(s, w, qp0 - 2 * t4, qp1 - 2 * t4, S - 2 * t4, neg);
    else
      mask_diagonal(s, c * 64 + warp * 16 + g, t4);
    softmax_tile<kMasked>(s, m, l, alpha, sl2);
    to_bf16_frags(s, p);

    for (int i = 1; i < n_kt; ++i) {
      const int st = i & 1, sp = st ^ 1;
      const uint32_t par = (i >> 1) & 1, par_prev = ((i - 1) >> 1) & 1;
      const uint32_t sk = base + OFF_KV + st * 2 * KV_BYTES;
      const uint32_t sv_prev = base + OFF_KV + sp * 2 * KV_BYTES + KV_BYTES;
      mbar_wait(bar + BAR_FULL_K + 8 * st, par);
      if constexpr (kMasked) load_flags(w, bar + BAR_FLAGS + 16 * st, t4);
      if (pingpong) named_sync(bar_mine, 256);
      wg_fence();
      gemm_qk(s, sq, sk);           // S of tile i ...
      wg_commit();
      rescale(o, alpha);
      mbar_wait(bar + BAR_FULL_V + 8 * sp, par_prev);
      wg_fence();
      gemm_pv(o, p, sv_prev);       // ... while P V of tile i - 1 follows it
      wg_commit();
      if (pingpong) named_arrive(bar_other, 256);
      wg_wait<1>();
      fence_regs(s);
      mbar_arrive_lane0(bar + BAR_EMPTY_K + 8 * st, lane);
      if constexpr (kMasked) {
        const int kb2 = i * BN + 2 * t4;
        mask_tile(s, w, qp0 - kb2, qp1 - kb2, S - kb2, neg);
      }
      softmax_tile<kMasked>(s, m, l, alpha, sl2);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive_lane0(bar + BAR_EMPTY_V + 8 * sp, lane);
      to_bf16_frags(s, p);
    }

    // P V of the last tile
    const int sl = (n_kt - 1) & 1;
    rescale(o, alpha);
    mbar_wait(bar + BAR_FULL_V + 8 * sl, ((n_kt - 1) >> 1) & 1);
    wg_fence();
    gemm_pv(o, p, base + OFF_KV + sl * 2 * KV_BYTES + KV_BYTES);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(p);
    if (pingpong && c == 0) named_sync(bar_mine, 256);   // the other's last turn

    // the row sums over the quad; O / l (l > 0: K1's rows see their own key,
    // K8's the largest score of tile 0, which holds key 0 < S)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
    const int r0 = warp * 16 + g;   // this thread's rows r0, r0 + 8 of the 64
    if (kLse) {
      float* lrow = lse + (static_cast<long long>(b) * gridDim.y + h) * T + row_base;
      if (t4 == 0 && row_base + r0 < T) lrow[r0] = m[0] * scale + logf(l[0]);
      if (t4 == 0 && row_base + r0 + 8 < T) lrow[r0 + 8] = m[1] * scale + logf(l[1]);
    }
    // O as bf16 over this consumer's Q rows (no longer read), in the map's
    // swizzle: 16-byte chunk j & 7 of row r sits at chunk (j & 7) ^ (r & 7),
    // and (r0 & 7) == ((r0 + 8) & 7) == g
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t a = sq + (j >> 3) * Q_HALF + r0 * 128 + (((j & 7) ^ g) << 4) + t4 * 4;
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a),
                   "r"(pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0))
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a + 8 * 128),
                   "r"(pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1))
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    named_sync(3 + c, 128);
    if (tid == 0) {
      tma_store(&tm_o, sq, 0, h, row_base, b);
      tma_store(&tm_o, sq + Q_HALF, BOX_COLS, h, row_base, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// layout: extents of (H, T, B) and their byte strides, as the wrapper's
// _tma_layout gives them; the map's inner axis is the 128 contiguous d
bool encode(CUtensorMap* map, EncodeTiled fn, const void* ptr, const long long* layout,
            uint32_t box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(layout[0]),
                              static_cast<cuuint64_t>(layout[1]),
                              static_cast<cuuint64_t>(layout[2])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(layout[3]),
                                 static_cast<cuuint64_t>(layout[4]),
                                 static_cast<cuuint64_t>(layout[5])};
  const cuuint32_t box[4] = {BOX_COLS, 1, box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K13's maps: the packed [B, rows, H*d] tensor's head views, (H, rows, B)
// extents and byte strides as the wrapper's _tma_layout gives them for a
// [B, H, rows, d] view (an axis of extent 1 is never stepped: stride 2 d)
void packed_layout(long long* layout, int B, int H, int rows) {
  const long long n[3] = {H, rows, B};
  const long long st[3] = {2LL * D, 2LL * H * D, 2LL * rows * H * D};
  for (int i = 0; i < 3; ++i) {
    layout[i] = n[i];
    layout[3 + i] = n[i] == 1 ? 2LL * D : st[i];
  }
}

template <bool kLse, bool kMasked>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* qpos,
           const void* kvalid, int causal, int B, int H, int T, int S, int d,
           const long long* layout, float scale, void* stream) {
  if (d != D || B < 1 || H < 1 || T < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const uint32_t rows[4] = {64, BN, BN, 64};   // q and o: one consumer's 64 rows per box
  int bcast = 0;
  for (int i = 0; i < 4; ++i) {
    if (!encode(&maps[i], fn, ptrs[i], layout + 6 * i, rows[i]))
      return static_cast<int>(cudaErrorInvalidValue);
    if (i < 3 && layout[6 * i] == 1) bcast |= 1 << (2 * i);
    if (i < 3 && layout[6 * i + 2] == 1) bcast |= 2 << (2 * i);
  }
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_sm90_kernel<kLse, kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_fwd_sm90_kernel<kLse, kMasked>
      <<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
          maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse),
          static_cast<const int*>(qpos), static_cast<const int*>(kvalid), T, S, causal, scale,
          bcast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout (K1, K1-lse, K8): 24 int64, the (H, T|S, B) extents and byte strides
// of q, k, v and o in turn, as the wrapper's _tma_layout gives them.

// K1: causal, right-padded, S == T; writes no lse.
extern "C" int cullavo_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int H, int T, int d, const long long* layout, float scale,
                                 void* stream) {
  return launch<false, false>(q, k, v, o, nullptr, nullptr, nullptr, 1, B, H, T, T, d, layout,
                              scale, stream);
}

// K1-lse: K1 that also writes lse f32 [B, H, T] (contiguous).
extern "C" int cullavo_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int H, int T, int d,
                                     const long long* layout, float scale, void* stream) {
  return launch<true, false>(q, k, v, o, lse, nullptr, nullptr, 1, B, H, T, T, d, layout, scale,
                             stream);
}

// K8 / K8-lse: the masked forward.  qpos int32 [B, T] or null (the row
// index), kvalid int32 [B, S] or null (all valid), lse f32 [B, H, T] or null.
extern "C" int cullavo_flash_rows(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* qpos, const void* kvalid, int causal,
                                  int B, int H, int T, int S, int d, const long long* layout,
                                  float scale, void* stream) {
  if (lse != nullptr)
    return launch<true, true>(q, k, v, o, lse, qpos, kvalid, causal, B, H, T, S, d, layout,
                              scale, stream);
  return launch<false, true>(q, k, v, o, nullptr, qpos, kvalid, causal, B, H, T, S, d, layout,
                             scale, stream);
}

// K13: causal forward on the packed layout, q/o [B, T, H*d] and k/v
// [B, S, H*d] contiguous, S >= T (query i sees keys j <= i): K1's kernel
// behind maps encoded here.
extern "C" int cullavo_flash_packed(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int T, int S, int d, float scale,
                                    void* stream) {
  if (S < T || B < 1 || H < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long layout[24];
  packed_layout(layout, B, H, T);        // q
  packed_layout(layout + 6, B, H, S);    // k
  packed_layout(layout + 12, B, H, S);   // v
  packed_layout(layout + 18, B, H, T);   // o
  return launch<false, false>(q, k, v, o, nullptr, nullptr, nullptr, 1, B, H, T, S, d, layout,
                              scale, stream);
}

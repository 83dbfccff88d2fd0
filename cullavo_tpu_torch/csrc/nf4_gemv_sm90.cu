// The fused weight-only linears on Hopper (kernels K6, K11, K3 and K14): one
// template over the weight format, written for the H100 with TMA loads into
// an mbarrier ring, the weight decoded in registers straight into the A
// fragments of wgmma, and split-K reduced in the same launch.
//
// Replaces, in cullavo_tpu/ops/nf4.py:
//  * K6 (kPlanar): nf4_linear_planar -> _nf4_planar_sx_kernel (Pallas row
//    10).  Weight [K, N] as int32 words [K/8, N]: bits 4i..4i+3 of word
//    (k8, n) are the code of element (i * K/8 + k8, n); one f32 absmax per
//    (row k, 64-column block): scale [K, N/64].  The "scale on x" arithmetic:
//        y[m, n] = sum_k bf16(f32(x[m, k]) * scale[k, n/64]) * bf16(code[k, n])
//  * K11 (kBytes): nf4_linear_pallas -> _nf4_linear_kernel (row 9) and,
//    through nf4_matmul_fused, _nf4_matmul_kernel (row 8, its absmax decoded
//    before the call).  Weight as bytes [K, N/2]: byte (k, j) holds the code
//    of (k, 2j) in its high nibble and of (k, 2j + 1) in its low nibble; the
//    same scale layout.  The f32 weight w = f32(code * scale) is taken as two
//    bf16 terms, hi = bf16(w) and lo = bf16(w - hi), each against the exact
//    bf16 x:  y[m, n] = sum_k x[m, k] * hi[k, n] + x[m, k] * lo[k, n]
//  * K3 (kInt8): int8_linear_pallas -> _int8_matmul_kernel (row 12), as
//    int8_linear computes it (the scale after the dot):
//        xs = bf16(x * sq_inv)        (only for a dict with sq_inv: a prologue)
//        y[m, n] = bf16( (sum_k xs[m, k] * q8[k, n]) * scale8[n] )
//    Weight int8 [K, N], N % 16 == 0; an int8 code is exact in bf16 and a
//    bf16 product exact in f32, so only the order of the f32 sum differs
//    from the plain version.
//  * K14 (kP32): scripts/matmul_probe.py, p32_pallas -> p32_kernel (row 16):
//    int8 weights packed four to an int32 word, byte j of word (kk, n) the
//    weight of k = j K/4 + kk; the scale per column after the dot, as K3:
//        y[m, n] = bf16( (sum_j sum_kk x[m, j K/4 + kk] * W_j[kk, n]) * scale[n] )
//    Words int32 [K/4, N], N % 4 == 0 (a word row is a multiple of 16 bytes).
// All sum in f32 and round once to bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16).  At decode M, bytes:
// 0.5625 byte per weight for NF4 (the 4-bit code and 1/64 of an f32 scale),
// 1 for int8, against 2 M operations (K11: 4 M with its two terms); at the
// serving M = 64 K6 is 228 operations per byte, close to the card's ~295, so
// the tensor cores must run at ~3/4 of their peak just to keep pace with the
// weight stream.  What limits a kernel here is the work around the stream:
// decoding 4-bit codes (and, for K6, scaling x once per 64-column block)
// costs issue slots and shared memory bandwidth per weight; an int8 code is
// widened exactly in a few ALU instructions.  At prefill M (K3 at M = 5632,
// the vl_test prompts), operations: 2 M K N at the bf16 peak, and the token
// tile grows to 256 (wgmma's widest N) so that one decoded weight stage
// feeds 256 tokens and its decode is small beside the stage's wgmmas.
//
// Design:
//  * orientation: y^T = W^T x^T.  One 64-column block is one wgmma M = 64
//    tile; the tokens are its N side (NT = 16, 32 or 64; K3 also 128 and
//    256; a larger M takes several token tiles, grid z).  x is the K-major B
//    operand.
//  * a CTA: G consumer warpgroups (G = 1, 2 or 4 blocks of 64 columns, one
//    each; K3 1 or 2, for the 256-token accumulator's registers, and at
//    decode M two measured at least as fast as four; a template parameter,
//    so every shared-memory offset folds) and one producer warp.
//    The producer keeps a ring of up to 16 stages of 64 k in flight, each
//    signalled on its full mbarrier: the weight tile by TMA (K11: one box of
//    32G bytes x 64 rows, swizzled over its 32G-byte width; K6: 2G boxes of
//    32 words x 8 word rows, 128-byte swizzle; K3: boxes of min(64G, 128)
//    bytes x 64 rows, swizzled over their width, a box wholly past N not
//    loaded; all conflict-free for the consumers' reads), the x tile
//    [NT][64] by TMA with the 128-byte swizzle, and (NF4) the scales [G][64]
//    by 4-byte cp.async (a scale row need not be 16-byte aligned) through
//    cp.async.mbarrier.arrive.noinc.  K6's stage needs x at 8 planes (k =
//    pl K/8 + 8 i + r): one box of a 3-D map of x (k8, row, plane) brings
//    the eight plane slices as [plane][NT][8].
//    Consumers release a stage on its empty mbarrier; they never wait on a
//    block-wide barrier in the k loop.  They read and write shared memory
//    through plain C++ pointers, so the compiler issues a stage's loads
//    together rather than one dependent chain per k-step.
//  * A from registers (the RS form of wgmma): no decoded weight tile goes to
//    shared memory.  A is double-buffered across stages: a stage decodes
//    while the previous stage's wgmmas run (wait_group 1).
//    - K6: a k-step takes planes (2s, 2s+1) of 8 word rows: column 2t + e +
//      8h of k-step s is plane 2s + e of word row t + 4h.  A thread's four
//      words (rows t and t + 4 of its two columns) hold the A fragments of
//      all 4 k-steps of a stage, byte s of a word being one bf16 pair.  A
//      nibble becomes its bf16 codebook value by byte permutes against the
//      16-entry table held in immediates (no table lookup in memory).
//    - K11: the pair of columns (2j, 2j + 1) of a byte sits in one thread as
//      its fragment rows g and g + 8 (one absmax covers the 64 columns, so
//      the row order is free; the epilogue undoes it).  w = f32(code * s)
//      through a 16-entry f32 table in shared memory, split into hi and lo;
//      two wgmmas per k-step against the same B, one commit per stage.
//    - K3: fragment rows g and g + 8 are the weight columns 2g and 2g + 1 of
//      the warp's 16 (the per-column scale comes after the dot, so the row
//      order is free), so ldmatrix.trans over the byte tile, its 16-bit
//      elements being column pairs, hands each thread the four bytes (k 2t,
//      2t + 1) x (columns 2g, 2g + 1): two ldmatrix.x4 a stage.  Four bytes
//      become two bf16 pairs exactly by byte permutes into the mantissa of
//      2^23, one subtraction each and two permutes that keep the high
//      halves.
//  * x once per CTA: the G warpgroups share the raw x tile.  K11 and K3 use
//    it as B directly.  K6 needs bf16(x * s[:, c]) for its block c: each
//    warpgroup scales the raw tile into its own swizzled B buffer (double
//    buffered), in the permuted column order above, and syncs on its own
//    named barrier.  K3 with sq_inv reads xs, written by a prologue kernel
//    in the same entry point.
//  * split-K over S <= 8 CTAs along K, reduced in the same launch: each CTA
//    sums its K range in registers and writes the partial tile to an f32
//    workspace; the launch is cooperative (all CTAs resident), so once a
//    tile's S partials are in (a per-tile counter) each of its CTAs adds its
//    1/S of the entries over the S partials in split order and writes bf16
//    (K3: times scale8 first), then drops the lines it read unwritten
//    (discard.global.L2): the workspace costs L2 traffic, no device-memory
//    write-back.  Two calls are bit-identical.  (One CTA adding all S
//    partials was the slowest part of the kernel at M = 64.  A cluster along
//    K reduced through distributed shared memory needs no workspace, but on
//    the H100 clusters of 3, 7 and 8 of these CTAs, one per SM, did not
//    co-schedule and ran slower, so the cluster sizes that did left a
//    quarter of the SMs idle at the 7B shapes.)  At prefill M the planner
//    takes S = 1: no workspace.
//  * the plan (NT, G, S) comes from the wrapper's pure planner
//    (ops/nf4.nf4_gemv_plan, ops/nf4.int8_gemv_plan); the entry point checks
//    it and sizes the ring to the shared memory left.
//  * what bounds K6 and K11: the consumers.  With their work taken out, the
//    producer's loads alone run several times faster: the decode's issue
//    slots and shared-memory loads (K11: one table lookup per weight), K6's
//    per-block scaling of x, and wgmma at N = 16 keep the kernels at 5-6x
//    the byte bound on the H100 (chip_smoke.py, phase 3).
//  * K14: a stage is 64 word rows (256 k): 2G boxes of [64][32 words],
//    128-byte swizzle, and four x boxes [NT][64], one per K quarter (k = j K/4
//    + 64 kst + 0..63), each laid out as K3's x tile.  A stage runs as four
//    sub-stages of 16 word rows; per sub-stage a thread loads the words of
//    rows 2t, 2t + 1, 2t + 8, 2t + 9 at its columns 2g, 2g + 1 (fragment rows
//    g, g + 8, as K3; four 8-byte loads, conflict-free under the swizzle),
//    byte permutes gather byte j of two rows into the pair K3 widens, and the
//    four k-steps of the sub-stage (one per quarter, each against its x box)
//    take the A fragments of the same sixteen word rows.  x is read once per
//    CTA and stage by TMA, in its own layout: no copy of x, no prologue.
//  * K3 on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3, card alone,
//    sums over the three 7B shapes): at M = 14 ~0.09-0.10 ms against the
//    0.032 byte bound, under the dense bf16 product on a dequantized weight
//    (0.118); at M = 5632 ~1.9 ms against the 1.22 operations bound, 1.2x
//    that dense product (1.58).  ptxas reports every instantiation of this
//    template serialized (C7513: the A registers are written by the decode
//    while the previous stage's wgmmas may be in flight); two warpgroups
//    interleave around it.
// Launches on the caller's stream and allocates nothing.  The host reaches
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (no -lcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanar = 0, kBytes = 1, kInt8 = 2, kP32 = 3;
constexpr int QB = 64;               // columns per absmax block = rows of a wgmma tile
constexpr int KSTAGE = 64;           // k values per ring stage
constexpr int MAX_STAGES = 16;
constexpr int SMEM_LIMIT = 232448 - 1024;   // one block's 227 KB, less room for static smem
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr uint32_t SC_BYTES = 1024;  // a stage's scales: [G][64] f32, padded

// the NF4 codebook (bitsandbytes), f32
__constant__ float kCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

// the low and high bytes of bf16(kCode[j]), four entries per word (byte q of
// word i is entry 4 i + q)
constexpr uint32_t kLo0 = 0xca063280u, kLo1 = 0x00ba3d92u, kLo2 = 0xad7c25a3u,
                   kLo3 = 0x803910e2u;
constexpr uint32_t kHi0 = 0xbebfbfbfu, kHi1 = 0x00bdbebeu, kHi2 = 0x3e3e3e3du,
                   kHi3 = 0x3f3f3f3eu;

struct Params {
  const float* scale;    // NF4: the absmax [K, N/64]; K3: scale8 [N]; K14: scale [N]
  __nv_bfloat16* out;
  float* ws;     // split-K partial sums, [tile][split][64 G NT] (S > 1)
  int* ctr;      // per output tile: splits done (0 between launches)
  int M, K, N, K8, NB;   // NB = ceil(N / 64); K14: K8 = K / 4, the word rows
  int S, stages, n_kst;
  uint32_t off_bc, off_bar;
};

// ---- shared memory, barriers, copies ----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 4 bytes global -> shared by cp.async; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// the barrier's pending count falls by one when this thread's cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the TMA swizzles as functions of a shared address (1024-byte aligned
// base): 16-byte chunk bits 4.. ^= bits 7.., over span / 16 chunks
template <int SPAN>
__device__ __forceinline__ uint32_t swz(uint32_t a) {
  return a ^ ((a >> 3) & ((SPAN / 16 - 1) << 4));
}

// ---- wgmma ----------------------------------------------------------------------

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

// keep the compiler from reusing registers that an in-flight wgmma owns
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// d += A B, m64nNk16 bf16 -> f32: A (bf16 pairs) from registers, B K-major
// in shared memory (no transpose)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// K3's token tiles of 128 and 256 (one wgmma as wide as the card takes)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- decoding -------------------------------------------------------------------

// four 8 x 8 matrices of 16-bit elements, transposed: lanes 8i .. 8i + 7
// address the rows of matrix i; r[i] holds (row 2t, column g) in its low and
// (row 2t + 1, column g) in its high half (t = lane % 4, g = lane / 4)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}


__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// K3: four int8 bytes (b0 b1 b2 b3, lowest first) -> the bf16 pairs (b0, b2)
// and (b1, b3), exactly: each byte, biased by 128, becomes the mantissa of
// 2^23 (a byte permute), 2^23 + 128 is subtracted, and the high half of an
// f32 holding an integer of at most 8 bits is that integer in bf16
__device__ __forceinline__ void widen_i8(uint32_t w, uint32_t& p02, uint32_t& p13) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(prmt(u, 0x4B000000u, 0x7440u + i)) - 8388736.0f;
  p02 = prmt(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632u);
  p13 = prmt(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K6: the four nibbles in bits 0..15 of v -> bf16 codebook values as two
// pairs (n0 | n1 << 16, n2 | n3 << 16).  A byte permute looks each index up
// among 8 table bytes, so the low 3 bits pick an entry in both halves of the
// table and bit 3 chooses between them.
__device__ __forceinline__ void decode4(uint32_t v, uint32_t& r01, uint32_t& r23) {
  const uint32_t sel = v & 0x7777u;
  const uint32_t m = prmt(0u, 0xFFFFFFFFu, (v >> 1) & 0x4444u);   // 0xFF where bit 3
  const uint32_t lo = (prmt(kLo0, kLo1, sel) & ~m) | (prmt(kLo2, kLo3, sel) & m);
  const uint32_t hi = (prmt(kHi0, kHi1, sel) & ~m) | (prmt(kHi2, kHi3, sel) & m);
  r01 = prmt(lo, hi, 0x5140u);
  r23 = prmt(lo, hi, 0x7362u);
}

// K6: word -> its four planes pairs (byte s = planes 2s, 2s + 1)
__device__ __forceinline__ void decode_word(uint32_t w, uint32_t (&r)[4]) {
  decode4(w, r[0], r[1]);
  decode4(w >> 16, r[2], r[3]);
}

// K11: two weights w0, w1 -> their hi and lo bf16 terms, as pairs
__device__ __forceinline__ void split2(float w0, float w1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(w0, w1);
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xFFFF0000u);
  lo = pack_bf16(__fsub_rn(w0, h0), __fsub_rn(w1, h1));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// ---- the kernel -----------------------------------------------------------------

// grid (S, ceil(NB / G), ceil(M / NT)); block 128 G + 32:
// warps 0 .. 4G - 1 are the consumer warpgroups (one 64-column block each),
// warp 4G the producer.  Shared memory is read and written through plain
// C++ pointers (the compiler batches a stage's loads), ordered by the
// barrier and wgmma asm statements, which clobber memory.  Every stage sits
// at a 1024-byte boundary, so a swizzled offset within a stage is the same
// in every stage and is computed once.  A stage holds the weight tile, the x
// tile [NT][64] and (NF4) the scales [G][64]; K3's weight tile is NBOX boxes
// of [64][BOXW] bytes, BOXW = min(64 G, 128); K14's stage is 2G boxes of
// [64][32] words and four x tiles [NT][64].
template <int FMT, int NT, int G>
__global__ void __launch_bounds__(128 * G + 32, 1)
nf4_gemv_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
                const Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float lut[16];
  constexpr int NACC = NT / 2;
  constexpr bool kQ8 = FMT == kInt8, kP = FMT == kP32;
  constexpr bool kAfter = kQ8 || kP;   // scale per column after the dot: no scale tile
  // stage: weights, x [NT][64] (K14: four), scales
  constexpr uint32_t OFF_X = (kP ? 16384u : kQ8 ? 4096u : 2048u) * G;
  constexpr uint32_t OFF_SC = OFF_X + (kP ? 512u : 128u) * NT;
  constexpr uint32_t STAGE = OFF_SC + (kAfter ? 0u : SC_BYTES);
  constexpr int BOXW = 64 * G < 128 ? 64 * G : 128, NBOX = 64 * G / BOXW;
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // the same byte, as a generic pointer
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x;                 // the CTA's split of K
  const int col0 = blockIdx.y * G * QB;        // first weight column of the CTA
  const int m0 = blockIdx.z * NT;              // first token
  const int kst0 = static_cast<int>(static_cast<long long>(rank) * p.n_kst / p.S);
  const int kst1 = static_cast<int>(static_cast<long long>(rank + 1) * p.n_kst / p.S);
  const int n_local = kst1 - kst0;             // this split's stages of 64 k
  const uint32_t bar_full = base + p.off_bar, bar_empty = bar_full + 8 * MAX_STAGES;

  if (tid < 16) lut[tid] = kCode[tid];
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bar_full + 8 * s, kAfter ? 1 : 33);   // the TMA thread (+ 32 cp.async arrivals)
      mbar_init(bar_empty + 8 * s, 4 * G);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (warp == 4 * G) {
    // ---- producer ----
    // TMA: the weight tile (K11: one [64][32G] box; K6: 2G boxes of [8][32]
    // words; K3: NBOX boxes of [64][BOXW] bytes) and the x tile [NT][64];
    // cp.async (NF4): the scales [G][64]
    int st = 0;
    uint32_t ph = 0;
    // K3: a box wholly past N is not loaded (its warpgroups store nothing)
    const int nbox = kQ8 ? min(NBOX, (p.N - col0 + BOXW - 1) / BOXW) : 0;
    for (int i = 0; i < n_local; ++i) {
      const int kst = kst0 + i;
      mbar_wait(bar_empty + 8 * st, ph ^ 1);   // the first round finds every stage free
      const uint32_t sb = base + st * STAGE, full = bar_full + 8 * st;
      if constexpr (kP) {
        // K14: the words of rows 64 kst .. + 63 in boxes of 32 columns (a box
        // wholly past N not loaded), then x at the four quarters' k
        if (lane == 0) {
          const int nb = min(2 * G, (p.N - col0 + 31) / 32);
          mbar_expect_tx(full, nb * 8192u + 512u * NT);
#pragma unroll
          for (int b = 0; b < 2 * G; ++b)
            if (b < nb) tma_load(sb + b * 8192, &tm_w, full, col0 + 32 * b, kst * KSTAGE);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load(sb + OFF_X + j * 128 * NT, &tm_x, full, j * p.K8 + kst * KSTAGE, m0);
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
        continue;
      }
      if constexpr (kQ8) {
        if (lane == 0) {
          mbar_expect_tx(full, nbox * 64u * BOXW + 128u * NT);
#pragma unroll
          for (int b = 0; b < NBOX; ++b)
            if (b < nbox) tma_load(sb + b * 64 * BOXW, &tm_w, full, col0 + b * BOXW, kst * KSTAGE);
          tma_load(sb + OFF_X, &tm_x, full, kst * KSTAGE, m0);
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
        continue;
      }
      if (lane == 0) {
        mbar_expect_tx(full, STAGE - SC_BYTES);
        if (FMT == kBytes) {
          tma_load(sb, &tm_w, full, col0 / 2, kst * KSTAGE);
          tma_load(sb + OFF_X, &tm_x, full, kst * KSTAGE, m0);
        } else {
#pragma unroll
          for (int b = 0; b < 2 * G; ++b)
            tma_load(sb + b * 1024, &tm_w, full, col0 + 32 * b, kst * 8);
          tma_load3(sb + OFF_X, &tm_x, full, kst * 8, m0, 0);   // [plane][NT][8]
        }
      }
      // row j of the stage: K11 k = 64 kst + j; K6 k = plane * K/8 + 8 kst + r, j = 8 plane + r
      auto row_k = [&](int j, int& k) {
        if (FMT == kBytes) {
          k = kst * KSTAGE + j;
          return k < p.K;
        }
        const int k8 = kst * 8 + (j & 7);
        k = (j >> 3) * p.K8 + k8;
        return k8 < p.K8;
      };
      for (int e = lane; e < KSTAGE * G; e += 32) {
        const int c = e / KSTAGE, j = e % KSTAGE, blk = col0 / QB + c;
        int k;
        const bool ok = row_k(j, k) && blk < p.NB;
        const float* src = ok ? p.scale + static_cast<long long>(k) * p.NB + blk : p.scale;
        cp_async4(sb + OFF_SC + 4 * e, src, ok ? 4u : 0u);
      }
      cp_async_arrive(full);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
  } else if constexpr (kQ8) {
    // ---- K3 consumers ----
    // fragment rows g and g + 8 of warp w are the weight columns 16 w + 2g
    // and 16 w + 2g + 1 of the block.  ldmatrix.x4.trans over half a stage
    // (32 k): lane 8 i + r addresses k row 32 h + 8 i + r (= 32 h + lane) at
    // the warp's 16 bytes, 64 c + 16 w, of the tile's row; matrix i gives
    // k-step 2 h + i / 2, k 2t, 2t + 1 (i even) or 2t + 8, 2t + 9 (i odd).
    const int c = warp >> 2, w = warp & 3;
    uint32_t lofs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 64 * c + 16 * w, k = 32 * h + lane;
      lofs[h] = (col / BOXW) * 64 * BOXW + swz<BOXW>(k * BOXW + col % BOXW);
    }
    uint32_t a0[4][4], a1[4][4];
    auto stage = [&](int st, uint32_t ph, int prev, bool release, uint32_t (&a)[4][4],
                     uint32_t (&other)[4][4]) {
      mbar_wait(bar_full + 8 * st, ph);
      const uint32_t sb = base + st * STAGE;
      uint32_t r[2][4];
      ldsm_x4_trans(r[0], sb + lofs[0]);
      ldsm_x4_trans(r[1], sb + lofs[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          widen_i8(r[h][i], a[2 * h + (i >> 1)][2 * (i & 1)], a[2 * h + (i >> 1)][2 * (i & 1) + 1]);
      const uint64_t dx = smem_desc(sb + OFF_X, 16, 1024);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, a[ks], dx + ((32 * ks) >> 4));
      wg_commit();
      // the previous stage's wgmmas are done: its A registers and x are free
      wg_wait<1>();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs(other[ks]);
      if (release && lane == 0) mbar_arrive(bar_empty + 8 * prev);
    };
    int st = 0, prev = 0;
    uint32_t ph = 0;
    for (int i = 0; i < n_local; i += 2) {
      stage(st, ph, prev, i > 0, a0, a1);
      prev = st;
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
      if (i + 1 < n_local) {
        stage(st, ph, prev, true, a1, a0);
        prev = st;
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    wg_wait<0>();
    fence_regs(acc);
  } else if constexpr (kP) {
    // ---- K14 consumers ----
    // fragment rows g and g + 8 of warp w are the weight columns 16 w + 2g
    // and 16 w + 2g + 1 of the block (as K3), in box 2c + w / 2 at words
    // 16 (w & 1) + 2g, + 1.  Sub-stage q takes word rows 16 q + 2t + {0, 1,
    // 8, 9}: one 8-byte load each (the two columns); byte j of rows (2t,
    // 2t + 1) and (2t + 8, 2t + 9) are A's k pairs of k-step j, whose B is
    // quarter j's x box at k 16 q.
    const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    uint32_t wofs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wofs[i] = (2 * c + (w >> 1)) * 8192u +
                swz<128>((2 * t + (i & 1) + 8 * (i >> 1)) * 128 + 64 * (w & 1) + 8 * g);
    uint32_t a0[4][4], a1[4][4];
    auto sub = [&](uint32_t sb, int q, uint32_t (&a)[4][4], uint32_t (&other)[4][4]) {
      const uint8_t* sm = gbase + (sb - base);
      uint2 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = *reinterpret_cast<const uint2*>(sm + wofs[i] + 2048 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t u0 = e ? v[2 * h].y : v[2 * h].x, u1 = e ? v[2 * h + 1].y : v[2 * h + 1].x;
          widen_i8(prmt(u0, u1, 0x5410u), a[0][2 * h + e], a[1][2 * h + e]);   // bytes 0, 1
          widen_i8(prmt(u0, u1, 0x7632u), a[2][2 * h + e], a[3][2 * h + e]);   // bytes 2, 3
        }
      const uint64_t dx = smem_desc(sb + OFF_X, 16, 1024);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs(acc, a[j], dx + ((j * 128 * NT + 32 * q) >> 4));
      wg_commit();
      // the previous sub-stage's wgmmas are done: its A registers are free
      wg_wait<1>();
#pragma unroll
      for (int j = 0; j < 4; ++j) fence_regs(other[j]);
    };
    int st = 0, prev = 0;
    uint32_t ph = 0;
    for (int i = 0; i < n_local; ++i) {
      mbar_wait(bar_full + 8 * st, ph);
      const uint32_t sb = base + st * STAGE;
      sub(sb, 0, a0, a1);
      // the previous stage's last wgmmas are done: its words and x are free
      if (i > 0 && lane == 0) mbar_arrive(bar_empty + 8 * prev);
      sub(sb, 1, a1, a0);
      sub(sb, 2, a0, a1);
      sub(sb, 3, a1, a0);
      prev = st;
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs(acc);
  } else if (FMT == kBytes) {
    // ---- K11 consumers ----
    constexpr uint32_t PITCH = 32u * G;            // bytes per k row of the weight tile
    const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
    // rows 16 ks + 2 t + {0, 1, 8, 9}, byte column 32 c + 8 w + g
    uint32_t wofs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wofs[q] = swz<PITCH>((2 * t + (q & 1) + 8 * (q >> 1)) * PITCH + 32 * c + 8 * w + g);
    const uint32_t sofs = OFF_SC + 4 * (64 * c + 2 * t);   // scales of rows 2t, 2t + 1
    // rows g (column 2j: the high nibble) and g + 8 (2j + 1: the low one);
    // fragment registers 0, 1: columns 2t, 2t + 1; 2, 3: 2t + 8, 2t + 9.
    // A is double-buffered across stages, so a stage decodes while the
    // previous stage's wgmmas run.
    uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
    auto stage = [&](int st, uint32_t ph, int prev, bool release, uint32_t (&ahi)[4][4],
                     uint32_t (&alo)[4][4], uint32_t (&ohi)[4][4], uint32_t (&olo)[4][4]) {
      mbar_wait(bar_full + 8 * st, ph);
      const uint32_t sb = base + st * STAGE;
      const uint8_t* sm = gbase + (sb - base);
      uint32_t b[4][4];
      float2 s[4][2];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) b[ks][q] = sm[wofs[q] + 16 * ks * PITCH];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[ks][h] = *reinterpret_cast<const float2*>(sm + sofs + 4 * (16 * ks + 8 * h));
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b0 = b[ks][2 * h], b1 = b[ks][2 * h + 1];
          const float s0 = s[ks][h].x, s1 = s[ks][h].y;
          split2(__fmul_rn(lut[b0 >> 4], s0), __fmul_rn(lut[b1 >> 4], s1), ahi[ks][2 * h],
                 alo[ks][2 * h]);
          split2(__fmul_rn(lut[b0 & 15], s0), __fmul_rn(lut[b1 & 15], s1), ahi[ks][2 * h + 1],
                 alo[ks][2 * h + 1]);
        }
      const uint64_t dx = smem_desc(sb + OFF_X, 16, 1024);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_rs(acc, ahi[ks], dx + ((32 * ks) >> 4));
        wgmma_rs(acc, alo[ks], dx + ((32 * ks) >> 4));
      }
      wg_commit();
      // the previous stage's wgmmas are done: its A registers and x are free
      wg_wait<1>();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        fence_regs(ohi[ks]);
        fence_regs(olo[ks]);
      }
      if (release && lane == 0) mbar_arrive(bar_empty + 8 * prev);
    };
    int st = 0, prev = 0;
    uint32_t ph = 0;
    for (int i = 0; i < n_local; i += 2) {
      stage(st, ph, prev, i > 0, hi0, lo0, hi1, lo1);
      prev = st;
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
      if (i + 1 < n_local) {
        stage(st, ph, prev, true, hi1, lo1, hi0, lo0);
        prev = st;
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    wg_wait<0>();
    fence_regs(acc);
  } else {
    // ---- K6 consumers ----
    const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3, ctid = tid & 127;
    // decode role: word u (row t + 4 (u >> 1), column 16 w + g + 8 (u & 1) of
    // box 2c + w/2) gives fragment register u of every k-step: rows g / g + 8,
    // columns 2t, 2t + 1 / 2t + 8, 2t + 9
    uint32_t wofs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      wofs[u] = swz<128>((2 * c + (w >> 1)) * 1024 + (t + 4 * (u >> 1)) * 128 +
                         4 * (16 * (w & 1) + g + 8 * (u & 1)));
    // scaling role: chunk q = (k-step s, half h) of the B row, rows mr + 16 r;
    // the x tile is [plane][NT][8]
    const int q = ctid >> 4, ss = q >> 1, hh = q & 1, mr = ctid & 15;
    const uint32_t xofs0 = OFF_X + ((2 * ss) * NT + mr) * 16 + 8 * hh;
    const uint32_t xofs1 = xofs0 + NT * 16;
    const uint32_t bofs = swz<128>(mr * 128 + (2 * ss + hh) * 16);
    const uint32_t sofs0 = OFF_SC + 4 * (64 * c + 16 * ss + 4 * hh);   // plane 2s
    const uint32_t sofs1 = sofs0 + 4 * 8;                              // plane 2s + 1
    uint32_t a0[4][4], a1[4][4];
    auto stage = [&](int st, uint32_t ph, uint32_t (&a)[4][4], uint32_t (&other)[4][4],
                     int buf) {
      mbar_wait(bar_full + 8 * st, ph);
      const uint32_t sb = base + st * STAGE;
      const uint8_t* sm = gbase + (sb - base);
      // the stage's loads, all at once: 4 words, 8 scales, the x rows
      uint32_t wd[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wd[u] = *reinterpret_cast<const uint32_t*>(sm + wofs[u]);
      const float4 s0 = *reinterpret_cast<const float4*>(sm + sofs0);
      const float4 s1 = *reinterpret_cast<const float4*>(sm + sofs1);
      const float sc0[4] = {s0.x, s0.y, s0.z, s0.w}, sc1[4] = {s1.x, s1.y, s1.z, s1.w};
      uint2 v0[NT / 16], v1[NT / 16];
#pragma unroll
      for (int r = 0; r < NT / 16; ++r) {
        v0[r] = *reinterpret_cast<const uint2*>(sm + xofs0 + 256 * r);
        v1[r] = *reinterpret_cast<const uint2*>(sm + xofs1 + 256 * r);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t d[4];
        decode_word(wd[u], d);
#pragma unroll
        for (int s = 0; s < 4; ++s) a[s][u] = d[s];
      }
      // B[m][16 s + 2 t + e + 8 h] = bf16(x[m, (2s + e) K/8 + 8 kst + 4h + t] * scale)
      // (x past K/8 arrives as zeros)
      const uint32_t bc = base + p.off_bc + (buf * G + c) * NT * 128;
      uint8_t* bm = gbase + (bc - base);
#pragma unroll
      for (int r = 0; r < NT / 16; ++r) {
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w0 = e < 2 ? v0[r].x : v0[r].y, w1 = e < 2 ? v1[r].x : v1[r].y;
          const float f0 = e & 1 ? bf16_hi(w0) : bf16_lo(w0);
          const float f1 = e & 1 ? bf16_hi(w1) : bf16_lo(w1);
          o[e] = pack_bf16(__fmul_rn(f0, sc0[e]), __fmul_rn(f1, sc1[e]));
        }
        *reinterpret_cast<uint4*>(bm + bofs + 2048 * r) = make_uint4(o[0], o[1], o[2], o[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + c, 128);
      const uint64_t db = smem_desc(bc, 16, 1024);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a[s], db + ((32 * s) >> 4));
      wg_commit();
      wg_wait<1>();
#pragma unroll
      for (int s = 0; s < 4; ++s) fence_regs(other[s]);
    };
    int st = 0;
    uint32_t ph = 0;
    for (int i = 0; i < n_local; i += 2) {
      stage(st, ph, a0, a1, 0);
      if (++st == p.stages) {
        st = 0;
        ph ^= 1;
      }
      if (i + 1 < n_local) {
        stage(st, ph, a1, a0, 1);
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    wg_wait<0>();
    fence_regs(acc);
  }

  // ---- epilogue: acc entry 4 j + e is row 16 w + g + 8 (e >> 1) of the block
  // (K6: that column; K11, K3, K14: column 16 w + 2 g + (e >> 1)), token 8 j +
  // 2 t + (e & 1); K3 and K14 scale the f32 sum by the column's scale, then round
  const bool consumer = warp < 4 * G;
  const int c = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3, ctid = tid & 127;
  auto store = [&](int i, float v) {
    const int j = i >> 2, e = i & 3;
    const int n = col0 + c * QB +
                  (FMT != kPlanar ? 16 * w + 2 * g + (e >> 1) : 16 * w + g + 8 * (e >> 1));
    const int m = m0 + 8 * j + 2 * t + (e & 1);
    if (m < p.M && n < p.N) {
      if (kAfter) v = __fmul_rn(v, p.scale[n]);
      p.out[static_cast<long long>(m) * p.N + n] = __float2bfloat16_rn(v);
    }
  };
  if (p.S == 1) {
    if (consumer) {
      if constexpr (kAfter) {
        // columns n, n + 1 (both below N or both not: N is even) as one pair
        const int n = col0 + c * QB + 16 * w + 2 * g;
        if (n < p.N) {
          const float s0 = p.scale[n], s1 = p.scale[n + 1];
#pragma unroll
          for (int i = 0; i < NACC; i += 4)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = m0 + 2 * i + 2 * t + e;   // token 8 (i / 4) + 2 t + e
              if (m < p.M)
                *reinterpret_cast<uint32_t*>(p.out + static_cast<long long>(m) * p.N + n) =
                    pack_bf16(__fmul_rn(acc[i + e], s0), __fmul_rn(acc[i + 2 + e], s1));
            }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NACC; ++i) store(i, acc[i]);
      }
    }
    return;
  }
  // split-K: this split's partial sums to the workspace ([c][i][ctid], so
  // the stores coalesce); once the tile's S splits are in (the launch is
  // cooperative: every CTA is resident), each adds its share of the entries
  // over the S partials in split order, so the result does not depend on
  // which split finishes first, and drops the partials' L2 lines unwritten
  // (discard.global.L2: the workspace costs L2 traffic, no device-memory
  // write-back).  The last split done resets the tile's two counters.
  __shared__ int last;
  constexpr int TILE_F = 64 * G * NT;
  const int tile = blockIdx.z * gridDim.y + blockIdx.y;
  float* const ws = p.ws + static_cast<long long>(tile) * p.S * TILE_F;
  int* const arrived = p.ctr + 2 * tile;
  if (consumer) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) __stcg(ws + rank * TILE_F + (c * NACC + i) * 128 + ctid, acc[i]);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    atomicAdd(arrived, 1);
    while (atomicAdd(arrived, 0) < p.S) __nanosleep(64);
  }
  __syncthreads();
  __threadfence();
  const int i0 = rank * NACC / p.S, i1 = (rank + 1) * NACC / p.S;
  if (consumer) {
    // 8 entries x up to 8 splits in flight at a time, then the sums in order
#pragma unroll
    for (int ib = 0; ib < NACC; ib += 8) {
      if (ib + 8 <= i0 || ib >= i1) continue;
      float part[8][8];
#pragma unroll
      for (int di = 0; di < 8; ++di)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ib + di;
          part[di][r] = r < p.S && i >= i0 && i < i1
                            ? __ldcg(ws + r * TILE_F + (c * NACC + i) * 128 + ctid)
                            : 0.f;
        }
#pragma unroll
      for (int di = 0; di < 8; ++di) {
        const int i = ib + di;
        if (i < i0 || i >= i1) continue;
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r < p.S) v += part[di][r];
        store(i, v);
      }
    }
  }
  __syncthreads();
  // this CTA's share of every split: entries [i0, i1) of each warpgroup,
  // 128 floats (four 128-byte lines) per entry
  for (int l = tid; l < p.S * G * (i1 - i0) * 4; l += blockDim.x) {
    const int line = l & 3, e = l >> 2, r = e / (G * (i1 - i0)), rest = e % (G * (i1 - i0));
    const int cc = rest / (i1 - i0), i = i0 + rest % (i1 - i0);
    asm volatile("discard.global.L2 [%0], 128;\n" ::"l"(ws + r * TILE_F + (cc * NACC + i) * 128 + 32 * line)
                 : "memory");
  }
  if (tid == 0 && atomicAdd(arrived + 1, 1) == p.S - 1) {
    arrived[0] = 0;   // ready for the next launch
    arrived[1] = 0;
  }
}

// ---- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 2-D map: inner extent n0 (contiguous), outer n1 rows of `stride` bytes
bool encode2d(CUtensorMap* map, EncodeTiled fn, CUtensorMapDataType type, const void* ptr,
              long long n0, long long n1, long long stride, uint32_t box0, uint32_t box1,
              CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n0), static_cast<cuuint64_t>(n1)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {box0, box1};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K6's x [M, 8 xp] bf16 as a 3-D map (k8 within a plane, row m, plane), box
// (8, NT, 8)
bool encode_x3(CUtensorMap* map, EncodeTiled fn, const void* x, int xp, int M, uint32_t nt) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(xp), static_cast<cuuint64_t>(M), 8};
  const cuuint64_t strides[2] = {16ull * xp, 2ull * xp};
  const cuuint32_t box[3] = {8, nt, 8};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int FMT, int NT, int G>
int launch(const void* x, const void* wq, const void* scale, void* out, void* ws, void* ctr, int M,
           int K, int N, int xp, int S, cudaStream_t stream) {
  const int n_kst = ((FMT == kP32 ? K / 4 : K) + KSTAGE - 1) / KSTAGE;
  // K3 takes N % 16 == 0, K14 N % 4 == 0 (its word rows are 16-byte multiples)
  constexpr int NALIGN = FMT == kInt8 ? 16 : FMT == kP32 ? 4 : QB;
  const int nb = (N + QB - 1) / QB;
  if (M < 1 || K < 8 || K % 8 || N < NALIGN || N % NALIGN || G > nb || S < 1 || S > 8 ||
      S > n_kst || (S > 1 && (ws == nullptr || ctr == nullptr)) ||
      (FMT == kPlanar && (xp < K / 8 || xp % 8 || xp > 8 * n_kst)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wq) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_w, tm_x;
  bool ok;
  if (FMT == kP32) {
    // the words [K/4, N]: boxes of 32 words x 64 rows, 128-byte swizzle
    // (zeros past N and K/4); x [M, K] as K3's, one box per quarter
    ok = encode2d(&tm_w, fn, CU_TENSOR_MAP_DATA_TYPE_INT32, wq, N, K / 4, 4LL * N, 32, KSTAGE,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode2d(&tm_x, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, KSTAGE, NT,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (FMT == kInt8) {
    // the weight tile: boxes of min(64 G, 128) bytes x 64 rows, swizzled
    // over their width (zeros past N and K); x [M, K] as K11's
    constexpr int BOXW = 64 * G < 128 ? 64 * G : 128;
    ok = encode2d(&tm_w, fn, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K, N, BOXW, KSTAGE,
                  BOXW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode2d(&tm_x, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, KSTAGE, NT,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  } else if (FMT == kBytes) {
    // the weight tile: one box of the CTA's 32 G bytes x 64 rows, swizzled over its width
    const CUtensorMapSwizzle sw = G == 1   ? CU_TENSOR_MAP_SWIZZLE_32B
                                  : G == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_128B;
    ok = encode2d(&tm_w, fn, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N / 2, K, N / 2, 32 * G, KSTAGE,
                  sw) &&
         encode2d(&tm_x, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, KSTAGE, NT,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    // x [M, 8 xp] as (k8, m, plane): a box of (8, NT, 8) is a stage's eight
    // plane slices, [plane][NT][8]
    ok = encode2d(&tm_w, fn, CU_TENSOR_MAP_DATA_TYPE_INT32, wq, N, K / 8, 4LL * N, 32, 8,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_x3(&tm_x, fn, x, xp, M, NT);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.scale = static_cast<const float*>(scale);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = static_cast<float*>(ws);
  p.ctr = static_cast<int*>(ctr);
  p.M = M, p.K = K, p.N = N, p.K8 = FMT == kP32 ? K / 4 : K / 8, p.NB = nb;
  p.S = S, p.n_kst = n_kst;
  const uint32_t stage_bytes = FMT == kP32   ? 16384u * G + 512u * NT
                               : FMT == kInt8 ? 4096u * G + 128u * NT
                                              : 2048u * G + 128u * NT + SC_BYTES;
  const uint32_t bc = FMT == kPlanar ? 256u * G * NT : 0u;   // K6's B buffers, 2 per warpgroup
  const int longest = (n_kst + S - 1) / S;
  const int fit = static_cast<int>((SMEM_LIMIT - 1024 - BAR_BYTES - bc) / stage_bytes);
  p.stages = fit < longest ? fit : longest;
  if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
  // a consumer frees a stage once it has begun the next, so a ring of one
  // stage takes no second
  if (p.stages < 1 || (p.stages < 2 && longest > 1)) return static_cast<int>(cudaErrorInvalidValue);
  p.off_bc = p.stages * stage_bytes;
  p.off_bar = p.off_bc + bc;
  const int smem = static_cast<int>(p.off_bar + BAR_BYTES + 1024);

  static bool attr = false;   // once per instantiation
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        nf4_gemv_kernel<FMT, NT, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  // split-K waits for a tile's S CTAs: launched cooperatively (every CTA
  // resident at once, or the launch fails)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (nb + G - 1) / G, (M + NT - 1) / NT);
  cfg.blockDim = dim3(128 * G + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = S > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, nf4_gemv_kernel<FMT, NT, G>, tm_w, tm_x, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int FMT, int NT>
int dispatch_g(const void* x, const void* wq, const void* scale, void* out, void* ws, void* ctr,
               int M, int K, int N, int xp, int G, int S, cudaStream_t st) {
  if (G == 1) return launch<FMT, NT, 1>(x, wq, scale, out, ws, ctr, M, K, N, xp, S, st);
  if (G == 2) return launch<FMT, NT, 2>(x, wq, scale, out, ws, ctr, M, K, N, xp, S, st);
  if (G == 4) return launch<FMT, NT, 4>(x, wq, scale, out, ws, ctr, M, K, N, xp, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int FMT>
int dispatch(const void* x, const void* wq, const void* scale, void* out, void* ws, void* ctr,
             int M, int K, int N, int xp, int nt, int G, int S, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt == 16) return dispatch_g<FMT, 16>(x, wq, scale, out, ws, ctr, M, K, N, xp, G, S, st);
  if (nt == 32) return dispatch_g<FMT, 32>(x, wq, scale, out, ws, ctr, M, K, N, xp, G, S, st);
  if (nt == 64) return dispatch_g<FMT, 64>(x, wq, scale, out, ws, ctr, M, K, N, xp, G, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3: one or two 64-column blocks a CTA at every token tile (a 64 x 256 f32
// accumulator per thread of a warpgroup leaves room for at most two
// warpgroups; at decode M two measured at least as fast as four)
template <int NT>
int launch_int8(const void* x, const void* q8, const void* scale8, void* out, void* ws, void* ctr,
                int M, int K, int N, int G, int S, cudaStream_t st) {
  if (G == 1) return launch<kInt8, NT, 1>(x, q8, scale8, out, ws, ctr, M, K, N, 0, S, st);
  if (G == 2) return launch<kInt8, NT, 2>(x, q8, scale8, out, ws, ctr, M, K, N, 0, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_int8(const void* x, const void* q8, const void* scale8, void* out, void* ws, void* ctr,
                  int M, int K, int N, int nt, int G, int S, cudaStream_t st) {
  if (nt == 16) return launch_int8<16>(x, q8, scale8, out, ws, ctr, M, K, N, G, S, st);
  if (nt == 32) return launch_int8<32>(x, q8, scale8, out, ws, ctr, M, K, N, G, S, st);
  if (nt == 64) return launch_int8<64>(x, q8, scale8, out, ws, ctr, M, K, N, G, S, st);
  if (nt == 128) return launch_int8<128>(x, q8, scale8, out, ws, ctr, M, K, N, G, S, st);
  if (nt == 256) return launch_int8<256>(x, q8, scale8, out, ws, ctr, M, K, N, G, S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3's prologue for a dict with sq_inv: xs[m, k] = bf16(x[m, k] * sq_inv[k]),
// the one rounding of int8_linear; eight values a thread
__global__ void int8_linear_prep(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ sq_inv,
                                 __nv_bfloat16* __restrict__ xs, int K, long long n8) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const int k0 = static_cast<int>((8 * i) % K);
  const uint4 xv = reinterpret_cast<const uint4*>(x)[i];
  const uint4 sv = *reinterpret_cast<const uint4*>(sq_inv + k0);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(&sv);
  uint4 o;
  uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 a = __bfloat1622float2(xp[j]), b = __bfloat1622float2(sp[j]);
    op[j] = pack_bf16(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  reinterpret_cast<uint4*>(xs)[i] = o;
}

}  // namespace

// K6: x bf16 [M, 8 xp] (16-byte aligned), plane pl's values at columns
// [pl xp, pl xp + K/8) and zeros to pl xp + xp (xp = K/8 where K/8 % 8 == 0,
// else the wrapper pads each plane to a multiple of 8: the map's plane
// stride must be a multiple of 16 bytes); words int32 [K/8, N]; scale f32
// [K, N/64]; out bf16 [M, N].  K % 8 == 0, N % 64 == 0.  (nt, G, S): the
// token tile, 64-column blocks per CTA and splits along K, as nf4_gemv_plan
// gives them; for S > 1 (a grid of at most one CTA per SM), ws: f32
// workspace of S * ceil(N / 64G) * ceil(M / nt) * 64 G nt, ctr: two int32
// per (column, token) tile, zero (the kernel leaves them zero).
extern "C" int cullavo_nf4_gemv_planar(const void* x, const void* words, const void* scale,
                                       void* out, void* ws, void* ctr, int M, int K, int N,
                                       int xp, int nt, int G, int S, void* stream) {
  return dispatch<kPlanar>(x, words, scale, out, ws, ctr, M, K, N, xp, nt, G, S, stream);
}

// K11: x bf16 [M, K] (16-byte aligned); q4 uint8 [K, N/2]; scale f32
// [K, N/64]; out bf16 [M, N]; the same conditions, plan and scratch.
extern "C" int cullavo_nf4_gemv_q4(const void* x, const void* q4, const void* scale, void* out,
                                   void* ws, void* ctr, int M, int K, int N, int nt, int G, int S,
                                   void* stream) {
  return dispatch<kBytes>(x, q4, scale, out, ws, ctr, M, K, N, 0, nt, G, S, stream);
}

// K14: x bf16 [M, K] (16-byte aligned); w32 int32 [K/4, N] (16-byte
// aligned), byte j of word (kk, n) the int8 weight of k = j K/4 + kk; scale
// f32 [N]; out bf16 [M, N].  K % 8 == 0, N % 4 == 0.  (nt, G, S) as
// p32_gemv_plan gives them (nt 16, 32 or 64; G 1, 2 or 4); ws and ctr as for
// K6.
extern "C" int cullavo_p32_linear(const void* x, const void* w32, const void* scale, void* out,
                                  void* ws, void* ctr, int M, int K, int N, int nt, int G, int S,
                                  void* stream) {
  return dispatch<kP32>(x, w32, scale, out, ws, ctr, M, K, N, 0, nt, G, S, stream);
}

// K3: x bf16 [M, K] (16-byte aligned); sq_inv bf16 [K] or null (16-byte
// aligned); q8 int8 [K, N] (16-byte aligned); scale8 f32 [N]; xs: bf16 [M, K]
// scratch for bf16(x * sq_inv) (16-byte aligned; unused without sq_inv); out
// bf16 [M, N].  K % 8 == 0 (x's rows are a tensor map's 16-byte strides),
// N % 16 == 0.  (nt, G, S) as int8_gemv_plan gives them (nt up to 256, G 1
// or 2); ws and ctr as for K6.
extern "C" int cullavo_int8_linear(const void* x, const void* sq_inv, const void* q8,
                                   const void* scale8, void* xs, void* out, void* ws, void* ctr,
                                   int M, int K, int N, int nt, int G, int S, void* stream) {
  if (M < 1 || K < 8 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  const void* xin = x;
  if (sq_inv != nullptr) {
    if (xs == nullptr || reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(sq_inv) % 16 || reinterpret_cast<uintptr_t>(xs) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const long long n8 = static_cast<long long>(M) * K / 8;
    int8_linear_prep<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(sq_inv),
        static_cast<__nv_bfloat16*>(xs), K, n8);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xin = xs;
  }
  return dispatch_int8(xin, q8, scale8, out, ws, ctr, M, K, N, nt, G, S,
                       static_cast<cudaStream_t>(stream));
}

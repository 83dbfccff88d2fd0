// Planar NF4 weights: the fused dequant-matmul for small M (kernel K6) and
// the dequant-once pass in front of a dense matmul for large M (kernel K7).
//
// Replaces: cullavo_tpu/ops/nf4.py, nf4_linear_planar -> _nf4_planar_sx_kernel
// (K6) and nf4_dequant_planar_pallas -> _nf4_dequant_kernel (K7).  The weight
// [K, N] is stored as int32 words [K/8, N]: bits 4i..4i+3 of word[k8, n] are
// the NF4 code of element (i * K/8 + k8, n), with one f32 absmax scale per
// (row k, 64-column block): scale [K, N/64].
//
//   K6:  y[m, n] = sum_k bf16(f32(x[m, k]) * scale[k, n/64]) * bf16(code[k, n])
//        with k = i * K/8 + k8, products accumulated in f32, rounded once to
//        bf16 (the "scale on x" arithmetic of the TPU kernel: the scale is
//        constant along a 64-column block, so it is folded into the
//        activations of that block and the weight operand is the bare
//        16-entry codebook value).
//   K7:  w[k, n] = bf16(code_f32[k, n] * scale[k, n/64])        (bit-exact)
//
// Bound on the H100: bytes, for both.  K6 reads 0.5 byte per weight plus the
// scales (0.5625 byte in all) against 2 * M operations per weight; at
// M <= 511 that stays below the card's ~295 bf16 operations per byte for the
// 4-bit stream.  K7 reads 0.5625 and writes 2 bytes per weight.
//
// K6 design.  A block owns ONE 64-column scale block (so its activations are
// scaled once per k, not per weight), all rows of x (up to 128, 256 or 512,
// picked by M: every weight word is decoded once per block, never once per
// M-tile) and a range of k8 rows (deterministic split-K over blockIdx.y:
// partial sums go to a caller-allocated f32 workspace and a second kernel
// adds them in split order).  Per chunk of 16 k8 rows the block decodes the
// [16, 64] words into 8 planes x 16 rows of bf16 codebook values in shared
// memory (a 16-entry table in shared memory; one word yields eight k rows
// K/8 apart), scales the eight matching 16-wide slices of x into a bf16
// [rows, 128] tile, and runs mma.sync m16n8k16 bf16 -> f32: each of 8 warps
// takes 16-row tiles of x against all 64 columns (up to 64 rows: two warps
// share a row tile and halve the columns), B fragments through
// ldmatrix.trans.  K/8 need not be a multiple of 16 (K = 11008 gives 1376 =
// 86 chunks; a ragged last chunk is zero-filled) and M is not padded in
// global memory.  Where K/8 is a multiple of 8 (every 7B shape) x is read in
// aligned 16-byte segments and the next chunk's words and scales are
// fetched into registers while the current chunk's mma runs; otherwise an
// element-wise path does the same work.  No cp.async/TMA ring and no wgmma
// yet: the x loads of a chunk are not overlapped with its mma.
//
// K7 design.  One thread takes 8 adjacent words of a k8 row (32 bytes) and
// writes, for each of the 8 planes, 8 bf16 (16 bytes) of output row
// i * K/8 + k8: every store is coalesced along N.
//
// Both launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;             // columns per absmax block = per thread block
constexpr int KC = 16;             // k8 rows per chunk: one mma k-step per plane
constexpr int CK = 8 * KC;         // k values per chunk (8 planes)
constexpr int LDA = CK + 8;        // padded row strides (bf16 elements)
constexpr int LDB = QB + 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_M = 16 * WARPS;  // rows one pass of the 8 warps covers

// the NF4 codebook (bitsandbytes), f32
__constant__ float kCode[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f};

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

// The chunk's words and scales a thread holds in registers between chunks
// (VEC path): 4 adjacent words of one k8 row, and the 8 scales of its x segment.
struct ChunkRegs {
  int4 w;
  float s[8];
};

// MI: 16-row tiles per warp; the block covers MI * 128 rows of x.
// VEC: K/8 is a multiple of 8 and x is 16-byte aligned, so every 8-wide
// segment of a plane's slice of x is one aligned 16-byte load; a thread then
// keeps one segment (8 scales in registers) and walks the rows, and the next
// chunk's words and scales are fetched while the current chunk's mma runs.
template <int MI, bool VEC>
__global__ void __launch_bounds__(THREADS)
nf4_linear_partial(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ words,
                   const float* __restrict__ scale, float* __restrict__ partial,
                   int M, int K, int N, int chunks_per_split, int a_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __nv_bfloat16 lut[16];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [a_rows][LDA]
  __nv_bfloat16* Bs = As + a_rows * LDA;                        // [CK][LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int K8 = K / 8, NB = N / QB;
  const int cb = blockIdx.x, n0 = cb * QB;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * (MI * TILE_M);
  const int rows = min(MI * TILE_M, M - m0);       // valid rows of this block
  const int rows16 = (rows + 15) / 16 * 16;        // rows of As the mma reads
  const int n_chunks = (K8 + KC - 1) / KC;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  // The 8 warps against the tile: warp wrow takes 16-row tiles wrow, wrow + 8,
  // ... and the 8-column tiles nt0 .. nt0 + ntn - 1.  With up to 64 rows (the
  // serving decode M) four warps would idle, so the warps pair up on a row
  // tile and each takes half the columns.
  const bool pair = MI == 1 && rows <= 64;
  const int wrow = pair ? (warp & 3) : warp;
  const int nt0 = pair ? (warp >> 2) * 4 : 0;
  const int ntn = pair ? 4 : 8;

  if (tid < 16) lut[tid] = __float2bfloat16_rn(kCode[tid]);

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  // VEC thread roles.  Decode: k8 row dj of the chunk, columns dc..dc+3.
  // x tile: segment seg = (plane si, half sj0) of the chunk's 128 k values.
  const int dj = tid >> 4, dc = (tid & 15) * 4;
  const int si = (tid & 15) >> 1, sj0 = (tid & 1) * 8;
  ChunkRegs cur;
  auto fetch = [&](int ch, ChunkRegs& c) {
    const int r0 = ch * KC;
    c.w = make_int4(0, 0, 0, 0);
    if (r0 + dj < K8)
      c.w = *reinterpret_cast<const int4*>(words + static_cast<long long>(r0 + dj) * N + n0 + dc);
    const bool ok = r0 + sj0 < K8;     // K8 % 8 == 0: a segment is valid as a whole
    const long long k = static_cast<long long>(si) * K8 + r0 + sj0;
#pragma unroll
    for (int e = 0; e < 8; ++e) c.s[e] = ok ? scale[(k + e) * NB + cb] : 0.f;
  };
  if (VEC && c_begin < c_end) fetch(c_begin, cur);

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int r0 = ch * KC;
    __syncthreads();  // the previous chunk's reads are done (first pass: lut is written)

    if (VEC) {
      // decode this thread's 4 words into Bs[plane * KC + dj][dc..dc+3]
      const bool okw = r0 + dj < K8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        __nv_bfloat162 v0, v1;
        v0.x = lut[(cur.w.x >> (4 * i)) & 15];
        v0.y = lut[(cur.w.y >> (4 * i)) & 15];
        v1.x = lut[(cur.w.z >> (4 * i)) & 15];
        v1.y = lut[(cur.w.w >> (4 * i)) & 15];
        uint2 o = make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
        if (!okw) o = make_uint2(0u, 0u);
        *reinterpret_cast<uint2*>(Bs + (i * KC + dj) * LDB + dc) = o;
      }
      // As[r][si * KC + sj0 + e] = bf16(f32(x[m0 + r, k + e]) * s[e])
      const bool ok = r0 + sj0 < K8;
      const long long k = static_cast<long long>(si) * K8 + r0 + sj0;
      for (int r = tid >> 4; r < rows16; r += THREADS / 16) {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (ok && r < rows)
          raw = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * K + k);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 f = __bfloat1622float2(h[p]);
          o[p] = pack_bf16(__fmul_rn(f.x, cur.s[2 * p]), __fmul_rn(f.y, cur.s[2 * p + 1]));
        }
        *reinterpret_cast<uint4*>(As + r * LDA + si * KC + sj0) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      // decode [KC, 64] words into Bs[plane * KC + j][col]; two adjacent
      // columns per task, rows past K/8 as zeros
      for (int t = tid; t < KC * (QB / 2); t += THREADS) {
        const int j = t / (QB / 2), c2 = (t % (QB / 2)) * 2;
        const int k8 = r0 + j;
        const bool ok = k8 < K8;
        int2 w = make_int2(0, 0);
        if (ok)
          w = *reinterpret_cast<const int2*>(words + static_cast<long long>(k8) * N + n0 + c2);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          __nv_bfloat162 v;
          v.x = lut[(w.x >> (4 * i)) & 15];
          v.y = lut[(w.y >> (4 * i)) & 15];
          if (!ok) v = __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(Bs + (i * KC + j) * LDB + c2) = v;
        }
      }
      // As[r][kk] = bf16(f32(x[m0 + r, i * K/8 + r0 + j]) * scale[k, cb]) with
      // kk = i * KC + j: a thread keeps one kk (one scale) and walks the rows
      const int kk = tid & (CK - 1);
      const int i = kk / KC, j = kk % KC;
      const int k8 = r0 + j;
      const bool ok = k8 < K8;
      const long long k = static_cast<long long>(i) * K8 + k8;
      const float s = ok ? scale[k * NB + cb] : 0.f;
      for (int r = tid / CK; r < rows16; r += THREADS / CK) {
        float xv = 0.f;
        if (ok && r < rows) xv = __bfloat162float(x[static_cast<long long>(m0 + r) * K + k]);
        As[r * LDA + kk] = __float2bfloat16_rn(__fmul_rn(xv, s));
      }
    }
    __syncthreads();
    // the next chunk's words and scales travel while this chunk's mma runs
    if (VEC && ch + 1 < c_end) fetch(ch + 1, cur);

    // one k-step of 16 per plane
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t bf[8][2];
      const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        if (q < ntn) {
          const __nv_bfloat16* p =
              Bs + (i * KC + (mat & 1) * 8 + mrow) * LDB + (nt0 + q) * 8 + (mat >> 1) * 8;
          const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(bf[q][0]), "=r"(bf[q][1]), "=r"(bf[q + 1][0]), "=r"(bf[q + 1][1])
              : "r"(addr));
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int row0 = (mi * WARPS + wrow) * 16;
        if (row0 < rows) {   // the same for every lane of the warp
          const __nv_bfloat16* a0 = As + (row0 + g) * LDA + i * KC + 2 * t4;
          const __nv_bfloat16* a1 = a0 + 8 * LDA;
          uint32_t a[4] = {ld32(a0), ld32(a1), ld32(a0 + 8), ld32(a1 + 8)};
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (q < ntn) mma_bf16(acc[mi][q], a, bf[q][0], bf[q][1]);
        }
      }
    }
  }

  // this split's partial sums (zeros where the split got no chunk)
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int row0 = (mi * WARPS + wrow) * 16;
    if (row0 >= rows) continue;
    const int ra = m0 + row0 + g, rb = ra + 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q >= ntn) continue;
      const int col = n0 + (nt0 + q) * 8 + 2 * t4;
      if (ra < M)
        *reinterpret_cast<float2*>(partial + (static_cast<long long>(split) * M + ra) * N + col) =
            make_float2(acc[mi][q][0], acc[mi][q][1]);
      if (rb < M)
        *reinterpret_cast<float2*>(partial + (static_cast<long long>(split) * M + rb) * N + col) =
            make_float2(acc[mi][q][2], acc[mi][q][3]);
    }
  }
}

// out = bf16(sum over splits, in split order)
__global__ void nf4_linear_reduce(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out, long long total,
                                  int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * total + idx];
  out[idx] = __float2bfloat16_rn(s);
}

template <int MI, bool VEC>
cudaError_t launch_linear(const void* x, const void* words, const void* scale, void* partial,
                          int M, int K, int N, int splits, cudaStream_t st) {
  const int K8 = K / 8;
  const int n_chunks = (K8 + KC - 1) / KC;
  const int chunks_per_split = (n_chunks + splits - 1) / splits;
  const int block_m = MI * TILE_M;
  const int a_rows = min(block_m, (M + 15) / 16 * 16);
  const int smem = (a_rows * LDA + CK * LDB) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(nf4_linear_partial<MI, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / QB, splits, (M + block_m - 1) / block_m);
  nf4_linear_partial<MI, VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(words),
      static_cast<const float*>(scale), static_cast<float*>(partial), M, K, N,
      chunks_per_split, a_rows);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_linear_rows(const void* x, const void* words, const void* scale,
                               void* partial, int M, int K, int N, int splits,
                               cudaStream_t st) {
  if (M <= TILE_M) return launch_linear<1, VEC>(x, words, scale, partial, M, K, N, splits, st);
  if (M <= 2 * TILE_M)
    return launch_linear<2, VEC>(x, words, scale, partial, M, K, N, splits, st);
  return launch_linear<4, VEC>(x, words, scale, partial, M, K, N, splits, st);
}

__global__ void nf4_dequant_kernel(const int32_t* __restrict__ words,
                                   const float* __restrict__ scale,
                                   __nv_bfloat16* __restrict__ out, int K8, int N) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const int n8 = N / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K8) * n8) return;
  const int k8 = static_cast<int>(idx / n8);
  const int c = static_cast<int>(idx % n8) * 8;
  const int4* src = reinterpret_cast<const int4*>(words + static_cast<long long>(k8) * N + c);
  const int4 w0 = src[0], w1 = src[1];
  const int w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int NB = N / QB, cb = c / QB;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long k = static_cast<long long>(i) * K8 + k8;
    const float s = scale[k * NB + cb];
    uint32_t o[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      o[p] = pack_bf16(__fmul_rn(lut[(w[2 * p] >> (4 * i)) & 15], s),
                       __fmul_rn(lut[(w[2 * p + 1] >> (4 * i)) & 15], s));
    *reinterpret_cast<uint4*>(out + k * N + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

}  // namespace

// x bf16 [M, K]; words int32 [K/8, N]; scale f32 [K, N/64]; partial: f32
// workspace of splits * M * N; out bf16 [M, N].  K % 8 == 0, N % 64 == 0.
extern "C" int cullavo_nf4_linear_planar(const void* x, const void* words, const void* scale,
                                         void* partial, void* out, int M, int K, int N,
                                         int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (K / 8) % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err =
      vec ? launch_linear_rows<true>(x, words, scale, partial, M, K, N, splits, st)
          : launch_linear_rows<false>(x, words, scale, partial, M, K, N, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  const int threads = 256;
  nf4_linear_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

// words int32 [K/8, N]; scale f32 [K, N/64]; out bf16 [K, N]
extern "C" int cullavo_nf4_dequant_planar(const void* words, const void* scale, void* out,
                                          int K, int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K8 = K / 8;
  const long long tasks = static_cast<long long>(K8) * (N / 8);
  const int threads = 256;
  nf4_dequant_kernel<<<static_cast<unsigned>((tasks + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const int32_t*>(words), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), K8, N);
  return static_cast<int>(cudaGetLastError());
}

// Byte-packed NF4 weights (kernel K11): the fused dequant-matmul for small M
// and the dequant-once pass in front of a dense matmul for large M.
//
// Replaces: cullavo_tpu/ops/nf4.py, nf4_linear_pallas -> _nf4_linear_kernel
// (Pallas row 9) and nf4_matmul_fused -> _nf4_matmul_kernel (row 8; its
// double-quantized absmax is decoded before the call, outside the TPU kernel
// too, and passed here as the scale).  The weight [K, N] is stored as bytes
// q4 [K, N/2]: byte (k, j) holds the NF4 code of element (k, 2j) in its high
// nibble and of (k, 2j + 1) in its low nibble (the flat row-major packing of
// quantize_linear / quantize_nf4 viewed 2-D), with one f32 absmax per
// (row k, 64-column block): scale [K, N/64].
//
//   fused:    y[m, n] = sum_k x[m, k] * w[k, n],  w = f32(code[k, n] * scale[k, n/64])
//             with w split into two bf16 terms, w ~ hi + lo (hi = bf16(w),
//             lo = bf16(w - hi), |w - hi - lo| <= 2^-17 |w|), each taken by
//             the bf16 tensor cores against the exact bf16 x, products
//             summed in f32, rounded once to bf16
//   dequant:  w[k, n] = bf16(code_f32[k, n] * scale[k, n/64])        (bit-exact)
//
// The TPU kernels take an f32 dot of the f32 dequantized weight, and the
// plain version here does the same.  With the scale on the weight and the
// weight in two bf16 terms the fused pass matches that to f32 rounding, so
// the two bf16 outputs differ by at most one ulp.  (The first design folded
// the scale into x and took one bf16 codebook value per weight, as K6 does:
// the bf16 rounding of the codebook values, up to 3e-3 relative, put some
// outputs two ulps off the f32 version at M = 511, outside 1e-2 + 1e-2 |ref|
// on the H100.)
//
// Bound on the H100: bytes, for both.  The fused pass reads 0.5 byte per
// weight plus the scales (0.5625 byte in all) against 2 * M operations per
// weight (4 * M with the two terms); at M <= 511 that stays below the card's
// ~295 bf16 operations per byte.  The dequant pass reads 0.5625 and writes 2
// bytes per weight.
//
// Fused design (K6's block structure over bytes).  A block owns ONE
// 64-column scale block, all rows of x (up to 128, 256 or 512, picked by M:
// every weight byte is decoded once per block) and a range of 128-row k
// chunks (deterministic split-K over blockIdx.y: partial sums go to a
// caller-allocated f32 workspace and a second kernel adds them in split
// order).  Per chunk each of the 256 threads loads 16 bytes (one k row, 32
// columns) and that row's scale, decodes them through a 16-entry f32 table
// into 32 weights of the [128, 64] hi and lo B tiles in shared memory, and
// copies one 8-wide k segment of x per row into the bf16 A tile [rows, 128];
// then mma.sync m16n8k16 bf16 -> f32 in 8 k-steps (x against hi, then x
// against lo), each of 8 warps on 16-row tiles against all 64 columns (two
// warps share a row tile and halve the columns when M <= 64), B fragments
// through ldmatrix.trans.  The next chunk's bytes and scale are fetched into
// registers while the current chunk's mma runs.  K must be a multiple of 8
// (x read in aligned 16-byte segments; a ragged last chunk is zero-filled)
// and N of 64; M is not padded in global memory.  No cp.async/TMA ring and no
// wgmma yet.
//
// Dequant design.  One thread takes 8 bytes (16 columns of one row, inside
// one scale block) and writes 16 bf16 (32 bytes): every store is coalesced
// along N.
//
// Both launch on the caller's stream and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;             // columns per absmax block = per thread block
constexpr int CK = 128;            // k rows per chunk
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

// w = f32(code * s) as two bf16 terms: hi = bf16(w), lo = bf16(w - hi)
__device__ __forceinline__ void split_weight(float w, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(w);
  lo = __float2bfloat16_rn(__fsub_rn(w, __bfloat162float(hi)));
}

// what a thread holds in registers between chunks: the 16 bytes of its
// k row (32 columns) and that row's scale
struct ChunkRegs {
  uint4 w;
  float s;
};

// MI: 16-row tiles per warp; the block covers MI * 128 rows of x.
template <int MI>
__global__ void __launch_bounds__(THREADS)
nf4_q4_partial(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
               const float* __restrict__ scale, float* __restrict__ partial,
               int M, int K, int N, int chunks_per_split, int a_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float lut[16];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [a_rows][LDA]
  __nv_bfloat16* Bh = As + a_rows * LDA;                        // [CK][LDB], hi terms
  __nv_bfloat16* Bl = Bh + CK * LDB;                            // [CK][LDB], lo terms

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int NB = N / QB, NH = N / 2;
  const int cb = blockIdx.x;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * (MI * TILE_M);
  const int rows = min(MI * TILE_M, M - m0);       // valid rows of this block
  const int rows16 = (rows + 15) / 16 * 16;        // rows of As the mma reads
  const int n_chunks = (K + CK - 1) / CK;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  // warp wrow takes 16-row tiles wrow, wrow + 8, ... and the 8-column tiles
  // nt0 .. nt0 + ntn - 1; with up to 64 rows the warps pair up on a row tile
  const bool pair = MI == 1 && rows <= 64;
  const int wrow = pair ? (warp & 3) : warp;
  const int nt0 = pair ? (warp >> 2) * 4 : 0;
  const int ntn = pair ? 4 : 8;

  if (tid < 16) lut[tid] = kCode[tid];

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  // decode role: k row dr of the chunk, bytes dh*16 .. dh*16 + 15 of the
  // block's 32 (columns dh*32 .. dh*32 + 31); x role: segment seg (k values
  // seg*8 .. seg*8 + 7 of the chunk), rows tid/16, tid/16 + 16, ...
  const int dr = tid >> 1, dh = tid & 1;
  const int seg = tid & 15;
  ChunkRegs cur;
  auto fetch = [&](int ch, ChunkRegs& c) {
    const int k = ch * CK + dr;
    c.w = make_uint4(0u, 0u, 0u, 0u);
    c.s = 0.f;                      // rows past K: zero weights
    if (k < K) {
      c.w = *reinterpret_cast<const uint4*>(q4 + static_cast<long long>(k) * NH +
                                            cb * (QB / 2) + dh * 16);
      c.s = scale[static_cast<long long>(k) * NB + cb];
    }
  };
  if (c_begin < c_end) fetch(c_begin, cur);

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int k0 = ch * CK;
    __syncthreads();  // the previous chunk's reads are done (first pass: lut is written)

    // decode this thread's 16 bytes into Bh/Bl[dr][dh*32 .. dh*32 + 31]
    {
      const uint32_t wv[4] = {cur.w.x, cur.w.y, cur.w.z, cur.w.w};
      const int off = dr * LDB + dh * 32;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
        for (int b = 0; b < 4; ++b) {   // byte 4p + b, the lowest address in the low byte
          const uint32_t byte = (wv[p] >> (8 * b)) & 0xFF;
          split_weight(__fmul_rn(lut[byte >> 4], cur.s), hi[2 * b], lo[2 * b]);
          split_weight(__fmul_rn(lut[byte & 15], cur.s), hi[2 * b + 1], lo[2 * b + 1]);
        }
        *reinterpret_cast<uint4*>(Bh + off + p * 8) = *reinterpret_cast<const uint4*>(hi);
        *reinterpret_cast<uint4*>(Bl + off + p * 8) = *reinterpret_cast<const uint4*>(lo);
      }
    }
    // As[r][seg*8 .. seg*8 + 7] = x[m0 + r, k0 + seg*8 ..] (zeros past M and K)
    {
      const int k = k0 + seg * 8;
      const bool ok = k < K;             // K % 8 == 0: a segment is valid as a whole
      for (int r = tid >> 4; r < rows16; r += THREADS / 16) {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (ok && r < rows)
          raw = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * K + k);
        *reinterpret_cast<uint4*>(As + r * LDA + seg * 8) = raw;
      }
    }
    __syncthreads();
    // the next chunk's bytes and scale travel while this chunk's mma runs
    if (ch + 1 < c_end) fetch(ch + 1, cur);

    // 8 k-steps of 16, each against the hi and the lo terms
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        const __nv_bfloat16* Bs = term ? Bl : Bh;
        uint32_t bf[8][2];
        const int mat = lane >> 3, mrow = lane & 7;
#pragma unroll
        for (int q = 0; q < 8; q += 2) {
          if (q < ntn) {
            const __nv_bfloat16* p =
                Bs + (ks * 16 + (mat & 1) * 8 + mrow) * LDB + (nt0 + q) * 8 + (mat >> 1) * 8;
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
            const __nv_bfloat16* a0 = As + (row0 + g) * LDA + ks * 16 + 2 * t4;
            const __nv_bfloat16* a1 = a0 + 8 * LDA;
            uint32_t a[4] = {ld32(a0), ld32(a1), ld32(a0 + 8), ld32(a1 + 8)};
#pragma unroll
            for (int q = 0; q < 8; ++q)
              if (q < ntn) mma_bf16(acc[mi][q], a, bf[q][0], bf[q][1]);
          }
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
      const int col = cb * QB + (nt0 + q) * 8 + 2 * t4;
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
__global__ void nf4_q4_reduce(const float* __restrict__ partial, __nv_bfloat16* __restrict__ out,
                              long long total, int splits) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[p * total + idx];
  out[idx] = __float2bfloat16_rn(s);
}

template <int MI>
cudaError_t launch_q4(const void* x, const void* q4, const void* scale, void* partial, int M,
                      int K, int N, int splits, cudaStream_t st) {
  const int n_chunks = (K + CK - 1) / CK;
  const int chunks_per_split = (n_chunks + splits - 1) / splits;
  const int block_m = MI * TILE_M;
  const int a_rows = min(block_m, (M + 15) / 16 * 16);
  const int smem = (a_rows * LDA + 2 * CK * LDB) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(nf4_q4_partial<MI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / QB, splits, (M + block_m - 1) / block_m);
  nf4_q4_partial<MI><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(scale), static_cast<float*>(partial), M, K, N,
      chunks_per_split, a_rows);
  return cudaGetLastError();
}

__global__ void nf4_q4_dequant_kernel(const uint8_t* __restrict__ q4,
                                      const float* __restrict__ scale,
                                      __nv_bfloat16* __restrict__ out, int K, int N) {
  __shared__ float lut[16];
  if (threadIdx.x < 16) lut[threadIdx.x] = kCode[threadIdx.x];
  __syncthreads();
  const int n16 = N / 16;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(K) * n16) return;
  const long long k = idx / n16;
  const int c = static_cast<int>(idx % n16) * 16;
  const uint2 w = *reinterpret_cast<const uint2*>(q4 + k * (N / 2) + c / 2);
  const float s = scale[k * (N / QB) + c / QB];
  const uint32_t wv[2] = {w.x, w.y};
  uint32_t o[8];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t byte = (wv[p] >> (8 * b)) & 0xFF;
      o[p * 4 + b] = pack_bf16(__fmul_rn(lut[byte >> 4], s), __fmul_rn(lut[byte & 15], s));
    }
  uint4* dst = reinterpret_cast<uint4*>(out + k * N + c);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

}  // namespace

// x bf16 [M, K] (16-byte aligned); q4 uint8 [K, N/2]; scale f32 [K, N/64];
// partial: f32 workspace of splits * M * N; out bf16 [M, N].
// K % 8 == 0, N % 64 == 0.
extern "C" int cullavo_nf4_linear_q4(const void* x, const void* q4, const void* scale,
                                     void* partial, void* out, int M, int K, int N, int splits,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= TILE_M)
    err = launch_q4<1>(x, q4, scale, partial, M, K, N, splits, st);
  else if (M <= 2 * TILE_M)
    err = launch_q4<2>(x, q4, scale, partial, M, K, N, splits, st);
  else
    err = launch_q4<4>(x, q4, scale, partial, M, K, N, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(M) * N;
  const int threads = 256;
  nf4_q4_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out), total, splits);
  return static_cast<int>(cudaGetLastError());
}

// q4 uint8 [K, N/2]; scale f32 [K, N/64]; out bf16 [K, N].  N % 64 == 0.
extern "C" int cullavo_nf4_dequant_q4(const void* q4, const void* scale, void* out, int K, int N,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tasks = static_cast<long long>(K) * (N / 16);
  const int threads = 256;
  nf4_q4_dequant_kernel<<<static_cast<unsigned>((tasks + threads - 1) / threads), threads, 0,
                          st>>>(static_cast<const uint8_t*>(q4),
                                static_cast<const float*>(scale),
                                static_cast<__nv_bfloat16*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

// Per-row activation quantizer for the s8s8 prefill GEMMs (kernel K2).
//
// Replaces: cullavo_tpu/ops/nf4.py, quantize_rows_pallas -> _quant_rows_kernel.
// Computes, for each row r of x [M, K] (bf16) and an optional multiplier
// mult [K] (the SmoothQuant sq_inv, bf16 or f32; bf16 widens exactly):
//     v      = f32(x[r, k]) * mult[k]
//     a      = max_k |v|
//     inv    = 127 / max(a, 1e-12)          (IEEE division)
//     sx[r]  = 1 / inv                      (IEEE division)
//     xi[r,k]= clip(rint(v * inv), -127, 127)   (round half to even)
// bit-identical to the JAX chain (nf4._quant_inv_scale): constant numerators
// only, a single rounding point, no FMA contraction (explicit __fmul_rn /
// __fdiv_rn), and this file is built without --use_fast_math.  The maximum
// does not depend on the order it is taken in.
//
// Bound on the H100: memory.  3 bytes move per element (2 in, 1 out), about
// 55.8 MB per [4536, 4096] call, ~17 us at 3.35 TB/s.  Design: a persistent
// grid of a few blocks an SM walks the rows (block b takes rows b, b + grid,
// ...).  A thread owns VPT fixed 16-byte vectors of a row (vector t + j *
// threads), so it loads its slice of a bf16 multiplier once, as 16-byte
// vectors, and keeps it in registers for every row (an f32 multiplier, off
// the main path, is read again each row from L1).  A row stays in registers:
// the next row's loads are issued before this row's maximum is reduced, and
// the block meets at one barrier a row, over warp
// maxima kept in two buffers (a warp writes row i + 1's buffer only after
// every warp has passed row i's barrier, so row i - 1's reads are done).
// Each thread then takes the block maximum itself (the same value in every
// thread) and stores its codes as 8-byte words; thread 0 writes sx.
// ops/nf4.quant_rows_plan picks VPT, the threads and the blocks.  Launches
// on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
enum MultKind { kNoMult = 0, kBf16Mult = 1, kF32Mult = 2 };

// element e of a vector of 8 bf16 (e even: the low half of word e / 2)
__device__ __forceinline__ float bf16_at(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// the multiplier: bf16 held packed in registers for every row (widened per
// use: an asm statement, so that the compiler does not keep 8 widened floats
// a vector live across the row loop and spill); f32 (off the main path) read
// again each row, from L1
template <int VPT, int MK>
struct RowMult {
  uint4 m[MK == kBf16Mult ? VPT : 1];
  const float* f32;

  __device__ __forceinline__ void load(const void* mult, int t, int threads, int nvec) {
    f32 = static_cast<const float*>(mult);
    if (MK != kBf16Mult) return;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = t + j * threads;
      m[j] = v < nvec ? reinterpret_cast<const uint4*>(mult)[v] : make_uint4(0, 0, 0, 0);
    }
  }

  // the 8 multipliers of vector slot j (vector v of the row)
  __device__ __forceinline__ void get(int j, int v, float (&mv)[8]) const {
    if (MK == kF32Mult) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(f32) + 2 * v);
      const float4 hi = __ldg(reinterpret_cast<const float4*>(f32) + 2 * v + 1);
      mv[0] = lo.x, mv[1] = lo.y, mv[2] = lo.z, mv[3] = lo.w;
      mv[4] = hi.x, mv[5] = hi.y, mv[6] = hi.z, mv[7] = hi.w;
    } else if (MK == kBf16Mult) {
      const uint32_t w[4] = {m[j].x, m[j].y, m[j].z, m[j].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t lo, hi;
        asm volatile("shl.b32 %0, %1, 16;" : "=r"(lo) : "r"(w[i]));
        asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(hi) : "r"(w[i]));
        mv[2 * i] = __uint_as_float(lo);
        mv[2 * i + 1] = __uint_as_float(hi);
      }
    }
  }

  // f32(x) * mult, one rounding, as the plain version
  __device__ __forceinline__ float apply(float f, const float (&mv)[8], int e) const {
    return MK == kNoMult ? f : __fmul_rn(f, mv[e]);
  }
};

// this thread's vectors of row r (zeros past the row)
template <int VPT>
__device__ __forceinline__ void load_row(uint4 (&dst)[VPT], const __nv_bfloat16* __restrict__ x,
                                         int r, int K, int t, int threads, int nvec) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<long long>(r) * K);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = t + j * threads;
    dst[j] = v < nvec ? __ldcs(xr + v) : make_uint4(0, 0, 0, 0);
  }
}

template <int VPT, int MK>
__global__ void __launch_bounds__(kMaxThreads, 1)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ mult,
                  int8_t* __restrict__ xi, float* __restrict__ sx, int M, int K) {
  __shared__ float warp_max[2][kMaxThreads / 32];
  const int nvec = K >> 3;   // K % 8 == 0 (checked by the wrapper)
  const int threads = blockDim.x, t = threadIdx.x;
  const int warps = threads >> 5, warp = t >> 5, lane = t & 31;

  RowMult<VPT, MK> mul;
  mul.load(mult, t, threads, nvec);

  // rows in flight: this one and the next
  uint4 cur[VPT], nxt[VPT];
  const int grid = gridDim.x;
  int r = blockIdx.x;
  if (r < M) load_row<VPT>(cur, x, r, K, t, threads, nvec);
  for (int buf = 0; r < M; r += grid, buf ^= 1) {
    if (r + grid < M) load_row<VPT>(nxt, x, r + grid, K, t, threads, nvec);

    float a = 0.f;   // the out-of-row slots hold zeros: |0 * m| adds nothing
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      float mv[8];
      mul.get(j, min(t + j * threads, nvec - 1), mv);
#pragma unroll
      for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(mul.apply(bf16_at(cur[j], e), mv, e)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    if (lane == 0) warp_max[buf][warp] = a;
    __syncthreads();
    float m = warp_max[buf][0];
    for (int w = 1; w < warps; ++w) m = fmaxf(m, warp_max[buf][w]);
    const float inv = __fdiv_rn(127.0f, fmaxf(m, 1e-12f));
    if (t == 0) sx[r] = __fdiv_rn(1.0f, inv);

    uint2* out = reinterpret_cast<uint2*>(xi + static_cast<long long>(r) * K);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = t + j * threads;
      uint32_t packed[2] = {0u, 0u};
      float mv[8];
      mul.get(j, min(v, nvec - 1), mv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float q = rintf(__fmul_rn(mul.apply(bf16_at(cur[j], e), mv, e), inv));
        q = fminf(fmaxf(q, -127.0f), 127.0f);
        packed[e >> 2] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * (e & 3));
      }
      if (v < nvec) __stcs(out + v, make_uint2(packed[0], packed[1]));
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) cur[j] = nxt[j];
  }
}

template <int VPT>
const void* kernel_for(int mult_kind) {
  switch (mult_kind) {
    case kNoMult: return reinterpret_cast<const void*>(quant_rows_kernel<VPT, kNoMult>);
    case kBf16Mult: return reinterpret_cast<const void*>(quant_rows_kernel<VPT, kBf16Mult>);
    case kF32Mult: return reinterpret_cast<const void*>(quant_rows_kernel<VPT, kF32Mult>);
    default: return nullptr;
  }
}

const void* kernel_of(int vpt, int mult_kind) {
  switch (vpt) {
    case 2: return kernel_for<2>(mult_kind);
    case 4: return kernel_for<4>(mult_kind);
    case 6: return kernel_for<6>(mult_kind);
    case 8: return kernel_for<8>(mult_kind);
    default: return nullptr;
  }
}

}  // namespace

// Blocks of `threads` threads that one SM holds at once for the instantiation
// (vpt, mult_kind): the plan's residency; -1 for an instantiation that does
// not exist.
extern "C" int cullavo_quant_rows_resident(int vpt, int mult_kind, int threads) {
  const void* fn = kernel_of(vpt, mult_kind);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads || threads % 32) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0) != cudaSuccess) return -1;
  return n;
}

// mult_kind: 0 none, 1 bf16 [K], 2 f32 [K] (16-byte aligned); the plan
// (vpt vectors of 8 a thread, threads, blocks) from ops/nf4.quant_rows_plan.
extern "C" int cullavo_quant_rows(const void* x, const void* mult, void* xi, void* sx, int M,
                                  int K, int mult_kind, int vpt, int threads, int blocks,
                                  void* stream) {
  const void* fn = kernel_of(vpt, mult_kind);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads || threads % 32 || blocks < 1 ||
      K % 8 || static_cast<long long>(threads) * vpt * 8 < K || (mult_kind && mult == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {(void*)&x, (void*)&mult, &xi, &sx, &M, &K};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" const char* cullavo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One-token decode attention against a head-major KV cache (kernel K12).
//
// Replaces: cullavo_tpu/ops/flash_attention.py, flash_decode ->
// _decode_kernel (one new token per (b, h) against a KV-grouped cache under
// the kv_valid & s <= q_position mask), in the general form the VL zoo's
// stale-cache decode needs (cullavo_tpu/models/llava/llama.py,
// sdpa_decode_stale: an additive bias, T5's relative-position bias with
// unscaled scores).  For batch row b and head h (kv head g = h / group):
//     s[j] = scale * (q[b, h] . k[b, g, j]) + bias[b, h, j]     (f32)
//     m    = max_j s[j],  p[j] = exp(s[j] - m)  (a key at -inf counts 0)
//     l    = sum_j p[j]
//     o    = sum_j p[j] v[b, g, j] / l                          (f32)
// over the S cache keys (head dim d a multiple of 8 up to 128; f32 or bf16
// inputs); o, m and l come back in f32 so that the caller can
// fold in keys the kernel did not see (the current token of a stale-cache
// step).  A finite mask value (the Pallas kernel's -1e30, the models'
// -1e9) is an ordinary score: a row whose keys are all masked so averages
// v over the S keys, as the Pallas kernel does over its (padded) length.
// Keys past S are never read.
//
// Bound on the H100: bytes.  Each (b, g) cache row is read once per block
// (once in all for the MHA shapes), ~4 d operations per key and head against
// 2 d bytes (bf16) or 4 d (f32) per key: far below the card's 295 operations
// per byte.  Design: decode_rows.cuh's lane-group body in its kFlash mode.  A
// block takes the group's heads of one (b, g) in chunks of up to 4 (so a GQA
// cache row is read once for its 4 heads) and streams its keys through
// per-warp cp.async rings.  S is not split across blocks: the 7B shape's 448
// (b, h) rows fill the card alone, and at KOSMOS-2's 32 rows over 130 keys a
// split with a combine pass measured slower than one block per row.
// Launches on the caller's stream and allocates nothing.

#include "decode_rows.cuh"

// K12: q [B, H, d], caches [B, KV, S, d], bias f32 [B, H, S] (strides in
// elements; a stride of 0 broadcasts), all of one type: f32 (is_bf16 = 0)
// or bf16.  Outputs f32: o [B, H, d], m and l [B, H], contiguous.
extern "C" int cullavo_flash_decode(
    const void* q, const void* k, const void* v, const void* bias, void* o, void* m, void* l,
    int is_bf16, int B, int H, int KV, int S, int d,
    long long q_sb, long long q_sh, long long k_sb, long long k_sg, long long k_ss,
    long long v_sb, long long v_sg, long long v_ss, long long b_sb, long long b_sh,
    long long b_ss, float scale, void* stream) {
  if (d < 8 || d > decode_rows::MAX_D || d % 8 || B < 1 || H < 1 || KV < 1 || H % KV || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  decode_rows::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.B = B;
  p.KV = KV;
  p.n_rep = H / KV;
  p.W = 1;
  p.S = S;
  p.d = d;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sg = k_sg;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sg = v_sg;
  p.v_ss = v_ss;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.b_ss = b_ss;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return decode_rows::launch_rows<__nv_bfloat16, decode_rows::kFlash>(p, st);
  return decode_rows::launch_rows<float, decode_rows::kFlash>(p, st);
}

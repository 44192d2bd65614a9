// Shared device helpers of the attention kernels (flash_attention.cu,
// flash_decode.cu): element loads into f32, the packed-position mask rule,
// and the per-tile dead-tile predicate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_attn {

constexpr float NEG_INF = -1e30f;  // masked score / lse of a fully masked row
constexpr int BIG = 1 << 30;       // sentinel for masked min/max bounds

// Four consecutive elements as f32.  Callers keep the element offset a
// multiple of 4 (D is 64 or 128), so the vector loads are aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// THE masking rule (reference: repro/kernels/flash_attention.py::tile_mask):
// both positions valid, same segment, causal and sliding-window on absolute
// positions.
__device__ __forceinline__ bool pair_ok(int qp, int kp, int qs, int ks, int causal, int window) {
  bool ok = (qp >= 0) & (kp >= 0) & (qs == ks);
  if (causal) ok &= kp <= qp;
  if (window > 0) ok &= kp > qp - window;
  return ok;
}

// Position/segment bounds of one tile's valid entries (pos >= 0).
struct Bounds {
  int any, pmin, pmax, smin, smax;
};

// The union of the lanes' bounds.  Every lane of the calling warp returns
// the same value.
__device__ __forceinline__ Bounds warp_reduce_bounds(Bounds b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    b.any |= __shfl_xor_sync(0xffffffffu, b.any, off);
    b.pmin = min(b.pmin, __shfl_xor_sync(0xffffffffu, b.pmin, off));
    b.pmax = max(b.pmax, __shfl_xor_sync(0xffffffffu, b.pmax, off));
    b.smin = min(b.smin, __shfl_xor_sync(0xffffffffu, b.smin, off));
    b.smax = max(b.smax, __shfl_xor_sync(0xffffffffu, b.smax, off));
  }
  return b;
}

// Warp-wide bounds over n <= 64 entries held in shared memory.  Every lane
// of the calling warp returns the same value.
__device__ __forceinline__ Bounds warp_bounds(const int* pos, const int* seg, int n) {
  const int lane = threadIdx.x & 31;
  Bounds b{0, BIG, -BIG, BIG, -BIG};
  for (int i = lane; i < n; i += 32) {
    const int p = pos[i];
    if (p >= 0) {
      const int s = seg[i];
      b.any = 1;
      b.pmin = min(b.pmin, p);
      b.pmax = max(b.pmax, p);
      b.smin = min(b.smin, s);
      b.smax = max(b.smax, s);
    }
  }
  return warp_reduce_bounds(b);
}

// Can any (q, k) pair of the tile be unmasked?  The rule of
// repro/kernels/flash_attention.py::tile_reachable: both sides hold a valid
// entry, segment ranges overlap, causal keeps tiles whose earliest key is
// not after the latest query, the window keeps tiles whose latest key is
// inside the earliest query's window.
__device__ __forceinline__ bool reachable(const Bounds& q, const Bounds& k, int causal, int window) {
  bool ok = q.any && k.any;
  ok = ok && (q.smin <= k.smax) && (k.smin <= q.smax);
  if (causal) ok = ok && (k.pmin <= q.pmax);
  if (window > 0) ok = ok && (k.pmax > q.pmin - window);
  return ok;
}

template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

}  // namespace repro_attn

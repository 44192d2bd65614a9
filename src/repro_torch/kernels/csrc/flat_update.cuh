// Device code of the flat VR optimizer updates, shared by flat_update.cu
// (the single-card entries K5-K8) and flat_spmd.cu (the per-row-shard
// entries K13-K17), so the two paths run the same element-wise math and the
// same per-leaf sums.  flat_update.cu's note gives the formulas and the
// design.  Everything here has internal linkage: each library that includes
// it gets its own copy, compiled from this one source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int BLOCK_ROWS = 64;
constexpr int NT = 256;
constexpr int PER_THREAD = BLOCK_ROWS * LANE / 4 / NT;  // float4 vectors per thread (8)
constexpr int64_t BLOCK_VECS = BLOCK_ROWS * LANE / 4;

__device__ __forceinline__ float4 ld(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float4 ld(const __nv_bfloat16* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void st(float* p, int64_t i, float4 x) {
  reinterpret_cast<float4*>(p)[i] = x;
}

__device__ __forceinline__ void st(__nv_bfloat16* p, int64_t i, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[i] = u;
}

__device__ __forceinline__ float raw_r(float g, float g2, float gsnr_eps) {
  const float var = fmaxf(g2 - g * g, 0.f);
  return (g * g) / (var + gsnr_eps);
}

// 1 / max(mean of r_raw over the leaf, 1e-30), from the leaf's sum.
__device__ __forceinline__ float inv_mean_r(const float* racc, const float* inv_sizes, int leaf) {
  return 1.f / fmaxf(racc[leaf] * inv_sizes[leaf], 1e-30f);
}

__device__ __forceinline__ float clip_r(float g, float g2, float inv_mean, float gamma,
                                        float gsnr_eps) {
  return fminf(fmaxf(raw_r(g, g2, gsnr_eps) * inv_mean, gamma), 1.f);
}

// Sum over the block's 256 threads; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = 0.f;
  if (threadIdx.x < NT / 32) x = red[threadIdx.x];
  if (warp == 0) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

struct Hyper {
  float b1, b2, b3, eps, wd, gamma, gsnr_eps;
  float lr, bc1, bc2, bc3;
};

// The VR-Adam chain of one element: GSNR r -> p momentum -> ghat -> m/v ->
// bias-corrected direction plus weight decay (u).
struct Adam {
  float u, m, v, p;
};

__device__ __forceinline__ Adam adam_math(float g, float ga, float g2, float m, float v, float p,
                                          float w, float inv_mean, const Hyper& hp) {
  const float r = clip_r(g, g2, inv_mean, hp.gamma, hp.gsnr_eps);
  const float pn = hp.b3 * p + (1.f - hp.b3) * r;
  const float ghat = (pn / hp.bc3) * ga;
  const float mn = hp.b1 * m + (1.f - hp.b1) * ghat;
  const float vn = hp.b2 * v + (1.f - hp.b2) * ghat * ghat;
  const float dir = (mn / hp.bc1) / (sqrtf(vn / hp.bc2) + hp.eps);
  return {dir + hp.wd * w, mn, vn, pn};
}

__device__ __forceinline__ float4 f4(const float x[4]) { return make_float4(x[0], x[1], x[2], x[3]); }

#define UNPACK(name, v4) const float name[4] = {v4.x, v4.y, v4.z, v4.w}

// Sum over the block's NT threads in f64; the result is valid in thread 0.
__device__ __forceinline__ double block_sum_d(double x, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < NT / 32 ? red[lane] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// One past the last block with a nonzero leaf id, or n_blocks when every id
// is 0.  A row shard's padding blocks carry leaf id 0 after the blocks of
// later leaves; they hold zeros, so the combine leaves them out.
__device__ __forceinline__ int live_end(const int* __restrict__ leaf_ids, int n_blocks) {
  __shared__ int end;
  if (threadIdx.x == 0) end = 0;
  for (int hi = n_blocks; hi > 0; hi -= NT) {
    const int b = hi - NT + (int)threadIdx.x;
    const bool hit = b >= 0 && leaf_ids[b] != 0;
    if (__syncthreads_or(hit)) {  // the same on every thread; orders end = 0 first
      if (hit) atomicMax(&end, b + 1);
      __syncthreads();
      return end;
    }
  }
  return n_blocks;
}

// The first level of a two-level per-leaf sum: thread 0 writes the block's N
// totals to its own f64 slots (sum s of block b at partials[s * n_blocks +
// b]) and takes a ticket; true on every thread of the last block to finish,
// which then sees every block's slots.  ticket: one u32, 0 at launch.
template <int N>
__device__ __forceinline__ bool block_done(const double (&totals)[N], double* __restrict__ partials,
                                           unsigned* __restrict__ ticket) {
  __shared__ bool last;
  const int n_blocks = (int)gridDim.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < N; ++s) partials[(int64_t)s * n_blocks + blockIdx.x] = totals[s];
    __threadfence();  // the partials are visible before the ticket says so
    last = atomicAdd(ticket, 1u) == (unsigned)(n_blocks - 1);
  }
  __syncthreads();
  return last;
}

// The second level, run by the last block: outs[s][leaf] = the leaf's slots
// of sum s added in block order in f64, rounded once to f32, so the sums are
// the same bits on every run.  leaf_ids sorted (a leaf's blocks are
// contiguous), but for trailing padding blocks of id 0 when ``padded`` (a
// row shard's); every leaf slot past the last leaf gets 0.
template <int N>
__device__ void combine_leaf_sums(const double* __restrict__ partials,
                                  const int* __restrict__ leaf_ids, int padded,
                                  float* const (&outs)[N], int leaf_slots, double* red) {
  const int n_blocks = (int)gridDim.x;
  const int n_live = padded ? live_end(leaf_ids, n_blocks) : n_blocks;
  int start = 0;
  for (int leaf = 0; leaf < leaf_slots; ++leaf) {
    int lo = start, hi = n_live;  // end: the first block of a later leaf
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (leaf_ids[mid] <= leaf) lo = mid + 1; else hi = mid;
    }
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const double* part = partials + (int64_t)s * n_blocks;
      double x = 0.0;
#pragma unroll 4
      for (int b = start + threadIdx.x; b < lo; b += NT) x += __ldcg(part + b);
      __syncthreads();  // red is reused
      x = block_sum_d(x, red);
      if (threadIdx.x == 0) outs[s][leaf] = (float)x;
    }
    start = lo;
  }
}

// racc[leaf] = sum of r_raw over the leaf, two-level (flat_update.cu's
// note).  partials: n_blocks f64; ticket: one u32, 0 at launch; ``padded``
// as in combine_leaf_sums.
__global__ void __launch_bounds__(NT) r_sums_kernel(const float* __restrict__ g,
                                                    const float* __restrict__ g2,
                                                    const int* __restrict__ leaf_ids,
                                                    double* __restrict__ partials,
                                                    unsigned* __restrict__ ticket,
                                                    float* __restrict__ racc, int leaf_slots,
                                                    int padded, float gsnr_eps) {
  __shared__ double red[NT / 32];
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 a = ld(g, i), b = ld(g2, i);
    acc += raw_r(a.x, b.x, gsnr_eps) + raw_r(a.y, b.y, gsnr_eps) + raw_r(a.z, b.z, gsnr_eps) +
           raw_r(a.w, b.w, gsnr_eps);
  }
  const double totals[1] = {block_sum_d((double)acc, red)};
  if (!block_done<1>(totals, partials, ticket)) return;
  float* const outs[1] = {racc};
  combine_leaf_sums<1>(partials, leaf_ids, padded, outs, leaf_slots, red);
}

// The operands of the u^2 and w^2 sums (norm_sums): ``partials`` 2 n_blocks
// f64, ``ticket`` one u32 that is 0 at launch, ``padded`` as in
// combine_leaf_sums; the sums land in uacc and wacc (leaf_slots f32 each).
struct Norms {
  double* partials;
  unsigned* ticket;
  float* uacc;
  float* wacc;
  int leaf_slots, padded;
};

// The per-leaf sums of u^2 and w^2 of the LAMB and LARS passes, two-level as
// r_sums_kernel's: the block's sums (f32 over a thread's 32 elements, f64
// across the block) go to its slots of nm.partials, and the last block
// writes nm.uacc and nm.wacc.
__device__ __forceinline__ void norm_sums(float uu, float ww, const int* __restrict__ leaf_ids,
                                          const Norms& nm) {
  __shared__ double red[NT / 32];
  double totals[2];
  totals[0] = block_sum_d((double)uu, red);
  __syncthreads();  // red is reused
  totals[1] = block_sum_d((double)ww, red);
  if (!block_done<2>(totals, nm.partials, nm.ticket)) return;
  float* const outs[2] = {nm.uacc, nm.wacc};
  combine_leaf_sums<2>(nm.partials, leaf_ids, nm.padded, outs, nm.leaf_slots, red);
}

// ---- VR scale: sg = r ga, r -------------------------------------------------

__global__ void __launch_bounds__(NT) scale_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    float* __restrict__ sg, float* __restrict__ r, const int* __restrict__ leaf_ids,
    const float* __restrict__ inv_sizes, const float* __restrict__ racc, float gamma,
    float gsnr_eps) {
  const float inv_mean = inv_mean_r(racc, inv_sizes, leaf_ids[blockIdx.x]);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
#pragma unroll 4
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    float ro[4], so[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ro[e] = clip_r(gv[e], g2v[e], inv_mean, gamma, gsnr_eps);
      so[e] = ro[e] * gav[e];
    }
    st(sg, i, f4(so));
    st(r, i, f4(ro));
  }
}

// ---- VR-Adam / VR-LAMB element-wise pass -------------------------------------

// VR-Adam: upd = -lr u, m'/v'/p' in place.  VR-LAMB (TRUST): u stashed in upd,
// per-leaf sums of u^2 and w^2 into nm.uacc / nm.wacc.
template <typename S, bool TRUST>
__global__ void __launch_bounds__(NT) adam_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    S* __restrict__ m, S* __restrict__ v, S* __restrict__ p, const float* __restrict__ w,
    float* __restrict__ upd, const int* __restrict__ leaf_ids, const float* __restrict__ inv_sizes,
    const float* __restrict__ racc, Norms nm, Hyper hp) {
  const int leaf = leaf_ids[blockIdx.x];
  const float inv_mean = inv_mean_r(racc, inv_sizes, leaf);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
  float uu = 0.f, ww = 0.f;
#pragma unroll 2
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i), w4 = ld(w, i);
    const float4 m4 = ld(m, i), v4 = ld(v, i), p4 = ld(p, i);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    UNPACK(wv, w4);
    UNPACK(mv, m4);
    UNPACK(vv, v4);
    UNPACK(pv, p4);
    float mo[4], vo[4], po[4], uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Adam a = adam_math(gv[e], gav[e], g2v[e], mv[e], vv[e], pv[e], wv[e], inv_mean, hp);
      mo[e] = a.m; vo[e] = a.v; po[e] = a.p;
      if (TRUST) {
        uo[e] = a.u;
        uu += a.u * a.u;
        ww += wv[e] * wv[e];
      } else {
        uo[e] = -hp.lr * a.u;
      }
    }
    st(upd, i, f4(uo));
    st(m, i, f4(mo));
    st(v, i, f4(vo));
    st(p, i, f4(po));
  }
  if (TRUST) norm_sums(uu, ww, leaf_ids, nm);
}

// The per-leaf trust ratio from the norm sums: LAMB clips |w| to [0, 10],
// LARS scales it by trust.
__device__ __forceinline__ float trust_ratio(const float* uacc, const float* wacc, int leaf,
                                             bool lamb, float trust) {
  const float un = sqrtf(uacc[leaf]), pn = sqrtf(wacc[leaf]);
  const float numer = lamb ? fminf(fmaxf(pn, 0.f), 10.f) : trust * pn;
  return (pn > 0.f && un > 0.f) ? numer / (un + 1e-12f) : 1.f;
}

__global__ void __launch_bounds__(NT) lamb_apply_kernel(float* __restrict__ upd,
                                                        const int* __restrict__ leaf_ids,
                                                        const float* __restrict__ uacc,
                                                        const float* __restrict__ wacc, float lr) {
  const float s = -lr * trust_ratio(uacc, wacc, leaf_ids[blockIdx.x], true, 0.f);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    float4 u = ld(upd, i);
    u.x *= s; u.y *= s; u.z *= s; u.w *= s;
    st(upd, i, u);
  }
}

// ---- VR-LARS ---------------------------------------------------------------

__global__ void __launch_bounds__(NT) lars_compute_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ w, float* __restrict__ upd, const int* __restrict__ leaf_ids,
    const float* __restrict__ inv_sizes, const float* __restrict__ racc, Norms nm, float gamma,
    float wd, float gsnr_eps) {
  const int leaf = leaf_ids[blockIdx.x];
  const float inv_mean = inv_mean_r(racc, inv_sizes, leaf);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
  float uu = 0.f, ww = 0.f;
#pragma unroll 4
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i), w4 = ld(w, i);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    UNPACK(wv, w4);
    float uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uo[e] = clip_r(gv[e], g2v[e], inv_mean, gamma, gsnr_eps) * gav[e] + wd * wv[e];
      uu += uo[e] * uo[e];
      ww += wv[e] * wv[e];
    }
    st(upd, i, f4(uo));
  }
  norm_sums(uu, ww, leaf_ids, nm);
}

__global__ void __launch_bounds__(NT) lars_apply_kernel(float* __restrict__ m,
                                                        float* __restrict__ upd,
                                                        const int* __restrict__ leaf_ids,
                                                        const float* __restrict__ uacc,
                                                        const float* __restrict__ wacc, float lr,
                                                        float mu, float trust) {
  const float ratio = trust_ratio(uacc, wacc, leaf_ids[blockIdx.x], false, trust);
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 u4 = ld(upd, i), m4 = ld(m, i);
    UNPACK(uv, u4);
    UNPACK(mv, m4);
    float mo[4], uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mo[e] = mu * mv[e] + ratio * uv[e];
      uo[e] = -lr * mo[e];
    }
    st(m, i, f4(mo));
    st(upd, i, f4(uo));
  }
}

}  // namespace

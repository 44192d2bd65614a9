// Flat VR-LAMB update for Hopper (sm_90a): the whole optimizer step over the
// (n_rows, 128) flat buffer of every parameter.
//
// Replaces the TPU kernel repro/kernels/flat_update.py::_vr_lamb_kernel
// (launched by flat_vr_lamb).  Same math, all in f32 (bodies _raw_r,
// _inv_mean_r, _adam_math, _trust_ratio there):
//   r_raw = g^2 / (max(g2 - g^2, 0) + gsnr_eps)
//   r     = clip(r_raw / mean_leaf(r_raw), gamma, 1)
//   p'    = b3 p + (1 - b3) r;   ghat = (p' / bc3) ga
//   m'    = b1 m + (1 - b1) ghat;   v' = b2 v + (1 - b2) ghat^2
//   u     = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd w
//   upd   = -lr * ratio_leaf * u,  ratio = clip(|w|, 0, 10) / (|u| + 1e-12)
//           where both norms are > 0, else 1
// with m', v', p' stored in the state dtype (f32 or bf16), written in place.
//
// Design.  The TPU kernel runs three sequential grid phases in one launch,
// carrying per-leaf sums in scratch rows.  A CUDA grid has no order between
// blocks, so the phases are three launches on one stream:
//   1. r_partials: per-leaf sum of r_raw;
//   2. compute:    the element-wise chain, u stashed in ``upd``, m'/v'/p'
//                  written, per-leaf sums of u^2 and w^2;
//   3. apply:      upd = -lr * ratio * u in place.
// One block of 256 threads handles one 64-row block of the layout, which
// lies in exactly one leaf (block_leaf_ids); its partial sum goes to the
// leaf's f32 accumulator with one atomicAdd.  The zero tail of every leaf
// (g = ga = w = 0, so u = 0) keeps the sums exact; 1/size is over the TRUE
// leaf sizes.  The accumulators are zeroed by the entry (cudaMemsetAsync).
//
// Bound on the card: bytes.  The function must read g, ga, g2, m, v, p, w
// and write upd, m', v', p' once: 11 f32 buffers, ~16 GB at bert-large's
// flat layout (2.85 M rows), ~4.8 ms at 3.35 TB/s; it does ~40 flops per
// element.  The three passes sweep 15 buffers, not 11: g and g2 are read
// twice and u is written, read and written again, the price of having no
// grid-wide order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int BLOCK_ROWS = 64;
constexpr int NT = 256;
constexpr int PER_THREAD = BLOCK_ROWS * LANE / 4 / NT;  // float4 vectors per thread (8)

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

__global__ void __launch_bounds__(NT) r_partials_kernel(const float* __restrict__ g,
                                                        const float* __restrict__ g2,
                                                        const int* __restrict__ leaf_ids,
                                                        float* __restrict__ racc, float gsnr_eps) {
  __shared__ float red[NT / 32];
  const int64_t base = (int64_t)blockIdx.x * (BLOCK_ROWS * LANE / 4);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 a = ld(g, i), b = ld(g2, i);
    acc += raw_r(a.x, b.x, gsnr_eps) + raw_r(a.y, b.y, gsnr_eps) + raw_r(a.z, b.z, gsnr_eps) +
           raw_r(a.w, b.w, gsnr_eps);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) atomicAdd(racc + leaf_ids[blockIdx.x], acc);
}

template <typename S>
__global__ void __launch_bounds__(NT) compute_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    S* __restrict__ m, S* __restrict__ v, S* __restrict__ p, const float* __restrict__ w,
    float* __restrict__ upd, const int* __restrict__ leaf_ids, const float* __restrict__ inv_sizes,
    const float* __restrict__ racc, float* __restrict__ uacc, float* __restrict__ wacc, Hyper hp) {
  __shared__ float red[NT / 32];
  const int leaf = leaf_ids[blockIdx.x];
  const float inv_mean = 1.f / fmaxf(racc[leaf] * inv_sizes[leaf], 1e-30f);
  const int64_t base = (int64_t)blockIdx.x * (BLOCK_ROWS * LANE / 4);
  float uu = 0.f, ww = 0.f;
#pragma unroll 2
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i), w4 = ld(w, i);
    const float4 m4 = ld(m, i), v4 = ld(v, i), p4 = ld(p, i);
    const float gv[4] = {g4.x, g4.y, g4.z, g4.w}, gav[4] = {ga4.x, ga4.y, ga4.z, ga4.w};
    const float g2v[4] = {g24.x, g24.y, g24.z, g24.w}, wv[4] = {w4.x, w4.y, w4.z, w4.w};
    const float mv[4] = {m4.x, m4.y, m4.z, m4.w}, vv[4] = {v4.x, v4.y, v4.z, v4.w};
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
    float mo[4], vo[4], po[4], uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = fminf(fmaxf(raw_r(gv[e], g2v[e], hp.gsnr_eps) * inv_mean, hp.gamma), 1.f);
      const float pn = hp.b3 * pv[e] + (1.f - hp.b3) * r;
      const float ghat = (pn / hp.bc3) * gav[e];
      const float mn = hp.b1 * mv[e] + (1.f - hp.b1) * ghat;
      const float vn = hp.b2 * vv[e] + (1.f - hp.b2) * ghat * ghat;
      const float dir = (mn / hp.bc1) / (sqrtf(vn / hp.bc2) + hp.eps);
      const float u = dir + hp.wd * wv[e];
      mo[e] = mn; vo[e] = vn; po[e] = pn; uo[e] = u;
      uu += u * u;
      ww += wv[e] * wv[e];
    }
    st(upd, i, make_float4(uo[0], uo[1], uo[2], uo[3]));
    st(m, i, make_float4(mo[0], mo[1], mo[2], mo[3]));
    st(v, i, make_float4(vo[0], vo[1], vo[2], vo[3]));
    st(p, i, make_float4(po[0], po[1], po[2], po[3]));
  }
  uu = block_sum(uu, red);
  __syncthreads();  // red is reused
  ww = block_sum(ww, red);
  if (threadIdx.x == 0) {
    atomicAdd(uacc + leaf, uu);
    atomicAdd(wacc + leaf, ww);
  }
}

__global__ void __launch_bounds__(NT) apply_kernel(float* __restrict__ upd,
                                                   const int* __restrict__ leaf_ids,
                                                   const float* __restrict__ uacc,
                                                   const float* __restrict__ wacc, float lr) {
  const int leaf = leaf_ids[blockIdx.x];
  const float un = sqrtf(uacc[leaf]), pn = sqrtf(wacc[leaf]);
  const float ratio = (pn > 0.f && un > 0.f) ? fminf(fmaxf(pn, 0.f), 10.f) / (un + 1e-12f) : 1.f;
  const float s = -lr * ratio;
  const int64_t base = (int64_t)blockIdx.x * (BLOCK_ROWS * LANE / 4);
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int64_t i = base + t * NT + threadIdx.x;
    float4 u = ld(upd, i);
    u.x *= s; u.y *= s; u.z *= s; u.w *= s;
    st(upd, i, u);
  }
}

template <typename S>
cudaError_t run(const float* g, const float* ga, const float* g2, void* m, void* v, void* p,
                const float* w, float* upd, const int* leaf_ids, const float* inv_sizes,
                float* acc, int leaf_slots, int n_blocks, const Hyper& hp, cudaStream_t s) {
  float* racc = acc;
  float* uacc = acc + leaf_slots;
  float* wacc = acc + 2 * leaf_slots;
  cudaError_t err = cudaMemsetAsync(acc, 0, 3 * (size_t)leaf_slots * sizeof(float), s);
  if (err != cudaSuccess) return err;
  r_partials_kernel<<<n_blocks, NT, 0, s>>>(g, g2, leaf_ids, racc, hp.gsnr_eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  compute_kernel<S><<<n_blocks, NT, 0, s>>>(g, ga, g2, static_cast<S*>(m), static_cast<S*>(v),
                                            static_cast<S*>(p), w, upd, leaf_ids, inv_sizes,
                                            racc, uacc, wacc, hp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  apply_kernel<<<n_blocks, NT, 0, s>>>(upd, leaf_ids, uacc, wacc, hp.lr);
  return cudaGetLastError();
}

}  // namespace

// g, ga, g2, w, upd: (n_blocks * 64, 128) f32; m, v, p: the same shape in f32
// (state_is_bf16=0) or bf16, updated in place; leaf_ids: (n_blocks,) int32;
// inv_sizes: (leaf_slots,) f32; acc: (3, leaf_slots) f32 scratch.
extern "C" int flat_vr_lamb(const void* g, const void* ga, const void* g2, void* m, void* v,
                            void* p, const void* w, void* upd, const void* leaf_ids,
                            const void* inv_sizes, void* acc, int leaf_slots, int n_blocks,
                            int state_is_bf16, float lr, float bc1, float bc2, float bc3,
                            float b1, float b2, float b3, float eps, float wd, float gamma,
                            float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Hyper hp{b1, b2, b3, eps, wd, gamma, gsnr_eps, lr, bc1, bc2, bc3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* gaf = static_cast<const float*>(ga);
  const float* g2f = static_cast<const float*>(g2);
  const float* wf = static_cast<const float*>(w);
  float* uf = static_cast<float*>(upd);
  const int* ids = static_cast<const int*>(leaf_ids);
  const float* inv = static_cast<const float*>(inv_sizes);
  float* accf = static_cast<float*>(acc);
  if (state_is_bf16)
    return run<__nv_bfloat16>(gf, gaf, g2f, m, v, p, wf, uf, ids, inv, accf, leaf_slots, n_blocks,
                              hp, s);
  return run<float>(gf, gaf, g2f, m, v, p, wf, uf, ids, inv, accf, leaf_slots, n_blocks, hp, s);
}

// Flat VR optimizer updates for Hopper (sm_90a): the whole optimizer step over
// the (n_rows, 128) flat buffer of every parameter.
//
// Replaces the TPU kernels of repro/kernels/flat_update.py (bodies _raw_r,
// _inv_mean_r, _adam_math and _trust_ratio there), with the same math, all in
// f32:
//   r_raw = g^2 / (max(g2 - g^2, 0) + gsnr_eps)
//   r     = clip(r_raw / mean_leaf(r_raw), gamma, 1)
//
//   flat_vr_scale (_vr_scale_kernel, VR-SGD / VR-Momentum):
//     sg = r ga, and r itself
//   flat_vr_adam (_vr_adam_kernel) and flat_vr_lamb (_vr_lamb_kernel):
//     p' = b3 p + (1 - b3) r;   ghat = (p' / bc3) ga
//     m' = b1 m + (1 - b1) ghat;   v' = b2 v + (1 - b2) ghat^2
//     u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd w
//     VR-Adam: upd = -lr u
//     VR-LAMB: upd = -lr ratio_leaf u,  ratio = clip(|w|, 0, 10) / (|u| + 1e-12)
//              where both norms are > 0, else 1
//     with m', v', p' stored in the state dtype (f32 or bf16), in place.
//   flat_vr_lars (_vr_lars_kernel):
//     u  = r ga + wd w
//     m' = mu m + ratio_leaf u,  ratio = trust |w| / (|u| + 1e-12) where both
//          norms are > 0, else 1 (LARS: no clip of |w|);  upd = -lr m'
//     with m' in f32, in place.
//
// Design.  The TPU kernels run two or three sequential grid phases in one
// launch, carrying per-leaf sums in scratch rows.  A CUDA grid has no order
// between blocks, so the phases are launches on one stream:
//   1. r_partials: per-leaf sum of r_raw (every entry);
//   2. the element-wise pass: scale / adam write their outputs here; lamb and
//      lars stash u in ``upd`` and add per-leaf sums of u^2 and w^2;
//   3. (lamb, lars) the trust-ratio apply over the stashed u.
// One block of 256 threads handles one 64-row block of the layout, which
// lies in exactly one leaf (block_leaf_ids); its partial sum goes to the
// leaf's f32 accumulator with one atomicAdd.  The zero tail of every leaf
// (g = g2 = ga = w = 0, so r_raw = u = 0) keeps the sums exact; 1/size is
// over the TRUE leaf sizes.  In the tail r is clipped up to gamma, so
// sg = 0 and p' = b3 p + (1 - b3) gamma there, as in the reference.  The
// accumulators are zeroed by the entry (cudaMemsetAsync).
//
// Bound on the card: bytes (each does < 50 flops per element).  At
// bert-large's flat layout (2.85 M rows, 1.46 GB per f32 buffer) the
// functions must move: scale 3 in + 2 out = 5 buffers (7.3 GB, 2.2 ms at
// 3.35 TB/s); adam 7 in + 4 out = 11 f32 buffers (16.0 GB, 4.8 ms; bf16
// state 11.7 GB, 3.5 ms); lamb the same as adam; lars 5 in + 2 out = 7
// buffers (10.2 GB, 3.05 ms).  The passes sweep more, the price of having no
// grid-wide order: g and g2 are read twice by every entry, and lamb/lars
// write u, read it and write again (scale 7, adam 13, lamb 15, lars 11).
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

__global__ void __launch_bounds__(NT) r_partials_kernel(const float* __restrict__ g,
                                                        const float* __restrict__ g2,
                                                        const int* __restrict__ leaf_ids,
                                                        float* __restrict__ racc, float gsnr_eps) {
  __shared__ float red[NT / 32];
  const int64_t base = (int64_t)blockIdx.x * BLOCK_VECS;
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
// per-leaf sums of u^2 and w^2 into uacc / wacc.
template <typename S, bool TRUST>
__global__ void __launch_bounds__(NT) adam_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    S* __restrict__ m, S* __restrict__ v, S* __restrict__ p, const float* __restrict__ w,
    float* __restrict__ upd, const int* __restrict__ leaf_ids, const float* __restrict__ inv_sizes,
    const float* __restrict__ racc, float* __restrict__ uacc, float* __restrict__ wacc, Hyper hp) {
  __shared__ float red[NT / 32];
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
  if (TRUST) {
    uu = block_sum(uu, red);
    __syncthreads();  // red is reused
    ww = block_sum(ww, red);
    if (threadIdx.x == 0) {
      atomicAdd(uacc + leaf, uu);
      atomicAdd(wacc + leaf, ww);
    }
  }
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
    const float* __restrict__ inv_sizes, const float* __restrict__ racc, float* __restrict__ uacc,
    float* __restrict__ wacc, float gamma, float wd, float gsnr_eps) {
  __shared__ float red[NT / 32];
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
  uu = block_sum(uu, red);
  __syncthreads();  // red is reused
  ww = block_sum(ww, red);
  if (threadIdx.x == 0) {
    atomicAdd(uacc + leaf, uu);
    atomicAdd(wacc + leaf, ww);
  }
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

// ---- host side -------------------------------------------------------------

struct Flat {
  const int* leaf_ids;
  const float* inv_sizes;
  float* acc;  // (n_acc, leaf_slots) f32
  int leaf_slots, n_blocks;
};

// Zeroes n_acc accumulator rows, then sums r_raw per leaf into row 0.
cudaError_t r_partials(const Flat& f, int n_acc, const float* g, const float* g2, float gsnr_eps,
                       cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(f.acc, 0, (size_t)n_acc * f.leaf_slots * sizeof(float), s);
  if (err != cudaSuccess) return err;
  r_partials_kernel<<<f.n_blocks, NT, 0, s>>>(g, g2, f.leaf_ids, f.acc, gsnr_eps);
  return cudaGetLastError();
}

template <typename S, bool TRUST>
cudaError_t run_adam(const Flat& f, const float* g, const float* ga, const float* g2, void* m,
                     void* v, void* p, const float* w, float* upd, const Hyper& hp,
                     cudaStream_t s) {
  float* racc = f.acc;
  float* uacc = f.acc + f.leaf_slots;
  float* wacc = f.acc + 2 * f.leaf_slots;
  cudaError_t err = r_partials(f, TRUST ? 3 : 1, g, g2, hp.gsnr_eps, s);
  if (err != cudaSuccess) return err;
  adam_kernel<S, TRUST><<<f.n_blocks, NT, 0, s>>>(
      g, ga, g2, static_cast<S*>(m), static_cast<S*>(v), static_cast<S*>(p), w, upd, f.leaf_ids,
      f.inv_sizes, racc, uacc, wacc, hp);
  if ((err = cudaGetLastError()) != cudaSuccess || !TRUST) return err;
  lamb_apply_kernel<<<f.n_blocks, NT, 0, s>>>(upd, f.leaf_ids, uacc, wacc, hp.lr);
  return cudaGetLastError();
}

template <bool TRUST>
int adam_entry(const void* g, const void* ga, const void* g2, void* m, void* v, void* p,
               const void* w, void* upd, const void* leaf_ids, const void* inv_sizes, void* acc,
               int leaf_slots, int n_blocks, int state_is_bf16, float lr, float bc1, float bc2,
               float bc3, float b1, float b2, float b3, float eps, float wd, float gamma,
               float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Hyper hp{b1, b2, b3, eps, wd, gamma, gsnr_eps, lr, bc1, bc2, bc3};
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* gaf = static_cast<const float*>(ga);
  const float* g2f = static_cast<const float*>(g2);
  const float* wf = static_cast<const float*>(w);
  float* uf = static_cast<float*>(upd);
  if (state_is_bf16)
    return run_adam<__nv_bfloat16, TRUST>(f, gf, gaf, g2f, m, v, p, wf, uf, hp, s);
  return run_adam<float, TRUST>(f, gf, gaf, g2f, m, v, p, wf, uf, hp, s);
}

}  // namespace

// Shapes of every entry: g, ga, g2, w, upd, sg, r: (n_blocks * 64, 128) f32;
// leaf_ids: (n_blocks,) int32; inv_sizes: (leaf_slots,) f32; acc: f32
// scratch of (1 or 3, leaf_slots).  The state m, v, p is updated in place.

// VR-LAMB.  m, v, p: f32 (state_is_bf16=0) or bf16; acc (3, leaf_slots).
extern "C" int flat_vr_lamb(const void* g, const void* ga, const void* g2, void* m, void* v,
                            void* p, const void* w, void* upd, const void* leaf_ids,
                            const void* inv_sizes, void* acc, int leaf_slots, int n_blocks,
                            int state_is_bf16, float lr, float bc1, float bc2, float bc3,
                            float b1, float b2, float b3, float eps, float wd, float gamma,
                            float gsnr_eps, void* stream) {
  return adam_entry<true>(g, ga, g2, m, v, p, w, upd, leaf_ids, inv_sizes, acc, leaf_slots,
                          n_blocks, state_is_bf16, lr, bc1, bc2, bc3, b1, b2, b3, eps, wd, gamma,
                          gsnr_eps, stream);
}

// VR-Adam.  m, v, p: f32 (state_is_bf16=0) or bf16; acc (1, leaf_slots).
extern "C" int flat_vr_adam(const void* g, const void* ga, const void* g2, void* m, void* v,
                            void* p, const void* w, void* upd, const void* leaf_ids,
                            const void* inv_sizes, void* acc, int leaf_slots, int n_blocks,
                            int state_is_bf16, float lr, float bc1, float bc2, float bc3,
                            float b1, float b2, float b3, float eps, float wd, float gamma,
                            float gsnr_eps, void* stream) {
  return adam_entry<false>(g, ga, g2, m, v, p, w, upd, leaf_ids, inv_sizes, acc, leaf_slots,
                           n_blocks, state_is_bf16, lr, bc1, bc2, bc3, b1, b2, b3, eps, wd, gamma,
                           gsnr_eps, stream);
}

// VR scale (VR-SGD / VR-Momentum): sg = r ga and r; acc (1, leaf_slots).
extern "C" int flat_vr_scale(const void* g, const void* ga, const void* g2, void* sg, void* r,
                             const void* leaf_ids, const void* inv_sizes, void* acc,
                             int leaf_slots, int n_blocks, float gamma, float gsnr_eps,
                             void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* g2f = static_cast<const float*>(g2);
  cudaError_t err = r_partials(f, 1, gf, g2f, gsnr_eps, s);
  if (err != cudaSuccess) return err;
  scale_kernel<<<n_blocks, NT, 0, s>>>(gf, static_cast<const float*>(ga), g2f,
                                       static_cast<float*>(sg), static_cast<float*>(r), f.leaf_ids,
                                       f.inv_sizes, f.acc, gamma, gsnr_eps);
  return cudaGetLastError();
}

// VR-LARS.  m: f32, updated in place; acc (3, leaf_slots).
extern "C" int flat_vr_lars(const void* g, const void* ga, const void* g2, void* m, const void* w,
                            void* upd, const void* leaf_ids, const void* inv_sizes, void* acc,
                            int leaf_slots, int n_blocks, float lr, float gamma, float mu,
                            float wd, float trust, float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* g2f = static_cast<const float*>(g2);
  float* uf = static_cast<float*>(upd);
  float* uacc = f.acc + leaf_slots;
  float* wacc = f.acc + 2 * leaf_slots;
  cudaError_t err = r_partials(f, 3, gf, g2f, gsnr_eps, s);
  if (err != cudaSuccess) return err;
  lars_compute_kernel<<<n_blocks, NT, 0, s>>>(gf, static_cast<const float*>(ga), g2f,
                                              static_cast<const float*>(w), uf, f.leaf_ids,
                                              f.inv_sizes, f.acc, uacc, wacc, gamma, wd, gsnr_eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lars_apply_kernel<<<n_blocks, NT, 0, s>>>(static_cast<float*>(m), uf, f.leaf_ids, uacc, wacc,
                                            lr, mu, trust);
  return cudaGetLastError();
}

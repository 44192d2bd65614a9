// Per-leaf VR optimizer kernels for Hopper (sm_90a): the GSNR scale, the
// VR-Adam inner step and the VR-LAMB / VR-LARS steps with their norm sums,
// each on ONE parameter leaf (the per-leaf dispatch, beside the flat
// single-launch updates of flat_update.cu).
//
// Replaces the TPU kernels repro/kernels/vr_update.py::_kernel (vr_scale),
// vr_adam.py::_kernel (vr_adam_inner), vr_lamb.py::_lamb_kernel
// (vr_lamb_inner) and vr_lamb.py::_lars_kernel (vr_lars_inner).  Same math,
// all in f32, with inv_mean = 1 / max(mean of r_raw over the leaf, 1e-30)
// from a plain prepass (as the reference computes it in jnp outside the
// kernel) read from device memory, so no host sync:
//   r     = clip(g^2 / (max(g2 - g^2, 0) + eps) * inv_mean, gamma, 1)
//   scale: sg = r ga, and r
//   adam:  p' = b3 p + (1 - b3) r;  ghat = (p' / bc3) ga
//          m' = b1 m + (1 - b1) ghat;  v' = b2 v + (1 - b2) ghat^2
//          dir = (m' / bc1) / (sqrt(v' / bc2) + eps)
//   lamb:  u = dir + wd w, and sum(u^2), sum(w^2) over the leaf
//   lars:  u = r ga + wd w, and sum(u^2), sum(w^2)
// The element-wise math is flat_update.cuh's (clip_r, adam_math, the same
// functions K5-K8 run); nothing of it is written twice.
//
// Design.  The wrapper casts and zero-pads each operand to the reference's
// (rows, 128) f32 layout (a plain op, as _pad2d does; a view when the leaf
// already is f32 and whole rows).  Each thread streams float4 vectors in a
// grid-stride loop.  The TPU kernels carry the (1, 128) lane partials of
// the norms across their sequential grid; here each block reduces its
// threads' sums (warp shuffles) and adds them to two f32 accumulators with
// one atomicAdd each, zeroed by the entry.  The zero tail adds exact zeros
// (g = ga = w = m = v = 0 there, so dir = u = 0).
//
// Bound on the card: bytes (< 50 flops per element).  At bert-large's
// largest leaf, the stacked MLP input weight (24, 1024, 4096) of 100.7 M
// f32 elements (403 MB a buffer): scale 3 in + 2 out (2.01 GB, 0.60 ms at
// 3.35 TB/s); adam 6 in + 4 out (4.03 GB, 1.20 ms); lamb 7 in + 4 out
// (4.43 GB, 1.32 ms); lars 4 in + 1 out (2.01 GB, 0.60 ms).
#include "flat_update.cuh"

namespace {

__global__ void __launch_bounds__(NT) leaf_scale_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ scal, float* __restrict__ sg, float* __restrict__ r, int64_t n4,
    float gamma, float eps) {
  const float inv_mean = scal[0];
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    float ro[4], so[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ro[e] = clip_r(gv[e], g2v[e], inv_mean, gamma, eps);
      so[e] = ro[e] * gav[e];
    }
    st(sg, i, f4(so));
    st(r, i, f4(ro));
  }
}

// VR-Adam (TRUST false): u = dir (hp.wd = 0, no w).  VR-LAMB (TRUST true):
// u = dir + wd w, and the block's sums of u^2 and w^2 into acc[0], acc[1].
template <bool TRUST>
__global__ void __launch_bounds__(NT) leaf_adam_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ m, const float* __restrict__ v, const float* __restrict__ p,
    const float* __restrict__ w, const float* __restrict__ scal, float* __restrict__ u,
    float* __restrict__ m_out, float* __restrict__ v_out, float* __restrict__ p_out,
    float* __restrict__ acc, int64_t n4, Hyper hp) {
  __shared__ float red[NT / 32];
  const float inv_mean = scal[0];
  float uu = 0.f, ww = 0.f;
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i);
    const float4 m4 = ld(m, i), v4 = ld(v, i), p4 = ld(p, i);
    const float4 w4 = TRUST ? ld(w, i) : make_float4(0.f, 0.f, 0.f, 0.f);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    UNPACK(mv, m4);
    UNPACK(vv, v4);
    UNPACK(pv, p4);
    UNPACK(wv, w4);
    float uo[4], mo[4], vo[4], po[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Adam a = adam_math(gv[e], gav[e], g2v[e], mv[e], vv[e], pv[e], wv[e], inv_mean, hp);
      uo[e] = a.u; mo[e] = a.m; vo[e] = a.v; po[e] = a.p;
      if (TRUST) {
        uu += a.u * a.u;
        ww += wv[e] * wv[e];
      }
    }
    st(u, i, f4(uo));
    st(m_out, i, f4(mo));
    st(v_out, i, f4(vo));
    st(p_out, i, f4(po));
  }
  if (TRUST) {
    uu = block_sum(uu, red);
    __syncthreads();  // red is reused
    ww = block_sum(ww, red);
    if (threadIdx.x == 0) {
      atomicAdd(acc, uu);
      atomicAdd(acc + 1, ww);
    }
  }
}

__global__ void __launch_bounds__(NT) leaf_lars_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ w, const float* __restrict__ scal, float* __restrict__ u,
    float* __restrict__ acc, int64_t n4, float gamma, float wd, float eps) {
  __shared__ float red[NT / 32];
  const float inv_mean = scal[0];
  float uu = 0.f, ww = 0.f;
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 g4 = ld(g, i), ga4 = ld(ga, i), g24 = ld(g2, i), w4 = ld(w, i);
    UNPACK(gv, g4);
    UNPACK(gav, ga4);
    UNPACK(g2v, g24);
    UNPACK(wv, w4);
    float uo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uo[e] = clip_r(gv[e], g2v[e], inv_mean, gamma, eps) * gav[e] + wd * wv[e];
      uu += uo[e] * uo[e];
      ww += wv[e] * wv[e];
    }
    st(u, i, f4(uo));
  }
  uu = block_sum(uu, red);
  __syncthreads();  // red is reused
  ww = block_sum(ww, red);
  if (threadIdx.x == 0) {
    atomicAdd(acc, uu);
    atomicAdd(acc + 1, ww);
  }
}

unsigned leaf_grid(int64_t n4, int n_sm) {
  const int64_t want = (n4 + NT - 1) / NT;
  const int64_t cap = (int64_t)n_sm * 16;  // enough resident blocks to keep every SM streaming
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// Every operand is n f32 (n a multiple of 4, the padded leaf); scal holds
// inv_mean.  Outputs are separate buffers.
extern "C" int leaf_vr_scale(const void* g, const void* ga, const void* g2, const void* scal,
                             void* sg, void* r, long long n, float gamma, float eps, int n_sm,
                             void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  leaf_scale_kernel<<<leaf_grid(n4, n_sm), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(ga), static_cast<const float*>(g2),
      static_cast<const float*>(scal), static_cast<float*>(sg), static_cast<float*>(r), n4, gamma,
      eps);
  return cudaGetLastError();
}

// trust 0: VR-Adam (w and acc unused, may be null; wd ignored).  trust 1:
// VR-LAMB, acc = 2 f32 (sum u^2, sum w^2), zeroed here.
extern "C" int leaf_vr_adam(const void* g, const void* ga, const void* g2, const void* m,
                            const void* v, const void* p, const void* w, const void* scal,
                            void* u, void* m_out, void* v_out, void* p_out, void* acc,
                            long long n, float b1, float b2, float b3, float eps, float wd,
                            float gamma, float gsnr_eps, float bc1, float bc2, float bc3,
                            int trust, int n_sm, void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper hp{b1, b2, b3, eps, trust ? wd : 0.f, gamma, gsnr_eps, 0.f, bc1, bc2, bc3};
  const float* in[] = {static_cast<const float*>(g), static_cast<const float*>(ga),
                       static_cast<const float*>(g2), static_cast<const float*>(m),
                       static_cast<const float*>(v), static_cast<const float*>(p),
                       static_cast<const float*>(w), static_cast<const float*>(scal)};
  float* out[] = {static_cast<float*>(u), static_cast<float*>(m_out), static_cast<float*>(v_out),
                  static_cast<float*>(p_out), static_cast<float*>(acc)};
  if (trust) {
    cudaError_t err = cudaMemsetAsync(acc, 0, 2 * sizeof(float), s);
    if (err != cudaSuccess) return err;
    leaf_adam_kernel<true><<<leaf_grid(n4, n_sm), NT, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1], out[2], out[3],
        out[4], n4, hp);
  } else {
    leaf_adam_kernel<false><<<leaf_grid(n4, n_sm), NT, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1], out[2], out[3],
        out[4], n4, hp);
  }
  return cudaGetLastError();
}

// acc = 2 f32 (sum u^2, sum w^2), zeroed here.
extern "C" int leaf_vr_lars(const void* g, const void* ga, const void* g2, const void* w,
                            const void* scal, void* u, void* acc, long long n, float gamma,
                            float wd, float eps, int n_sm, void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, 2 * sizeof(float), s);
  if (err != cudaSuccess) return err;
  leaf_lars_kernel<<<leaf_grid(n4, n_sm), NT, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(ga), static_cast<const float*>(g2),
      static_cast<const float*>(w), static_cast<const float*>(scal), static_cast<float*>(u),
      static_cast<float*>(acc), n4, gamma, wd, eps);
  return cudaGetLastError();
}

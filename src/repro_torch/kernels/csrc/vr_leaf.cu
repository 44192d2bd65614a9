// Per-leaf VR optimizer kernels for Hopper (sm_90a): the GSNR scale, the
// VR-Adam inner step and the VR-LAMB / VR-LARS steps with their norm sums,
// each on ONE parameter leaf (the per-leaf dispatch, beside the flat
// single-launch updates of flat_update.cu), and the GSNR prepass they all
// read.
//
// Replaces the TPU kernels repro/kernels/vr_update.py::_kernel (vr_scale),
// vr_adam.py::_kernel (vr_adam_inner), vr_lamb.py::_lamb_kernel
// (vr_lamb_inner) and vr_lamb.py::_lars_kernel (vr_lars_inner), and the
// scalar the reference computes in jnp before each of them
// (vr_update.py:73-77, one XLA reduction; leaf_inv_mean here).  Same math,
// all in f32, with inv_mean = 1 / max(mean of r_raw over the leaf's
// unpadded elements, 1e-30) written to device memory by the prepass kernel
// and read from there by the next one, so no host sync:
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
// Design.  The prepass (inv_mean_kernel) reads g and g2 as they are, f32 or
// bf16, with no padded copy.  Each thread sums r over float4 vectors in a
// grid-stride loop (RED_UNROLL vectors of each in flight) in f32.  Blocks
// of RED_NT threads (the wrapper caps the grid at two an SM) combine their
// threads in f64 with warp shuffles and write one partial each.  The last
// block to finish (a __threadfence and an atomic counter, which it resets)
// adds the partials in a fixed order in f64 and writes inv_mean.  So it is
// one launch, gives the same bits on every run (the grid, and so every
// order, is fixed by n and the card), and a CUDA graph can replay it.  The
// leaf's n % 4 last elements (all of them, where a pointer is not aligned
// for vector loads) go through a scalar loop.  Each r is rounded as the
// plain version's separate ops round it (no contraction into an FMA).
// The steps: the wrapper casts and zero-pads each operand to the
// reference's (rows, 128) f32 layout (a plain op, as _pad2d does; a view
// when the leaf already is f32 and whole rows).  Each thread streams float4
// vectors in a grid-stride loop.  The TPU kernels carry the (1, 128) lane
// partials of the norms across their sequential grid; here the norm sums
// are flat_update.cuh's two-level f64 combine (leaf_norm_sums): each block
// reduces its threads' f32 sums in f64 into its own two slots, and the last
// block to finish adds the slots in block order in f64 and rounds each sum
// once to f32, so the sums are the same bits on every run.  The zero tail
// adds exact zeros (g = ga = w = m = v = 0 there, so dir = u = 0).
//
// Bound on the card: bytes (< 50 flops per element).  At bert-large's
// largest leaf, the stacked MLP input weight (24, 1024, 4096) of 100.7 M
// f32 elements (403 MB a buffer): the prepass 2 in (805 MB, 0.24 ms at
// 3.35 TB/s); scale 3 in + 2 out (2.01 GB, 0.60 ms); adam 6 in + 4 out
// (4.03 GB, 1.20 ms); lamb 7 in + 4 out (4.43 GB, 1.32 ms); lars 4 in + 1
// out (2.01 GB, 0.60 ms).
#include "flat_update.cuh"

namespace {

// The leaf's sums of u^2 and w^2: each block's f64 totals to its slots of
// ``partials`` (2 x gridDim.x), and the last block to finish adds them in
// block order in f64, writes acc[0], acc[1] rounded once to f32 and resets
// ``ticket`` (one u32, 0 at launch) for the next launch on the stream.
__device__ __forceinline__ void leaf_norm_sums(float uu, float ww, double* __restrict__ partials,
                                               unsigned* __restrict__ ticket,
                                               float* __restrict__ acc) {
  __shared__ double red[NT / 32];
  double totals[2];
  totals[0] = block_sum_d((double)uu, red);
  __syncthreads();  // red is reused
  totals[1] = block_sum_d((double)ww, red);
  if (!block_done<2>(totals, partials, ticket)) return;
  const int n_blocks = (int)gridDim.x;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    double x = 0.0;
    for (int b = threadIdx.x; b < n_blocks; b += NT) x += __ldcg(partials + (int64_t)s * n_blocks + b);
    __syncthreads();  // red is reused
    x = block_sum_d(x, red);
    if (threadIdx.x == 0) acc[s] = (float)x;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

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
// u = dir + wd w, and the leaf's sums of u^2 and w^2 into acc[0], acc[1].
template <bool TRUST>
__global__ void __launch_bounds__(NT) leaf_adam_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ m, const float* __restrict__ v, const float* __restrict__ p,
    const float* __restrict__ w, const float* __restrict__ scal, float* __restrict__ u,
    float* __restrict__ m_out, float* __restrict__ v_out, float* __restrict__ p_out,
    float* __restrict__ acc, double* __restrict__ partials, unsigned* __restrict__ ticket,
    int64_t n4, Hyper hp) {
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
  if (TRUST) leaf_norm_sums(uu, ww, partials, ticket, acc);
}

__global__ void __launch_bounds__(NT) leaf_lars_kernel(
    const float* __restrict__ g, const float* __restrict__ ga, const float* __restrict__ g2,
    const float* __restrict__ w, const float* __restrict__ scal, float* __restrict__ u,
    float* __restrict__ acc, double* __restrict__ partials, unsigned* __restrict__ ticket,
    int64_t n4, float gamma, float wd, float eps) {
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
  leaf_norm_sums(uu, ww, partials, ticket, acc);
}

// ---- the GSNR prepass: inv_mean = 1 / max(sum(r_raw) / n, 1e-30) -----------

constexpr int RED_NT = 512;
constexpr int RED_UNROLL = 4;

// r_raw of one element, each operation rounded on its own as the plain
// version's separate ops are (__fmul_rn is never contracted into an FMA).
__device__ __forceinline__ float r_exact(float g, float g2, float eps) {
  const float gg = __fmul_rn(g, g);
  return gg / (fmaxf(g2 - gg, 0.f) + eps);
}

__device__ __forceinline__ float ld1(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float r4(float4 g, float4 g2, float eps) {
  return ((r_exact(g.x, g2.x, eps) + r_exact(g.y, g2.y, eps)) + r_exact(g.z, g2.z, eps)) +
         r_exact(g.w, g2.w, eps);
}

// Sum over the block's RED_NT threads in f64; the result is valid in thread 0.
__device__ __forceinline__ double block_sum_f64(double x, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < RED_NT / 32 ? red[lane] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// partials: gridDim.x f64; counter: one u32, 0 before the launch and after
// it; vec: g and g2 are aligned for vector loads (else every element goes
// through the scalar loop).
template <typename G, typename G2>
__global__ void __launch_bounds__(RED_NT) inv_mean_kernel(
    const G* __restrict__ g, const G2* __restrict__ g2, int64_t n, bool vec, float eps,
    double* __restrict__ partials, unsigned* __restrict__ counter, float* __restrict__ inv) {
  __shared__ double red[RED_NT / 32];
  __shared__ bool last;
  const int64_t n4 = vec ? n / 4 : 0;
  const int64_t stride = (int64_t)gridDim.x * RED_NT;
  int64_t i = (int64_t)blockIdx.x * RED_NT + threadIdx.x;
  float acc = 0.f;
  for (; i + (RED_UNROLL - 1) * stride < n4; i += RED_UNROLL * stride) {
    float4 a[RED_UNROLL], b[RED_UNROLL];
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) {
      a[u] = ld(g, i + u * stride);
      b[u] = ld(g2, i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < RED_UNROLL; ++u) acc += r4(a[u], b[u], eps);
  }
  for (; i < n4; i += stride) acc += r4(ld(g, i), ld(g2, i), eps);
  for (int64_t e = 4 * n4 + (int64_t)blockIdx.x * RED_NT + threadIdx.x; e < n; e += stride)
    acc += r_exact(ld1(g, e), ld1(g2, e), eps);

  const double total = block_sum_f64((double)acc, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();  // the partial is visible before the count says so
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  double s = 0.0;  // the last block: every partial, in block order
  for (int b = threadIdx.x; b < (int)gridDim.x; b += RED_NT) s += __ldcg(partials + b);
  __syncthreads();  // red is reused
  s = block_sum_f64(s, red);
  if (threadIdx.x == 0) {
    *inv = 1.f / fmaxf((float)(s / (double)n), 1e-30f);
    *counter = 0u;  // ready for the next launch on this stream
  }
}

template <typename G, typename G2>
cudaError_t launch_inv_mean(const void* g, const void* g2, int64_t n, float eps, void* partials,
                            int max_blocks, void* counter, void* inv, cudaStream_t s) {
  const int vec_bytes = (sizeof(G) == 4 ? 16 : 8);
  const int vec_bytes2 = (sizeof(G2) == 4 ? 16 : 8);
  const bool vec = reinterpret_cast<uintptr_t>(g) % vec_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(g2) % vec_bytes2 == 0;
  const int64_t per_block = (int64_t)RED_NT * RED_UNROLL * (vec ? 4 : 1);
  const int64_t want = (n + per_block - 1) / per_block;
  const unsigned grid = (unsigned)(want < max_blocks ? (want > 0 ? want : 1) : max_blocks);
  inv_mean_kernel<G, G2><<<grid, RED_NT, 0, s>>>(
      static_cast<const G*>(g), static_cast<const G2*>(g2), n, vec, eps,
      static_cast<double*>(partials), static_cast<unsigned*>(counter), static_cast<float*>(inv));
  return cudaGetLastError();
}

unsigned leaf_grid(int64_t n4, int n_sm) {
  const int64_t want = (n4 + NT - 1) / NT;
  const int64_t cap = (int64_t)n_sm * 16;  // enough resident blocks to keep every SM streaming
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// g, g2: n elements each (any n >= 1), f32 or bf16 (g_is_bf16, g2_is_bf16);
// partials: max_blocks f64 of scratch; counter: one u32 that is 0 and that
// no launch in flight on another stream shares; inv: one f32, written.
extern "C" int leaf_inv_mean(const void* g, const void* g2, long long n, int g_is_bf16,
                             int g2_is_bf16, float eps, void* partials, int max_blocks,
                             void* counter, void* inv, void* stream) {
  if (n < 1 || max_blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (g_is_bf16 && g2_is_bf16)
    return launch_inv_mean<B, B>(g, g2, n, eps, partials, max_blocks, counter, inv, s);
  if (g_is_bf16)
    return launch_inv_mean<B, float>(g, g2, n, eps, partials, max_blocks, counter, inv, s);
  if (g2_is_bf16)
    return launch_inv_mean<float, B>(g, g2, n, eps, partials, max_blocks, counter, inv, s);
  return launch_inv_mean<float, float>(g, g2, n, eps, partials, max_blocks, counter, inv, s);
}

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

// trust 0: VR-Adam (w, acc, partials and ticket unused, may be null; wd
// ignored).  trust 1: VR-LAMB, acc = 2 f32 (sum u^2, sum w^2), written;
// partials 2 * 16 * n_sm f64 of scratch; ticket one u32 that is 0 and that no
// launch in flight on another stream shares (left at 0).
extern "C" int leaf_vr_adam(const void* g, const void* ga, const void* g2, const void* m,
                            const void* v, const void* p, const void* w, const void* scal,
                            void* u, void* m_out, void* v_out, void* p_out, void* acc,
                            void* partials, void* ticket, long long n, float b1, float b2, float b3, float eps, float wd,
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
  double* part = static_cast<double*>(partials);
  unsigned* tick = static_cast<unsigned*>(ticket);
  if (trust) {
    leaf_adam_kernel<true><<<leaf_grid(n4, n_sm), NT, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1], out[2], out[3],
        out[4], part, tick, n4, hp);
  } else {
    leaf_adam_kernel<false><<<leaf_grid(n4, n_sm), NT, 0, s>>>(
        in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1], out[2], out[3],
        out[4], part, tick, n4, hp);
  }
  return cudaGetLastError();
}

// acc = 2 f32 (sum u^2, sum w^2), written; partials and ticket as for
// leaf_vr_adam's trust 1.
extern "C" int leaf_vr_lars(const void* g, const void* ga, const void* g2, const void* w,
                            const void* scal, void* u, void* acc, void* partials, void* ticket,
                            long long n, float gamma, float wd, float eps, int n_sm,
                            void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  leaf_lars_kernel<<<leaf_grid(n4, n_sm), NT, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(ga), static_cast<const float*>(g2),
      static_cast<const float*>(w), static_cast<const float*>(scal), static_cast<float*>(u),
      static_cast<float*>(acc), static_cast<double*>(partials), static_cast<unsigned*>(ticket),
      n4, gamma, wd, eps);
  return cudaGetLastError();
}

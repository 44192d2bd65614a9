// Flat gradient-moment carry for Hopper (sm_90a): the k-microbatch
// accumulate and the /k finalize over the whole (n_rows, 128) flat buffer,
// the g-only accumulate of stale-GSNR steps, the [g; g^2] payload of
// the data-parallel step, and the one-launch moments of a (k, n) gradient
// stack (the vmap stats method).
//
// Replaces the TPU kernels repro/kernels/grad_stats.py::_accum_kernel and
// ::_finalize_kernel as launched by repro/kernels/flat_stats.py::
// flat_moments_accum and ::flat_moments_finalize, and flat_stats.py::
// _g_accum_kernel (flat_g_accum), flat_stats.py::_pack_square_kernel
// (flat_pack_square) and flat_stats.py::_vmap_kernel (flat_vmap_moments).
// The per-leaf carry of repro/kernels/grad_stats.py::moments_accum and
// ::moments_finalize launches the same accumulate and finalize on one
// leaf's (rows, 128) carry.  Same math:
//   accumulate:  g_sum += g,  g2_sum += g * g   (g cast to f32)
//   finalize:    mean = g_sum * inv_k,  sq_mean = g2_sum * inv_k
//   g-only:      g_sum += g                     (g cast to f32)
//   pack square: out[0] = g,  out[1] = g * g    (g f32; out (2, n) f32)
//   vmap:        mean = (sum_j g_j) * inv_k,  sq_mean = (sum_j g_j^2) * inv_k
//                over the k slices of a (k, n) f32 stack, j = 0..k-1 in
//                order (the reference's k-minor grid)
// The first three work in place on the carry (the reference returns new
// buffers with the same values), so a step keeps two f32 buffers for the
// moments (one on a stale step).  The pack writes a new (2, n) payload from
// one read of g: the buffer one all-reduce sums across the ranks.
//
// Design.  Pure streaming passes: each thread handles 16-byte vectors (four
// f32 or four bf16 of g) in a grid-stride loop; no shared memory, no
// reductions.  The zero-padded tail of every leaf stays zero.  The TPU's
// vmap kernel keeps each output block in VMEM while a minor grid axis walks
// the k slices; here a thread walks them itself, with both sums in
// registers, and writes mean and sq_mean once.
//
// Bound on the card: bytes.  At bert-large's flat layout (2.85 M rows,
// 1.46 GB per f32 buffer) the accumulate reads three buffers and writes two
// (~7.3 GB, ~2.2 ms at 3.35 TB/s); the finalize reads two and writes two
// (~5.8 GB, ~1.7 ms); the g-only accumulate reads two and writes one
// (~4.4 GB, ~1.3 ms); the pack reads one and writes two (~4.4 GB, ~1.3
// ms); the vmap moments at k = 8 read eight and write two (14.6 GB, 4.35
// ms).  The arithmetic is 3, 2, 1, 1 and 3k flops per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float4 load_g(const float* p, int64_t i) {
  return reinterpret_cast<const float4*>(p)[i];
}

__device__ __forceinline__ float4 load_g(const __nv_bfloat16* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename G>
__global__ void __launch_bounds__(NT) accum_kernel(float4* __restrict__ gs, float4* __restrict__ g2s,
                                                   const G* __restrict__ g, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 x = load_g(g, i);
    float4 a = gs[i], b = g2s[i];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    b.x = fmaf(x.x, x.x, b.x);
    b.y = fmaf(x.y, x.y, b.y);
    b.z = fmaf(x.z, x.z, b.z);
    b.w = fmaf(x.w, x.w, b.w);
    gs[i] = a;
    g2s[i] = b;
  }
}

template <typename G>
__global__ void __launch_bounds__(NT) g_accum_kernel(float4* __restrict__ gs,
                                                     const G* __restrict__ g, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 x = load_g(g, i);
    float4 a = gs[i];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    gs[i] = a;
  }
}

__global__ void __launch_bounds__(NT) finalize_kernel(float4* __restrict__ gs, float4* __restrict__ g2s,
                                                      float inv, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    float4 a = gs[i], b = g2s[i];
    a.x *= inv; a.y *= inv; a.z *= inv; a.w *= inv;
    b.x *= inv; b.y *= inv; b.z *= inv; b.w *= inv;
    gs[i] = a;
    g2s[i] = b;
  }
}

__global__ void __launch_bounds__(NT) pack_square_kernel(const float4* __restrict__ g,
                                                         float4* __restrict__ out, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    const float4 x = g[i];
    out[i] = x;
    out[n4 + i] = make_float4(x.x * x.x, x.y * x.y, x.z * x.z, x.w * x.w);
  }
}

// g: (k, n4) float4 slices; mean, sq: n4 float4.
__global__ void __launch_bounds__(NT) vmap_moments_kernel(const float4* __restrict__ g,
                                                          float4* __restrict__ mean,
                                                          float4* __restrict__ sq, int k,
                                                          float inv, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x; i < n4; i += (int64_t)gridDim.x * NT) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const float4 x = g[j * n4 + i];
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x = fmaf(x.x, x.x, b.x);
      b.y = fmaf(x.y, x.y, b.y);
      b.z = fmaf(x.z, x.z, b.z);
      b.w = fmaf(x.w, x.w, b.w);
    }
    mean[i] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    sq[i] = make_float4(b.x * inv, b.y * inv, b.z * inv, b.w * inv);
  }
}

unsigned grid_for(int64_t n4, int n_sm) {
  const int64_t want = (n4 + NT - 1) / NT;
  const int64_t cap = (int64_t)n_sm * 16;  // enough resident blocks to keep every SM streaming
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// gs, g2s: n f32 (n a multiple of 4), updated in place; g: n elements, f32
// (g_is_bf16=0) or bf16.
extern "C" int flat_moments_accum(void* gs, void* g2s, const void* g, long long n, int g_is_bf16,
                                  int n_sm, void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    accum_kernel<__nv_bfloat16><<<grid_for(n4, n_sm), NT, 0, s>>>(
        static_cast<float4*>(gs), static_cast<float4*>(g2s),
        static_cast<const __nv_bfloat16*>(g), n4);
  else
    accum_kernel<float><<<grid_for(n4, n_sm), NT, 0, s>>>(
        static_cast<float4*>(gs), static_cast<float4*>(g2s), static_cast<const float*>(g), n4);
  return cudaGetLastError();
}

// gs: n f32 (n a multiple of 4), updated in place; g: n elements, f32
// (g_is_bf16=0) or bf16.
extern "C" int flat_g_accum(void* gs, const void* g, long long n, int g_is_bf16, int n_sm,
                            void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_is_bf16)
    g_accum_kernel<__nv_bfloat16><<<grid_for(n4, n_sm), NT, 0, s>>>(
        static_cast<float4*>(gs), static_cast<const __nv_bfloat16*>(g), n4);
  else
    g_accum_kernel<float><<<grid_for(n4, n_sm), NT, 0, s>>>(static_cast<float4*>(gs),
                                                            static_cast<const float*>(g), n4);
  return cudaGetLastError();
}

// gs, g2s: n f32, scaled by inv in place.
extern "C" int flat_moments_finalize(void* gs, void* g2s, float inv, long long n, int n_sm,
                                     void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  finalize_kernel<<<grid_for(n4, n_sm), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(gs), static_cast<float4*>(g2s), inv, n4);
  return cudaGetLastError();
}

// g: n f32 (n a multiple of 4); out: 2n f32, g then g * g.
extern "C" int flat_pack_square(const void* g, void* out, long long n, int n_sm, void* stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  pack_square_kernel<<<grid_for(n4, n_sm), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(g), static_cast<float4*>(out), n4);
  return cudaGetLastError();
}

// g: k slices of n f32 each (n a multiple of 4); mean, sq: n f32.
extern "C" int flat_vmap_moments(const void* g, void* mean, void* sq, int k, float inv,
                                 long long n, int n_sm, void* stream) {
  if (n % 4 || k < 1) return cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  vmap_moments_kernel<<<grid_for(n4, n_sm), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(g), static_cast<float4*>(mean), static_cast<float4*>(sq), k, inv,
      n4);
  return cudaGetLastError();
}

// Flash-attention forward for Hopper (sm_90a), position- and segment-aware,
// GQA, optional LSE.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel (launched
// by _fwd_call, reached from flash_attention and kernels/ops.py).  Same math:
// q scaled by D^-0.5 in f32, s = q k^T in f32, mask
//   q_pos >= 0 & k_pos >= 0 & q_seg == k_seg [& k_pos <= q_pos]
//   [& k_pos > q_pos - window],
// online softmax with running (m, l, acc) in f32, a query row with no valid
// key writes exactly 0 and lse = -1e30, output in q's dtype.
//
// Design.  One block of 128 threads per (q tile of 64 rows, head, batch row).
// The block walks its key tiles of 64 itself (the TPU's sequential kv grid
// axis becomes this loop) and skips a tile whose pos/seg bounds cannot meet
// the q tile's (tile_reachable's rule), so causal and packed layouts do not
// pay for dead tiles.  q (pre-scaled), K, then V of the tile are staged in
// shared memory as f32; rows past the sequence are zero-filled and their
// pos/seg set to -1 / -1 (q) and -1 / -2 (k), and never read from memory.
// Thread (tr, tc) owns query rows 4tr..4tr+3 and keys tc + 8j, so a row's
// softmax reduction is an 8-lane shuffle; the P tile goes through shared
// memory into the PV product, where the thread owns columns tc*4 + 32c.
//
// Bound on the card.  At the serving prefill shape (B=8, S=512, H=16,
// KV=8, D=128, bf16, causal) the function moves ~50 MB (about 15 us at
// 3.35 TB/s) and does ~8.6 GFLOP (about 9 us on the bf16 tensor cores), so
// it is memory-bound in principle.  This first version computes with f32
// FMAs on the CUDA cores (no tensor cores), so it is compute-bound on them;
// wgmma and TMA-fed pipelines come later.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;
constexpr int BKP = BK + 4;  // padded P row stride (floats)

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 4) + BK * (D + 4) + BQ * BKP) * 4;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int nrows_valid,
                                          size_t row_stride, float mul) {
  constexpr int DP = D + 4;
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < 64 * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows_valid) {
      x = load4(src + (size_t)(row0 + r) * row_stride + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * DP + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg,
    T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int H, int KV, int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int CW = D / 32;  // float4 column groups per thread in PV
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * DP;
  float* Ps = KVs + BK * DP;
  __shared__ int qp_s[BQ], qs_s[BQ], kp_s[BK], ks_s[BK];
  __shared__ Bounds qb_s;
  __shared__ int live_s;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = iq * BQ;
  const int q_valid = min(BQ, Sq - q0);

  if (tid < BQ) {
    const bool in = tid < q_valid;
    qp_s[tid] = in ? q_pos[(size_t)b * Sq + q0 + tid] : -1;
    qs_s[tid] = in ? q_seg[(size_t)b * Sq + q0 + tid] : -1;
  }
  load_tile<T, D>(Qs, q + (((size_t)b * Sq + q0) * H + h) * D, 0, q_valid, (size_t)H * D, scale);
  __syncthreads();
  if (tid < 32) {
    const Bounds qb = warp_bounds(qp_s, qs_s, BQ);
    if (tid == 0) qb_s = qb;
  }

  float acc[4][4 * CW];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CW; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Skv + BK - 1) / BK;
  const T* kbase = k + ((size_t)b * Skv * KV + kvh) * D;
  const T* vbase = v + ((size_t)b * Skv * KV + kvh) * D;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    const int k_valid = min(BK, Skv - k0);
    __syncthreads();  // previous tile's readers of KVs / Ps / kp_s are done
    if (tid < BK) {
      const bool in = tid < k_valid;
      kp_s[tid] = in ? k_pos[(size_t)b * Skv + k0 + tid] : -1;
      ks_s[tid] = in ? k_seg[(size_t)b * Skv + k0 + tid] : -2;
    }
    __syncthreads();
    if (tid < 32) {
      const Bounds kb = warp_bounds(kp_s, ks_s, BK);
      if (tid == 0) live_s = reachable(qb_s, kb, causal, window);
    }
    __syncthreads();
    if (!live_s) continue;

    load_tile<T, D>(KVs, kbase + (size_t)k0 * KV * D, 0, k_valid, (size_t)KV * D, 1.f);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (tr * 4 + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kb = *reinterpret_cast<const float4*>(KVs + (tc + 8 * j) * DP + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = dot4(qa[i], kb, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = qp_s[r], qs = qs_s[r];
      bool ok[8];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        ok[j] = pair_ok(qp, kp_s[c], qs, ks_s[c], causal, window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<8>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // exact zeros off the mask: a fully masked row has s == m == NEG_INF
        // where exp(s - m) would be 1
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * BKP + tc + 8 * j] = p;
        psum += p;
      }
      psum = group_sum<8>(psum);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * CW; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P written, K no longer read
    load_tile<T, D>(KVs, vbase + (size_t)k0 * KV * D, 0, k_valid, (size_t)KV * D, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(tr * 4 + i) * BKP + j];
#pragma unroll
      for (int cw = 0; cw < CW; ++cw) {
        const float4 vv = *reinterpret_cast<const float4*>(KVs + j * DP + tc * 4 + 32 * cw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][cw * 4 + 0] = fmaf(p[i], vv.x, acc[i][cw * 4 + 0]);
          acc[i][cw * 4 + 1] = fmaf(p[i], vv.y, acc[i][cw * 4 + 1]);
          acc[i][cw * 4 + 2] = fmaf(p[i], vv.z, acc[i][cw * 4 + 2]);
          acc[i][cw * 4 + 3] = fmaf(p[i], vv.w, acc[i][cw * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= q_valid) continue;
    const bool valid = l_i[i] > 0.f;
    const float inv = valid ? 1.f / l_i[i] : 0.f;
    T* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int cw = 0; cw < CW; ++cw)
#pragma unroll
      for (int e = 0; e < 4; ++e) store1(orow + tc * 4 + 32 * cw + e, valid ? acc[i][cw * 4 + e] * inv : 0.f);
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] = valid ? m_i[i] + logf(l_i[i]) : NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* qp, const void* kp,
                   const void* qs, const void* ks, void* out, void* lse, int B, int Sq, int Skv,
                   int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // once per instantiation (also keeps the call out of CUDA graph capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qp), static_cast<const int*>(kp), static_cast<const int*>(qs),
      static_cast<const int*>(ks), static_cast<T*>(out), static_cast<float*>(lse), Sq, Skv, H,
      KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in bf16 (is_bf16=1) or f32;
// positions/segments (B,S) int32; out like q; lse (B,H,Sq) f32 or null.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos, const void* q_seg,
                                   const void* k_seg, void* out, void* lse, int B, int Sq,
                                   int Skv, int H, int KV, int D, int is_bf16, int causal,
                                   int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv,
                                        H, KV, causal, window, scale, s);
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv,
                                       H, KV, causal, window, scale, s);
  } else {
    if (D == 128)
      return launch<float, 128>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                                causal, window, scale, s);
    if (D == 64)
      return launch<float, 64>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                               causal, window, scale, s);
  }
  return cudaErrorInvalidValue;
}

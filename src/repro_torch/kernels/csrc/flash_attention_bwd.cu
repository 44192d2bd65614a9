// Flash-attention backward for Hopper (sm_90a), position- and segment-aware,
// GQA: (dq, dk, dv) from (q, k, v, lse, delta, dO) in one launch.
//
// Replaces the TPU kernel repro/kernels/flash_attention_bwd.py::
// _fused_bwd_kernel (launched by flash_attention_bwd from the custom VJP of
// repro/kernels/flash_attention.py).  Same math (FlashAttention-2, Alg. 2):
//   p    = mask ? exp(scale * q.k - lse) : 0   (mask applied BEFORE the exp:
//          a fully masked query row carries lse = -1e30)
//   dv_j = sum_i p_ij dO_i
//   dS   = p * (dO.v - delta) * scale,  delta_i = <dO_i, O_i> (computed outside)
//   dq_i = sum_j dS_ij k_j,   dk_j = sum_i dS_ij q_i
// with the mask rule of the forward (attention_common.cuh::pair_ok), so the
// recomputed p is the forward's softmax.  Query rows with pos < 0 or past the
// sequence are masked and add nothing to dk/dv; a fully masked row gets dq 0.
//
// Design.  One block of 256 threads per (key tile of 64, kv head, batch row).
// The key tile's K and V are staged once in shared memory as f32 and stay
// resident; the block walks every (query tile of 64, group member) pair (the
// TPU grid's inner axis), skipping query tiles whose pos/seg bounds cannot
// meet the key tile's (tile_reachable's rule).  Per pair it stages Q, dO,
// lse and delta, computes S and dP (thread (tr, tc) owns rows 4tr..4tr+3 and
// keys tc + 16j), writes P and dS to shared memory, then accumulates dK and
// dV for its 4 key rows x D/16 columns in registers (the GQA group sum falls
// out of the loop) and adds its part of dQ into an f32 (B, Sq, H, D) buffer
// with atomicAdd (FlashAttention-2/3 practice: each dq row receives one add
// per live key tile).  The entry zeroes that buffer first (cudaMemsetAsync);
// the wrapper casts it to q's dtype.  dK and dV are written once, in k's
// dtype.
//
// Bound on the card.  At bert-large's training shape (B=32, S=128, H=KV=16,
// D=64, bf16) the function moves ~29 MB (about 9 us at 3.35 TB/s) and does
// 4 products of 2*S*S*D per head (about 3.4 GFLOP, 3.5 us on the bf16 tensor
// cores): memory-bound in principle.  This first version computes with f32
// FMAs on the CUDA cores (five 64x64xD products per tile pair), so it is
// bound by those; wgmma and TMA come later.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int BP = BK + 4;  // padded P / dS row stride (floats)

template <int D>
constexpr int smem_bytes() {
  return (2 * BK * (D + 4) + 2 * BQ * (D + 4) + 2 * BQ * BP) * 4;
}

// 64 rows of D elements from ``src`` (row stride ``row_stride`` elements) into
// ``dst`` as f32 with row stride D + 4; rows >= nvalid are zero-filled and
// never read from memory.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int nvalid, size_t row_stride) {
  constexpr int DP = D + 4;
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < 64 * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) x = load4(src + (size_t)r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ delta, const T* __restrict__ dout,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg,
    float* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int H, int KV, int causal, int window, float scale) {
  constexpr int DP = D + 4;
  constexpr int CW = D / 64;  // float4 column groups per thread in the (64 x D) products
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * DP;
  float* Qs = Vs + BK * DP;
  float* dOs = Qs + BQ * DP;
  float* Ps = dOs + BQ * DP;
  float* dSs = Ps + BQ * BP;
  __shared__ int qp_s[BQ], qs_s[BQ], kp_s[BK], ks_s[BK];
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ Bounds kb_s;
  __shared__ int live_s;

  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = ik * BK;
  const int k_valid = min(BK, Skv - k0);

  if (tid < BK) {
    const bool in = tid < k_valid;
    kp_s[tid] = in ? k_pos[(size_t)b * Skv + k0 + tid] : -1;
    ks_s[tid] = in ? k_seg[(size_t)b * Skv + k0 + tid] : -2;
  }
  const size_t kv_off = (((size_t)b * Skv + k0) * KV + kvh) * D;
  load_rows<T, D>(Ks, k + kv_off, k_valid, (size_t)KV * D);
  load_rows<T, D>(Vs, v + kv_off, k_valid, (size_t)KV * D);
  __syncthreads();
  if (tid < 32) {
    const Bounds kb = warp_bounds(kp_s, ks_s, BK);
    if (tid == 0) kb_s = kb;
  }

  float dk_acc[4][4 * CW], dv_acc[4][4 * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  for (int iq = 0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    const int q_valid = min(BQ, Sq - q0);
    __syncthreads();  // the previous pair's readers of qp_s / Qs / dOs / Ps / dSs are done
    if (tid < BQ) {
      const bool in = tid < q_valid;
      qp_s[tid] = in ? q_pos[(size_t)b * Sq + q0 + tid] : -1;
      qs_s[tid] = in ? q_seg[(size_t)b * Sq + q0 + tid] : -1;
    }
    __syncthreads();
    if (tid < 32) {
      const Bounds qb = warp_bounds(qp_s, qs_s, BQ);
      if (tid == 0) live_s = reachable(qb, kb_s, causal, window);
    }
    __syncthreads();
    if (!live_s) continue;

    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      if (gi > 0) __syncthreads();  // the previous member's readers are done
      const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
      load_rows<T, D>(Qs, q + q_off, q_valid, (size_t)H * D);
      load_rows<T, D>(dOs, dout + q_off, q_valid, (size_t)H * D);
      if (tid < BQ) {
        const bool in = tid < q_valid;
        const size_t row = ((size_t)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = in ? lse[row] : 0.f;
        delta_s[tid] = in ? delta[row] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T for rows 4tr..4tr+3, keys tc + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = *reinterpret_cast<const float4*>(Qs + (tr * 4 + i) * DP + d);
          da[i] = *reinterpret_cast<const float4*>(dOs + (tr * 4 + i) * DP + d);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kb = *reinterpret_cast<const float4*>(Ks + (tc + 16 * j) * DP + d);
          const float4 vb = *reinterpret_cast<const float4*>(Vs + (tc + 16 * j) * DP + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = dot4(qa[i], kb, s[i][j]);
            dp[i][j] = dot4(da[i], vb, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const int qp = qp_s[r], qs = qs_s[r];
        const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 16 * j;
          const bool ok = pair_ok(qp, kp_s[c], qs, ks_s[c], causal, window);
          const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
          Ps[r * BP + c] = p;
          dSs[r * BP + c] = p * (dp[i][j] - dl) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for key rows 4tr..4tr+3, columns
      // tc*4 + 64cw .. +3
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + qq * BP + tr * 4);
        const float4 sv = *reinterpret_cast<const float4*>(dSs + qq * BP + tr * 4);
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) {
          const float4 o = *reinterpret_cast<const float4*>(dOs + qq * DP + tc * 4 + 64 * cw);
          const float4 x = *reinterpret_cast<const float4*>(Qs + qq * DP + tc * 4 + 64 * cw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][cw * 4 + 0] = fmaf(pr[i], o.x, dv_acc[i][cw * 4 + 0]);
            dv_acc[i][cw * 4 + 1] = fmaf(pr[i], o.y, dv_acc[i][cw * 4 + 1]);
            dv_acc[i][cw * 4 + 2] = fmaf(pr[i], o.z, dv_acc[i][cw * 4 + 2]);
            dv_acc[i][cw * 4 + 3] = fmaf(pr[i], o.w, dv_acc[i][cw * 4 + 3]);
            dk_acc[i][cw * 4 + 0] = fmaf(sr[i], x.x, dk_acc[i][cw * 4 + 0]);
            dk_acc[i][cw * 4 + 1] = fmaf(sr[i], x.y, dk_acc[i][cw * 4 + 1]);
            dk_acc[i][cw * 4 + 2] = fmaf(sr[i], x.z, dk_acc[i][cw * 4 + 2]);
            dk_acc[i][cw * 4 + 3] = fmaf(sr[i], x.w, dk_acc[i][cw * 4 + 3]);
          }
        }
      }

      // dQ (this key tile's part) = dS K for query rows 4tr..4tr+3
      float dq_acc[4][4 * CW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4 * CW; ++c) dq_acc[i][c] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < BK; ++kk) {
        float sr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sr[i] = dSs[(tr * 4 + i) * BP + kk];
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) {
          const float4 x = *reinterpret_cast<const float4*>(Ks + kk * DP + tc * 4 + 64 * cw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dq_acc[i][cw * 4 + 0] = fmaf(sr[i], x.x, dq_acc[i][cw * 4 + 0]);
            dq_acc[i][cw * 4 + 1] = fmaf(sr[i], x.y, dq_acc[i][cw * 4 + 1]);
            dq_acc[i][cw * 4 + 2] = fmaf(sr[i], x.z, dq_acc[i][cw * 4 + 2]);
            dq_acc[i][cw * 4 + 3] = fmaf(sr[i], x.w, dq_acc[i][cw * 4 + 3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        if (r >= q_valid) continue;
        float* row = dq + (((size_t)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
        for (int cw = 0; cw < CW; ++cw)
#pragma unroll
          for (int e = 0; e < 4; ++e) atomicAdd(row + tc * 4 + 64 * cw + e, dq_acc[i][cw * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    if (r >= k_valid) continue;
    const size_t off = (((size_t)b * Skv + k0 + r) * KV + kvh) * D;
#pragma unroll
    for (int cw = 0; cw < CW; ++cw)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        store1(dk + off + tc * 4 + 64 * cw + e, dk_acc[i][cw * 4 + e]);
        store1(dv + off + tc * 4 + 64 * cw + e, dv_acc[i][cw * 4 + e]);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lse,
                   const void* delta, const void* dout, const void* qp, const void* kp,
                   const void* qs, const void* ks, void* dq, void* dk, void* dv, int B, int Sq,
                   int Skv, int H, int KV, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  // once per instantiation (also keeps the call out of CUDA graph capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaError_t err = cudaMemsetAsync(dq, 0, (size_t)B * Sq * H * D * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + BK - 1) / BK, KV, B);
  flash_bwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const T*>(dout), static_cast<const int*>(qp), static_cast<const int*>(kp),
      static_cast<const int*>(qs), static_cast<const int*>(ks), static_cast<float*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q/dout (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in bf16 (is_bf16=1) or f32;
// lse/delta (B,H,Sq) f32; positions/segments (B,S) int32; dq (B,Sq,H,D) f32
// (zeroed here), dk/dv like k.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* lse,
                                   const void* delta, const void* dout, const void* q_pos,
                                   const void* k_pos, const void* q_seg, const void* k_seg,
                                   void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
                                   int KV, int D, int is_bf16, int causal, int window,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg,
                                        dq, dk, dv, B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg,
                                       dq, dk, dv, B, Sq, Skv, H, KV, causal, window, scale, s);
  } else {
    if (D == 128)
      return launch<float, 128>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk,
                                dv, B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 64)
      return launch<float, 64>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk,
                               dv, B, Sq, Skv, H, KV, causal, window, scale, s);
  }
  return cudaErrorInvalidValue;
}

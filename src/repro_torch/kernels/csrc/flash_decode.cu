// Split-KV decode attention over the paged cache, for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_decode.py::flash_decode, which on the TPU
// runs the flash-attention kernel (flash_attention.py::_fwd_call -> _kernel)
// with Sq = L decode lanes against Skv = C cache slots.  Same math and mask
// as flash_attention.cu: explicit per-lane (q_pos, q_seg) and per-slot
// (k_pos, k_seg); slot order is arbitrary because the mask reads only those
// values; an idle lane (q_pos < 0) or a lane with no reachable slot writes
// exactly 0.
//
// Design.  Decode has few queries and a long cache, so one block per
// (batch row, kv head, row group) would leave most of the 132 SMs idle.
// The cache is cut into `splits` chunks, and
//   (b) flash_decode_split: one block of 128 threads per (chunk, kv head x
//       row group, batch row) computes the G*L queries of that kv head
//       (up to 16 per row group) against the chunk's slots, 64 slots a
//       tile, and writes a partial (m, l, acc) in f32;
//   (c) flash_decode_combine: one block per (batch row, head, lane) merges
//       the partials: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
//       exactly 0 where every split has l = 0.
// A tile whose slots cannot meet the queries (empty slots, other segments,
// outside the window) is skipped from its pos/seg bounds.  Warp w owns
// query rows 4w..4w+3, lane t owns slots t and t+32 of the tile, so a row's
// softmax reduction is a warp shuffle.
//
// Bound on the card.  At the serving decode shape (B=8, L=1, C=552, KV=8,
// D=128, bf16) the split reads ~18 MB of K/V: ~5.4 us at 3.35 TB/s; the
// work (~0.04 GFLOP) is far below the compute roof.  It is memory-bound, so
// the split count is chosen to put at least two blocks on every SM and
// each K/V byte is read once per row group.
#include "attention_common.cuh"

using namespace repro_attn;

namespace {

constexpr int RB = 16;  // query rows per block (G*L rows of one kv head)
constexpr int BT = 64;  // cache slots per tile
constexpr int NT = 128;
constexpr int BTP = BT + 4;

template <int D>
constexpr int split_smem_bytes() {
  return (RB * (D + 4) + BT * (D + 4) + RB * BTP) * 4;
}

template <typename T, int D>
__device__ __forceinline__ void load_slots(float* dst, const T* src, int nvalid, size_t stride) {
  constexpr int DP = D + 4;
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < BT * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) x = load4(src + (size_t)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * DP + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ acc_out,
    int L, int C, int H, int KV, int causal, int window, float scale, int chunk, int NS) {
  constexpr int DP = D + 4;
  constexpr int CW = D / 32;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + RB * DP;
  float* Ps = KVs + BT * DP;
  __shared__ int qp_s[RB], qs_s[RB], kp_s[BT], ks_s[BT];
  __shared__ Bounds qb_s;
  __shared__ int live_s;

  const int G = H / KV;
  const int R = G * L;
  const int n_rg = (R + RB - 1) / RB;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_rg, rg = blockIdx.y % n_rg;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  // query row r of this kv head: group member g = r / L, lane l = r % L
  if (tid < RB) {
    const int r = rg * RB + tid;
    int qp = -1, qs = -1;
    if (r < R) {
      const int l = r % L;
      qp = q_pos[(size_t)b * L + l];
      qs = q_seg[(size_t)b * L + l];
    }
    qp_s[tid] = qp;
    qs_s[tid] = qs;
  }
  for (int e = tid; e < RB * (D / 4); e += NT) {
    const int i = e / (D / 4), c = (e % (D / 4)) * 4;
    const int r = rg * RB + i;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      const int g = r / L, l = r % L;
      x = load4(q + (((size_t)b * L + l) * H + kvh * G + g) * D + c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + i * DP + c) = x;
  }
  __syncthreads();
  if (tid < 32) {
    const Bounds qb = warp_bounds(qp_s, qs_s, RB);
    if (tid == 0) qb_s = qb;
  }

  float acc[4][CW];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  const int c_begin = split * chunk;
  const int c_end = min(C, c_begin + chunk);
  const T* kbase = k + ((size_t)b * C * KV + kvh) * D;
  const T* vbase = v + ((size_t)b * C * KV + kvh) * D;
  for (int t0 = c_begin; t0 < c_end; t0 += BT) {
    const int nvalid = min(BT, c_end - t0);
    __syncthreads();
    if (tid < BT) {
      const bool in = tid < nvalid;
      kp_s[tid] = in ? k_pos[(size_t)b * C + t0 + tid] : -1;
      ks_s[tid] = in ? k_seg[(size_t)b * C + t0 + tid] : -2;
    }
    __syncthreads();
    if (tid < 32) {
      const Bounds kb = warp_bounds(kp_s, ks_s, BT);
      if (tid == 0) live_s = reachable(qb_s, kb, causal, window);
    }
    __syncthreads();
    if (!live_s) continue;

    load_slots<T, D>(KVs, kbase + (size_t)t0 * KV * D, nvalid, (size_t)KV * D);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(KVs + lane * DP + d);
      const float4 k1 = *reinterpret_cast<const float4*>(KVs + (lane + 32) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + (w * 4 + i) * DP + d);
        s[i][0] = dot4(qa, k0, s[i][0]);
        s[i][1] = dot4(qa, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = w * 4 + i;
      const int qp = qp_s[r], qs = qs_s[r];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        ok[j] = pair_ok(qp, kp_s[c], qs, ks_s[c], causal, window);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<32>(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * BTP + lane + 32 * j] = p;
        psum += p;
      }
      psum = group_sum<32>(psum);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    load_slots<T, D>(KVs, vbase + (size_t)t0 * KV * D, nvalid, (size_t)KV * D);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float vv[CW];
      if constexpr (CW == 4) {
        const float4 x = *reinterpret_cast<const float4*>(KVs + j * DP + lane * 4);
        vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(KVs + j * DP + lane * 2);
        vv[0] = x.x; vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(w * 4 + i) * BTP + j];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  // partials, laid out (B, H, L, NS) and (B, H, L, NS, D)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * RB + w * 4 + i;
    if (r >= R) continue;
    const int g = r / L, l = r % L;
    const size_t idx = (((size_t)b * H + kvh * G + g) * L + l) * NS + split;
    if (lane == 0) {
      m_out[idx] = m_i[i];
      l_out[idx] = l_i[i];
    }
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_out[idx * D + lane * CW + c] = acc[i][c];
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ m, const float* __restrict__ l,
                                      const float* __restrict__ acc, T* __restrict__ out, int L,
                                      int H, int NS, int D) {
  // blockIdx.x = (b * H + h) * L + lane_l, the partials' row
  const int row = blockIdx.x;
  const int l_idx = row % L;
  const int h = (row / L) % H;
  const int b = row / (L * H);
  const float* mr = m + (size_t)row * NS;
  const float* lr = l + (size_t)row * NS;
  float mmax = NEG_INF;
  for (int s = 0; s < NS; ++s) mmax = fmaxf(mmax, mr[s]);
  float lsum = 0.f;
  for (int s = 0; s < NS; ++s) lsum += expf(mr[s] - mmax) * lr[s];
  T* orow = out + (((size_t)b * L + l_idx) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < NS; ++s) o += expf(mr[s] - mmax) * acc[((size_t)row * NS + s) * D + d];
    store1(orow + d, lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* qp,
                         const void* kp, const void* qs, const void* ks, void* m, void* l,
                         void* acc, int B, int L, int C, int H, int KV, int causal, int window,
                         float scale, int chunk, int NS, cudaStream_t stream) {
  constexpr int smem = split_smem_bytes<D>();
  // once per instantiation (also keeps the call out of CUDA graph capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<T, D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_rg = ((H / KV) * L + RB - 1) / RB;
  const dim3 grid(NS, KV * n_rg, B);
  decode_split_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(qp), static_cast<const int*>(kp), static_cast<const int*>(qs),
      static_cast<const int*>(ks), static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), L, C, H, KV, causal, window, scale, chunk, NS);
  return cudaGetLastError();
}

}  // namespace

// q (B,L,H,D) lanes, k/v (B,C,KV,D) cache, bf16 (is_bf16=1) or f32;
// positions/segments int32 (B,L) and (B,C).  Writes m, l (B,H,L,NS) and acc
// (B,H,L,NS,D) in f32 for NS = ceil(C / chunk) splits; chunk is a multiple
// of 64.
extern "C" int flash_decode_split(const void* q, const void* k, const void* v,
                                  const void* q_pos, const void* k_pos, const void* q_seg,
                                  const void* k_seg, void* m, void* l, void* acc, int B, int L,
                                  int C, int H, int KV, int D, int is_bf16, int causal,
                                  int window, float scale, int chunk, int NS, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || chunk <= 0 || chunk % BT != 0 ||
      NS != (C + chunk - 1) / chunk)
    return cudaErrorInvalidValue;
  if (is_bf16) {
    if (D == 128)
      return launch_split<__nv_bfloat16, 128>(q, k, v, q_pos, k_pos, q_seg, k_seg, m, l, acc, B,
                                              L, C, H, KV, causal, window, scale, chunk, NS, s);
    if (D == 64)
      return launch_split<__nv_bfloat16, 64>(q, k, v, q_pos, k_pos, q_seg, k_seg, m, l, acc, B,
                                             L, C, H, KV, causal, window, scale, chunk, NS, s);
  } else {
    if (D == 128)
      return launch_split<float, 128>(q, k, v, q_pos, k_pos, q_seg, k_seg, m, l, acc, B, L, C,
                                      H, KV, causal, window, scale, chunk, NS, s);
    if (D == 64)
      return launch_split<float, 64>(q, k, v, q_pos, k_pos, q_seg, k_seg, m, l, acc, B, L, C, H,
                                     KV, causal, window, scale, chunk, NS, s);
  }
  return cudaErrorInvalidValue;
}

// Merges the partials of flash_decode_split into out (B,L,H,D) in bf16
// (is_bf16=1) or f32.
extern "C" int flash_decode_combine(const void* m, const void* l, const void* acc, void* out,
                                    int B, int L, int H, int D, int NS, int is_bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || NS <= 0) return cudaErrorInvalidValue;
  const int threads = D < 128 ? D : 128;
  if (is_bf16)
    decode_combine_kernel<__nv_bfloat16><<<B * H * L, threads, 0, s>>>(
        static_cast<const float*>(m), static_cast<const float*>(l),
        static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(out), L, H, NS, D);
  else
    decode_combine_kernel<float><<<B * H * L, threads, 0, s>>>(
        static_cast<const float*>(m), static_cast<const float*>(l),
        static_cast<const float*>(acc), static_cast<float*>(out), L, H, NS, D);
  return cudaGetLastError();
}

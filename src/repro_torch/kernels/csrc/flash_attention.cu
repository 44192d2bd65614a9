// Flash-attention forward for Hopper (sm_90a), position- and segment-aware,
// GQA, optional LSE.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_kernel (launched
// by _fwd_call, reached from flash_attention and kernels/ops.py).  Same math:
// s = q k^T in f32 scaled by D^-0.5 in f32, mask
//   q_pos >= 0 & k_pos >= 0 & q_seg == k_seg [& k_pos <= q_pos]
//   [& k_pos > q_pos - window],
// online softmax with running (m, l, acc) in f32, a query row with no valid
// key writes exactly 0 and lse = -1e30, output in q's dtype.
//
// Bound on the card.  At the serving prefill shape (B=8, S=512, H=16,
// KV=8, D=128, bf16, causal) the function moves ~50 MB (about 15 us at
// 3.35 TB/s) and does ~8.6 GFLOP (about 9 us on the bf16 tensor cores): it
// is memory-bound in principle, and bound by how fast the products issue
// in practice.
//
// bf16 (every main path): tensor cores.  One warpgroup (128 threads) per
// (q tile of 64 rows, head, batch row); the Q tile arrives once by TMA, in
// bf16.  Warp 0 owns the key schedule: it decides from the pos/seg bounds
// of each key tile whether any pair can be unmasked (tile_reachable's
// rule) BEFORE issuing that tile's loads, so dead tiles of causal and
// packed rows cost a scan of their positions only, and whether every pair
// is unmasked (the mask is then skipped).  Live K and V tiles arrive by TMA
// (tensor maps over (D, heads, S, B): rows past the sequence read as 0,
// 128-byte swizzle) through a 2-stage ring of mbarriers, the next tile's
// loads in flight while this one is computed.  S = Q K^T is wgmma
// m64n64k16 from shared memory (bf16 in, f32 accumulate); the scale, mask
// and online softmax (exp2 in the log2 domain) run on the accumulator
// fragment, a row's max and sum over the 4 lanes that hold it; P is rounded
// to bf16 in registers and is the A operand of O += P V (m64n{D}k16, V the
// MN-major B operand).  Each product is awaited before its results are read
// (no overlap of softmax and products inside the block; two blocks per SM
// overlap each other): that, and the single consumer warpgroup, bound it.
//
// f32 (the f32 cases of the checks), and bf16 at D = 32 (the gengap
// bench's smoke model), which the wgmma tiles do not take: the first
// version, on the CUDA cores.  One block of 128 threads per (q tile, head,
// batch row) walks the live key tiles; q (pre-scaled), K, then V are staged
// in shared memory as f32 and the products are f32 FMAs.
#include "attention_common.cuh"
#include "attention_sm90.cuh"

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

// ---- bf16: the tensor-core kernel ------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdTiles {
  static constexpr int TILE = D / 64 * repro_sm90::CHUNK_BYTES;  // 64 rows of D bf16
  static constexpr int Q = 0, K = TILE, V = 3 * TILE;  // K and V: two stages each
  static constexpr int BYTES = 5 * TILE + 1024;        // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(128, 2) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, const int* __restrict__ q_seg, const int* __restrict__ k_seg,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq, int Skv, int H, int KV,
    int causal, int window, float scale_log2) {
  using namespace repro_sm90;
  using L = FwdTiles<D>;
  constexpr int NO = D / 2;  // O accumulator values per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  __shared__ __align__(8) uint64_t bar[3];  // K/V stages 0 and 1; the Q tile
  __shared__ int qp_s[64], qs_s[64], kp_s[2][64], ks_s[2][64], tile_s[2], full_s[2];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * 64;
  const int nk = (Skv + 63) / 64;
  const int* kpos = k_pos + (size_t)b * Skv;
  const int* kseg = k_seg + (size_t)b * Skv;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    mbar_fence_init();
    mbar_expect_tx(&bar[2], L::TILE);
    tma_tile<D>(smem + L::Q, &q_map, &bar[2], h, q0, b);
  }

  // Warp 0 owns the key schedule: issue(st) scans on from key tile ``next``
  // for one whose pairs can meet the q tile's, writes its pos/seg rows and
  // flags into stage st and starts its K and V loads; tile -1 ends the walk.
  int next = 0;
  TileRows qr;
  if (warp == 0) {
    qr = warp_tile_rows(q_pos + (size_t)b * Sq, q_seg + (size_t)b * Sq, q0, Sq, -1);
    qp_s[lane] = qr.p0;
    qs_s[lane] = qr.s0;
    qp_s[lane + 32] = qr.p1;
    qs_s[lane + 32] = qr.s1;
  }
  auto issue = [&](int st) {
    int t = -1, full = 0;
    while (next < nk) {
      const TileRows kr = warp_tile_rows(kpos, kseg, next * 64, Skv, -2);
      const int cur = next++;
      if (repro_attn::reachable(qr.b, kr.b, causal, window)) {
        t = cur;
        full = tile_full(qr, kr, causal, window);
        kp_s[st][lane] = kr.p0;
        ks_s[st][lane] = kr.s0;
        kp_s[st][lane + 32] = kr.p1;
        ks_s[st][lane + 32] = kr.s1;
        break;
      }
    }
    if (lane == 0) {
      tile_s[st] = t;
      full_s[st] = full;
      if (t >= 0) {
        mbar_expect_tx(&bar[st], 2 * L::TILE);
        tma_tile<D>(smem + L::K + st * L::TILE, &k_map, &bar[st], kvh, t * 64, b);
        tma_tile<D>(smem + L::V + st * L::TILE, &v_map, &bar[st], kvh, t * 64, b);
      }
    }
  };
  if (warp == 0) {
    issue(0);
    issue(1);
  }
  __syncthreads();

  // this thread's accumulator rows r0 and r0 + 8, columns c2 + 8j (+1)
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  const int qp[2] = {qp_s[r0], qp_s[r0 + 8]}, qs[2] = {qs_s[r0], qs_s[r0 + 8]};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_s = smem_u32(smem + L::Q);
  mbar_wait(&bar[2], 0);

  for (int it = 0;; ++it) {
    const int st = it & 1;
    if (tile_s[st] < 0) break;
    const bool full = full_s[st];
    const uint32_t k_s = smem_u32(smem + L::K + st * L::TILE);
    const uint32_t v_s = smem_u32(smem + L::V + st * L::TILE);
    mbar_wait(&bar[st], (it >> 1) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(s, desc_k(q_s, kk), desc_k(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    uint32_t ok = 0xffffffffu;
    if (!full) {
      ok = 0u;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1, col = 8 * (i >> 2) + c2 + (i & 1);
        if (pair_ok(qp[hh], kp_s[st][col], qs[hh], ks_s[st][col], causal, window)) ok |= 1u << i;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ((ok >> i) & 1u) ? s[i] * scale_log2 : NEG_INF;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = group_max<4>(mx[hh]);
      const float m_new = fmaxf(m[hh], mx[hh]);
      corr[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // exact zeros off the mask: a fully masked row has s == m == NEG_INF
      const float p = ((ok >> i) & 1u) ? exp2f(s[i] - m[(i >> 1) & 1]) : 0.f;
      s[i] = p;
      sum[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * corr[hh] + group_sum<4>(sum[hh]);
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= corr[(i >> 1) & 1];

    uint32_t pa[4][4];
    to_a_frags<32>(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D == 128)
        wgmma_rs_n128<1>(o, pa[kk], desc_mn(v_s, kk), 1);
      else
        wgmma_rs_n64<1>(o, pa[kk], desc_mn(v_s, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();  // every warp is done with stage st (and with tile_s[st])
    if (warp == 0) issue(st);
  }

  const int q_valid = min(64, Sq - q0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= q_valid) continue;
    const bool valid = l[hh] > 0.f;
    const float inv = valid ? 1.f / l[hh] : 0.f;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c2) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] = valid ? (m[hh] + log2f(l[hh])) * LN2 : NEG_INF;
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* qp,
                         const void* kp, const void* qs, const void* ks, void* out, void* lse,
                         int B, int Sq, int Skv, int H, int KV, int causal, int window,
                         float scale, cudaStream_t stream) {
  using L = FwdTiles<D>;
  // once per instantiation (also keeps the call out of CUDA graph capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 L::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = repro_sm90_host::tile_map(&q_map, q, B, Sq, H, D);
  if (err == cudaSuccess) err = repro_sm90_host::tile_map(&k_map, k, B, Skv, KV, D);
  if (err == cudaSuccess) err = repro_sm90_host::tile_map(&v_map, v, B, Skv, KV, D);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + 63) / 64, H, B);
  flash_fwd_wgmma_kernel<D><<<grid, 128, L::BYTES, stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(qp), static_cast<const int*>(kp),
      static_cast<const int*>(qs), static_cast<const int*>(ks),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Skv, H, KV, causal,
      window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in bf16 (is_bf16=1: the
// tensor-core kernel at D = 64, 128, 16-byte aligned; the CUDA-core kernel
// at D = 32 and 256) or f32 (the CUDA-core kernel); D one of 32, 64, 128,
// 256 (recurrentgemma's heads; 150 KB of shared memory a block);
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
      return launch_wgmma<128>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                               causal, window, scale, s);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                              causal, window, scale, s);
    if (D == 32)  // too narrow for the wgmma tiles: the CUDA-core kernel
      return launch<__nv_bfloat16, 32>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv,
                                       H, KV, causal, window, scale, s);
    if (D == 256)  // wider than the wgmma tiles' shared memory: the CUDA-core kernel
      return launch<__nv_bfloat16, 256>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq,
                                        Skv, H, KV, causal, window, scale, s);
  } else {
    if (D == 128)
      return launch<float, 128>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                                causal, window, scale, s);
    if (D == 64)
      return launch<float, 64>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                               causal, window, scale, s);
    if (D == 32)
      return launch<float, 32>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                               causal, window, scale, s);
    if (D == 256)
      return launch<float, 256>(q, k, v, q_pos, k_pos, q_seg, k_seg, out, lse, B, Sq, Skv, H, KV,
                                causal, window, scale, s);
  }
  return cudaErrorInvalidValue;
}

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
// sequence are masked and add nothing to dk/dv; a fully masked row gets dq 0,
// a key no query reaches dk = dv = 0.  dq is summed in an f32 (B, Sq, H, D)
// buffer that the entry zeroes first (cudaMemsetAsync); the wrapper casts
// it to q's dtype.  dK and dV are written once, in k's dtype.
//
// Bound on the card.  At bert-large's training shape (B=32, S=128, H=KV=16,
// D=64, bf16) the function moves ~29 MB (about 9 us at 3.35 TB/s) and does
// 5 products of 2*S*S*D per head (about 4.3 GFLOP, 4.3 us on the bf16
// tensor cores): memory-bound in principle; in practice bound by the
// serialised products of one warpgroup and by dq's f32 atomics (each dq row
// receives one add per live key tile).
//
// bf16 (every main path): tensor cores, dK/dV-stationary.  One warpgroup
// (128 threads) per (key tile of 64, kv head, batch row); the K and V tiles
// arrive once by TMA and stay resident in shared memory as bf16.  The block
// walks every (query tile of 64, group member) pair whose tile can meet the
// key tile (tile_reachable's rule, decided by warp 0 from the pos/seg
// bounds before the pair's loads are issued); Q and dO tiles, with their
// lse and delta rows, come through a 2-stage TMA/mbarrier ring.  Per pair,
// with keys as the rows (FlashAttention-3's transposed form):
//   S^T = K Q^T and dP^T = V dO^T    wgmma m64n64k16, both operands K-major
//   P^T, dS^T on the accumulator fragments (f32), rounded to bf16
//   dV += P^T dO, dK += dS^T Q       wgmma m64n{D}k16, A from registers,
//                                    dO / Q the MN-major B operand
//   dQ = dS K                        dS^T stored to shared memory (128-byte
//                                    swizzle) as the MN-major A operand, K
//                                    the MN-major B; in 64-column halves
// dK and dV accumulate in registers (f32) across the whole walk, so the GQA
// group sum falls out of the loop.  dQ's partial is added with vectorised
// f32 atomics (float2).  Register budget: at D = 128 dK and dV take 128 f32
// registers a thread and S^T, dP^T 64 more, so one consumer warpgroup per
// block (two blocks per SM by shared memory, 106 KiB each) and dQ in two
// 64-wide halves (32 registers) keep it under 255 without a producer warp.
//
// f32 (the f32 cases of the checks), and bf16 at D = 32 (the gengap
// bench's smoke model), which the wgmma tiles do not take: the first
// version, on the CUDA cores.
// One block of 256 threads per (key tile of 64, kv head, batch row): K and
// V staged once as f32, then per pair Q, dO, lse and delta; S and dP, then
// dK and dV in registers and dQ with atomicAdd, all f32 FMAs.
#include "attention_common.cuh"
#include "attention_sm90.cuh"

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
  // float4 column groups per thread in the (64 x D) products; at D = 32 the
  // 16 column threads cover 64 columns, and those past D sit out (col_ok)
  constexpr int CW = (D + 63) / 64;
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
  const auto col_ok = [&](int cw) { return D % 64 == 0 || tc * 4 + 64 * cw < D; };
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
          if (!col_ok(cw)) continue;
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
          if (!col_ok(cw)) continue;
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
          for (int e = 0; e < 4; ++e)
            if (col_ok(cw)) atomicAdd(row + tc * 4 + 64 * cw + e, dq_acc[i][cw * 4 + e]);
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
      for (int e = 0; e < 4 && col_ok(cw); ++e) {
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

// ---- bf16: the tensor-core kernel ------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct BwdTiles {
  static constexpr int TILE = D / 64 * repro_sm90::CHUNK_BYTES;  // 64 rows of D bf16
  // K, V resident; Q and dO two stages each; dS^T one 64 x 64 chunk
  static constexpr int K = 0, V = TILE, Q = 2 * TILE, DO = 4 * TILE, DS = 6 * TILE;
  static constexpr int BYTES = 6 * TILE + repro_sm90::CHUNK_BYTES + 1024;  // + alignment slack
};

// Add a 64 x 64 f32 accumulator fragment (columns col0..col0+63 of D) into
// the q tile's dq rows (``tile`` is its first row), rows from q_rows on left
// out.
__device__ __forceinline__ void add_dq(float* tile, const float (&acc)[32], int q_rows,
                                       size_t row_stride, int col0) {
  const int lane = threadIdx.x & 31, r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= q_rows) continue;
    float* row = tile + (size_t)r * row_stride + col0 + c2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      atomicAdd(reinterpret_cast<float2*>(row + 8 * j),
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
  }
}

template <int D>
__global__ void __launch_bounds__(128, 2) flash_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg, float* __restrict__ dq,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
    int KV, int causal, int window, float scale) {
  using namespace repro_sm90;
  using L = BwdTiles<D>;
  constexpr int NO = D / 2;  // dK / dV accumulator values per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  __shared__ __align__(8) uint64_t bar[3];  // Q/dO stages 0 and 1; the K/V tile
  __shared__ int qp_s[2][64], qs_s[2][64], tile_s[2], head_s[2], full_s[2];
  __shared__ float lse_s[2][64], dl_s[2][64];

  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = ik * 64;
  const int nq = (Sq + 63) / 64;
  const int* qpos = q_pos + (size_t)b * Sq;
  const int* qseg = q_seg + (size_t)b * Sq;
  const float scale_log2 = scale * LOG2E;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    mbar_fence_init();
    mbar_expect_tx(&bar[2], 2 * L::TILE);
    tma_tile<D>(smem + L::K, &k_map, &bar[2], kvh, k0, b);
    tma_tile<D>(smem + L::V, &v_map, &bar[2], kvh, k0, b);
  }

  // Warp 0 owns the pair schedule: issue(st) takes the next group member of
  // the current q tile, or scans on from q tile ``next`` for one whose rows
  // can meet the key tile's, writes the pair's q pos/seg, lse (log2 units)
  // and delta rows and flags into stage st and starts its Q and dO loads;
  // tile -1 ends the walk.
  TileRows kr, qr;
  int next = 0, member = G, cur = -1, cur_full = 0;
  if (warp == 0) kr = warp_tile_rows(k_pos + (size_t)b * Skv, k_seg + (size_t)b * Skv, k0, Skv, -2);
  auto issue = [&](int st) {
    if (member == G) {
      member = 0;
      cur = -1;
      while (next < nq) {
        qr = warp_tile_rows(qpos, qseg, next * 64, Sq, -1);
        const int t = next++;
        if (repro_attn::reachable(qr.b, kr.b, causal, window)) {
          cur = t;
          cur_full = tile_full(qr, kr, causal, window);
          break;
        }
      }
    }
    if (cur < 0) {
      if (lane == 0) tile_s[st] = -1;
      return;
    }
    const int h = kvh * G + member++;
    const int q0 = cur * 64;
    qp_s[st][lane] = qr.p0;
    qs_s[st][lane] = qr.s0;
    qp_s[st][lane + 32] = qr.p1;
    qs_s[st][lane + 32] = qr.s1;
    const float* lrow = lse + ((size_t)b * H + h) * Sq;
    const float* drow = delta + ((size_t)b * H + h) * Sq;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = q0 + lane + 32 * e;
      lse_s[st][lane + 32 * e] = r < Sq ? lrow[r] * LOG2E : 0.f;
      dl_s[st][lane + 32 * e] = r < Sq ? drow[r] : 0.f;
    }
    if (lane == 0) {
      tile_s[st] = cur;
      head_s[st] = h;
      full_s[st] = cur_full;
      mbar_expect_tx(&bar[st], 2 * L::TILE);
      tma_tile<D>(smem + L::Q + st * L::TILE, &q_map, &bar[st], h, q0, b);
      tma_tile<D>(smem + L::DO + st * L::TILE, &do_map, &bar[st], h, q0, b);
    }
  };
  if (warp == 0) {
    issue(0);
    issue(1);
  }
  __syncthreads();

  // this thread's accumulator rows (keys) r0 and r0 + 8, columns (queries)
  // c2 + 8j (+1)
  const int r0 = 16 * warp + (lane >> 2), c2 = 2 * (lane & 3);
  int kp[2], ks[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = k0 + r0 + 8 * hh;
    kp[hh] = r < Skv ? k_pos[(size_t)b * Skv + r] : -1;
    ks[hh] = r < Skv ? k_seg[(size_t)b * Skv + r] : -2;
  }
  float dk_acc[NO], dv_acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_s = smem_u32(smem + L::K), v_s = smem_u32(smem + L::V);
  const uint32_t ds_s = smem_u32(smem + L::DS);
  uint8_t* ds_ptr = smem + L::DS;
  mbar_wait(&bar[2], 0);

  for (int it = 0;; ++it) {
    const int st = it & 1;
    const int iq = tile_s[st];
    if (iq < 0) break;
    const int h = head_s[st];
    const bool full = full_s[st];
    const uint32_t q_st = smem_u32(smem + L::Q + st * L::TILE);
    const uint32_t do_st = smem_u32(smem + L::DO + st * L::TILE);
    mbar_wait(&bar[st], (it >> 1) & 1);

    float sT[32], dpT[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(sT, desc_k(k_s, kk), desc_k(q_st, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(dpT, desc_k(v_s, kk), desc_k(do_st, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sT);
    fence_regs(dpT);

    // P^T and dS^T (keys x queries); dS^T also to shared memory, bf16, the
    // 128-byte swizzle of a 64 x 64 chunk
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, col = 8 * (i >> 2) + c2 + (i & 1);
      const bool ok = full || pair_ok(qp_s[st][col], kp[hh], qs_s[st][col], ks[hh], causal, window);
      const float p = ok ? exp2f(sT[i] * scale_log2 - lse_s[st][col]) : 0.f;
      sT[i] = p;
      dpT[i] = p * (dpT[i] - dl_s[st][col]) * scale;
    }
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + c2;
      *reinterpret_cast<uint32_t*>(ds_ptr + row * 128 + ((((col >> 3) ^ (row & 7))) << 4) +
                                   ((col & 7) << 1)) = pack_bf16(dpT[i], dpT[i + 1]);
    }
    uint32_t pa[4][4], da[4][4];
    to_a_frags<32>(sT, pa);
    to_a_frags<32>(dpT, da);
    fence_proxy_async();
    __syncthreads();  // dS^T complete for every warp's dQ rows

    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D == 128) {
        wgmma_rs_n128<1>(dv_acc, pa[kk], desc_mn(do_st, kk), 1);
        wgmma_rs_n128<1>(dk_acc, da[kk], desc_mn(q_st, kk), 1);
      } else {
        wgmma_rs_n64<1>(dv_acc, pa[kk], desc_mn(do_st, kk), 1);
        wgmma_rs_n64<1>(dk_acc, da[kk], desc_mn(q_st, kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64<1, 1>(dq_acc, desc_mn(ds_s, kk), desc_mn(k_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(dq_acc);
    const int q_rows = min(64, Sq - iq * 64);
    float* dq_tile = dq + (((size_t)b * Sq + iq * 64) * H + h) * D;
    add_dq(dq_tile, dq_acc, q_rows, (size_t)H * D, 0);
    if constexpr (D == 128) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64<1, 1>(dq_acc, desc_mn(ds_s, kk), desc_mn(k_s + CHUNK_BYTES, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq_acc);
      add_dq(dq_tile, dq_acc, q_rows, (size_t)H * D, 64);
    }
    __syncthreads();  // every warp is done with stage st and with dS^T
    if (warp == 0) issue(st);
  }

  const int k_valid = min(64, Skv - k0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= k_valid) continue;
    const size_t off = (((size_t)b * Skv + k0 + r) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j + c2) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * hh], dk_acc[4 * j + 2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j + c2) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* lse,
                         const void* delta, const void* dout, const void* qp, const void* kp,
                         const void* qs, const void* ks, void* dq, void* dk, void* dv, int B,
                         int Sq, int Skv, int H, int KV, int causal, int window, float scale,
                         cudaStream_t stream) {
  using L = BwdTiles<D>;
  // once per instantiation (also keeps the call out of CUDA graph capture)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 L::BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t err = repro_sm90_host::tile_map(&q_map, q, B, Sq, H, D);
  if (err == cudaSuccess) err = repro_sm90_host::tile_map(&k_map, k, B, Skv, KV, D);
  if (err == cudaSuccess) err = repro_sm90_host::tile_map(&v_map, v, B, Skv, KV, D);
  if (err == cudaSuccess) err = repro_sm90_host::tile_map(&do_map, dout, B, Sq, H, D);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dq, 0, (size_t)B * Sq * H * D * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((Skv + 63) / 64, KV, B);
  flash_bwd_wgmma_kernel<D><<<grid, 128, L::BYTES, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(qp), static_cast<const int*>(kp),
      static_cast<const int*>(qs), static_cast<const int*>(ks), static_cast<float*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// q/dout (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in bf16 (is_bf16=1: the
// tensor-core kernel; 16-byte aligned) or f32 (the CUDA-core kernel);
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
      return launch_wgmma<128>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk, dv,
                               B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 64)
      return launch_wgmma<64>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk, dv,
                              B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 32)  // too narrow for the wgmma tiles: the CUDA-core kernel
      return launch<__nv_bfloat16, 32>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq,
                                       dk, dv, B, Sq, Skv, H, KV, causal, window, scale, s);
  } else {
    if (D == 128)
      return launch<float, 128>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk,
                                dv, B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 64)
      return launch<float, 64>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk,
                               dv, B, Sq, Skv, H, KV, causal, window, scale, s);
    if (D == 32)
      return launch<float, 32>(q, k, v, lse, delta, dout, q_pos, k_pos, q_seg, k_seg, dq, dk,
                               dv, B, Sq, Skv, H, KV, causal, window, scale, s);
  }
  return cudaErrorInvalidValue;
}

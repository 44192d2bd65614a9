// Paged decode attention for Hopper (sm_90a): one thread-block-cluster
// launch per call.
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
// (batch row, kv head, row group) would leave most of the 132 SMs idle:
// the cache is cut into `splits` chunks of whole tiles (32 or 64 slots),
// and the splits of one (batch row, kv head, row group) are the blocks of
// one thread-block cluster (at most 8, the portable size).
//   - A block holds all G*L query rows of its kv head (up to 16, scaled q
//     in f32 in shared memory).  Its four warps split every tile by slot,
//     each warp a quarter of the slots for all rows, and keep their own
//     (m, l, acc) in registers.  Those arrays, and the unguarded row loops
//     over them, are sized by a bucket of the rows (RR = 2, 4, 8 or 16):
//     sized for 16 at the serving shape's 2 rows they cost ~190 registers,
//     two blocks an SM, and a second wave of clusters.
//   - Warp 0 walks the chunk's tiles: from a tile's pos/seg bounds it
//     decides whether any pair can be unmasked before issuing its loads
//     (the rule of flash_attention.py::tile_reachable), so an empty or
//     unreachable tile costs a scan of its positions only.  The queries'
//     positions and the rows of the first tiles are loaded at once, and
//     those tiles' loads issued, while the other warps stage q; later the
//     rows of the next candidate tile are loaded while the current one is
//     computed, and a staged tile's slot rows wait beside it in shared
//     memory for the mask.
//   - Live K and V tiles arrive by TMA, in the cache's own dtype (bf16 is
//     not widened), 128-byte swizzled, through a ring of 2 or 4 stages
//     with a barrier each for K and V: V is in flight while Q K^T and the
//     softmax run, and the first tiles are all requested before the first
//     product.
//   - At the end the warps' partials merge in shared memory into the
//     block's (m, l, acc) (f32); after a cluster barrier the blocks split
//     the output elements between them, each reading every peer's partial
//     through distributed shared memory, and write out (B, L, H, D) in the
//     output dtype: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
//     exactly 0 where every split has l = 0.  With an `lse` pointer the
//     leader block (cluster rank 0) also writes each row's log-sum-exp,
//     M + log(sum_s e^(m_s - M) l_s), f32 (B, L, H), -1e30 where every
//     split has l = 0 (K1's with_lse contract).  A second cluster barrier
//     keeps each block's shared memory alive until its peers have read it.
//     No partial reaches device memory, and no block returns early: every
//     block of a cluster reaches both barriers.
// The per-split arithmetic and the merge are decode_split_ref and
// decode_combine_ref of flash_decode.py.
//
// Bound on the card.  At the serving decode shape (B=8, L=1, C=552, KV=8,
// G=2, D=128, bf16, 368 slots filled) the queries attend 4.5 MB of K/V:
// ~1.4 us at 3.35 TB/s; the work (~0.01 GFLOP) is far below the compute
// roof.  It is memory- and latency-bound: the plan puts at least two blocks
// on every SM where the cache is long enough, and each K/V byte a query
// can reach is read once per row group.
#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "attention_sm90.cuh"

namespace cg = cooperative_groups;
using namespace repro_attn;
using namespace repro_sm90;

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int RB = 16;          // query rows per block (G*L rows of one kv head)
constexpr int MAX_SPLITS = 8;   // the portable cluster size

template <typename T, int D, int BT>
struct Geo {
  static constexpr int ES = sizeof(T);
  static constexpr int EPC = 16 / ES;                  // elements in a 16-byte chunk
  static constexpr int LINES = D * ES / 128;           // 128-byte lines of a cache row
  static constexpr int TILE_BYTES = LINES * BT * 128;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int STAGES = STAGE_BYTES <= 16384 ? 4 : 2;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int SW = BT / NW;                   // slots a warp takes from each tile
  static constexpr int PARTS = 32 / SW;                // lanes that share one slot's q.k
  static constexpr int KCH = D * ES / 16 / PARTS;      // 16-byte chunks of a K row per lane
  static constexpr int VPL = D / 32;                   // output columns per lane
  static_assert(RING_BYTES >= NW * RB * (D + 2) * 4, "the warps' partials reuse the ring");
  static_assert(KCH >= 1 && (VPL == 2 || VPL == 4 || VPL == 8), "D must be 64, 128 or 256");
  // Dynamic shared memory for a block whose registers hold `rr` query
  // rows: 1024 bytes of alignment slack, the ring, q (then the block's
  // acc), the warps' p.
  static constexpr int smem(int rr) { return 1024 + RING_BYTES + rr * D * 4 + NW * rr * SW * 4; }
};

// Byte offset of 16-byte chunk c of slot row j in a tile: LINES regions of
// BT x 128 bytes (one per 128-byte line of a row, as TMA writes the boxes),
// each row's chunks permuted by the 128-byte swizzle (chunk k at k ^ (j % 8)).
template <int BT>
__device__ __forceinline__ uint32_t tile_off(int j, int c) {
  return (c >> 3) * BT * 128 + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}

__device__ __forceinline__ void unpack16(const uint8_t* p, float* x, float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void unpack16(const uint8_t* p, float* x, __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Bounds of the valid slots (pos >= 0) of one tile whose rows the warp
// holds, lane l rows l, l + 32, ...  Warp-wide: every lane returns the same.
template <int BT>
__device__ __forceinline__ Bounds tile_bounds(const int (&p)[BT / 32], const int (&s)[BT / 32]) {
  Bounds b{0, BIG, -BIG, BIG, -BIG};
#pragma unroll
  for (int i = 0; i < BT / 32; ++i) {
    if (p[i] >= 0) {
      b.any = 1;
      b.pmin = min(b.pmin, p[i]);
      b.pmax = max(b.pmax, p[i]);
      b.smin = min(b.smin, s[i]);
      b.smax = max(b.smax, s[i]);
    }
  }
  return warp_reduce_bounds(b);
}

// Warp 0's walk over the tiles of its chunk [next, end): the positions and
// segments of tile `next` are loaded one step ahead, so the loads of the
// next candidate are in flight while the current tile is computed.
template <int BT>
struct TileScan {
  int next, end;
  int p[BT / 32], s[BT / 32];     // rows of tile `next`, in flight
  int tp[BT / 32], ts[BT / 32];   // rows of the tile last taken

  __device__ __forceinline__ void load(const int* pos, const int* seg) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < BT / 32; ++i) {
      const int t = next + lane + 32 * i;
      p[i] = t < end ? pos[t] : -1;
      s[i] = t < end ? seg[t] : 0;
    }
  }

  // First slot of the next tile that the queries can reach, or -1 when the
  // chunk has none left.  Warp-wide: every lane returns the same.
  __device__ __forceinline__ int take(const int* pos, const int* seg, const Bounds& qb, int causal,
                                      int window) {
    while (next < end) {
      const Bounds b = tile_bounds<BT>(p, s);
      const int t = next;
#pragma unroll
      for (int i = 0; i < BT / 32; ++i) {
        tp[i] = p[i];
        ts[i] = s[i];
      }
      next += BT;
      load(pos, seg);
      if (reachable(qb, b, causal, window)) return t;
    }
    return -1;
  }
};

// Warp 0: the TMA loads of the tile whose first slot is t0 into ring stage
// s (lane 0), the tile's slot positions and segments beside it, and its
// slot in ring_tile (-1: the chunk is done).
template <typename G, int BT>
__device__ __forceinline__ void issue(uint8_t* ring, int s, int t0, const int (&tp)[BT / 32],
                                      const int (&ts)[BT / 32], const CUtensorMap* k_map,
                                      const CUtensorMap* v_map, uint64_t* full_k,
                                      uint64_t* full_v, int* ring_tile, int (*kp_s)[BT],
                                      int (*ks_s)[BT], int kvh, int b) {
  const int lane = threadIdx.x & 31;
  if (t0 >= 0) {
#pragma unroll
    for (int i = 0; i < BT / 32; ++i) {
      kp_s[s][lane + 32 * i] = tp[i];
      ks_s[s][lane + 32 * i] = ts[i];
    }
  }
  if (lane != 0) return;
  if (t0 >= 0) {
    uint8_t* kt = ring + s * G::STAGE_BYTES;
    mbar_expect_tx(&full_k[s], G::TILE_BYTES);
#pragma unroll
    for (int i = 0; i < G::LINES; ++i)
      tma_load_4d(kt + i * BT * 128, k_map, &full_k[s], i * G::EPC * 8, kvh, t0, b);
    mbar_expect_tx(&full_v[s], G::TILE_BYTES);
#pragma unroll
    for (int i = 0; i < G::LINES; ++i)
      tma_load_4d(kt + G::TILE_BYTES + i * BT * 128, v_map, &full_v[s], i * G::EPC * 8, kvh, t0, b);
  }
  ring_tile[s] = t0;
}

template <typename T, int D, int BT, int RR>
__global__ void __launch_bounds__(NT) decode_kernel(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const T* __restrict__ q, const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    const int* __restrict__ q_seg, const int* __restrict__ k_seg, T* __restrict__ out,
    float* __restrict__ lse, int L, int C, int H, int KV, int causal, int window, float scale,
    int chunk) {
  using G = Geo<T, D, BT>;
  static_assert(RR <= RB, "a block holds at most RB rows");
  constexpr int SW = G::SW, VPL = G::VPL, EPC = G::EPC;
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());

  const int Gq = H / KV;
  const int R = Gq * L;
  const int n_rg = (R + RB - 1) / RB;
  const int kvh = blockIdx.y / n_rg, rg = blockIdx.y % n_rg;
  const int b = blockIdx.z;
  const int rows = min(RB, R - rg * RB);   // this row group's rows (<= RR)
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  float* Qs = reinterpret_cast<float*>(ring + G::RING_BYTES);  // [RR][D]; later the block's acc
  float* Ps = Qs + RR * D;                                      // [NW][RR][SW]
  __shared__ uint64_t full_k[G::STAGES], full_v[G::STAGES];
  __shared__ int ring_tile[G::STAGES];
  __shared__ int kp_s[G::STAGES][BT], ks_s[G::STAGES][BT];  // the staged tiles' slots
  __shared__ int qp_s[RB], qs_s[RB];
  __shared__ float blk_m[RB], blk_l[RB], coef[RB][MAX_SPLITS], lsum[RB];

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
    }
    mbar_fence_init();
  }
  // Query row r of this kv head: group member g = r / L, lane l = r % L.
  // Warp 0 loads the rows' positions and segments and the slot rows of the
  // chunk's first STAGES tiles, every load in flight at once, and issues
  // the live tiles' loads; meanwhile the other warps stage q (scaled, f32;
  // rows past `rows` zero, so the row loops run unguarded).
  const int c_begin = split * chunk;
  const int* kp_row = k_pos + (size_t)b * C;
  const int* ks_row = k_seg + (size_t)b * C;
  TileScan<BT> scan;
  Bounds qb;
  if (w == 0) {
    int qp = -1, qs = -1;
    if (lane < rows) {
      qp = q_pos[(size_t)b * L + (rg * RB + lane) % L];
      qs = q_seg[(size_t)b * L + (rg * RB + lane) % L];
    }
    scan.end = min(C, c_begin + chunk);
    TileScan<BT> first[G::STAGES];
#pragma unroll
    for (int n = 0; n < G::STAGES; ++n) {
      first[n].next = c_begin + n * BT;
      first[n].end = scan.end;
      first[n].load(kp_row, ks_row);
    }
    if (lane < RB) {
      qp_s[lane] = qp;
      qs_s[lane] = qs;
    }
    Bounds lb{0, BIG, -BIG, BIG, -BIG};
    if (qp >= 0) lb = Bounds{1, qp, qp, qs, qs};
    qb = warp_reduce_bounds(lb);
    int s = 0;
#pragma unroll
    for (int n = 0; n < G::STAGES; ++n) {
      if (first[n].next < scan.end &&
          reachable(qb, tile_bounds<BT>(first[n].p, first[n].s), causal, window)) {
        issue<G, BT>(ring, s, first[n].next, first[n].p, first[n].s, &k_map, &v_map, full_k, full_v,
                     ring_tile, kp_s, ks_s, kvh, b);
        ++s;
      }
    }
    scan.next = c_begin + G::STAGES * BT;
    scan.load(kp_row, ks_row);
    for (; s < G::STAGES; ++s) {
      const int t0 = scan.take(kp_row, ks_row, qb, causal, window);
      issue<G, BT>(ring, s, t0, scan.tp, scan.ts, &k_map, &v_map, full_k, full_v, ring_tile, kp_s,
                   ks_s, kvh, b);
    }
  } else {
    for (int e = tid - 32; e < RR * (D / 4); e += NT - 32) {
      const int i = e / (D / 4), c = (e % (D / 4)) * 4;
      const int r = rg * RB + i;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < rows) {
        x = load4(q + (((size_t)b * L + r % L) * H + kvh * Gq + r / L) * D + c);
        x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
      }
      *reinterpret_cast<float4*>(Qs + i * D + c) = x;
    }
  }
  __syncthreads();

  float m_i[RR], l_i[RR], acc[RR][VPL];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    m_i[r] = NEG_INF;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[r][c] = 0.f;
  }
  const int j = lane % SW, h = lane / SW;  // Q K^T: slot j of the warp's share, part h of the row
  const int jt = w * SW + j;               // that slot's row in the tile
  float* pw = Ps + w * RR * SW;            // this warp's p of the tile, [RR][SW]

  for (int it = 0;; ++it) {
    const int s = it % G::STAGES;
    const int t0 = ring_tile[s];
    if (t0 < 0) break;
    const uint32_t parity = (it / G::STAGES) & 1;
    const int kp = kp_s[s][jt], ks = ks_s[s][jt];
    const uint8_t* kt = ring + s * G::STAGE_BYTES;

    mbar_wait(&full_k[s], parity);
    float sc[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) sc[r] = 0.f;
#pragma unroll
    for (int i = 0; i < G::KCH; ++i) {
      const int c = h * G::KCH + i;
      float kx[EPC];
      unpack16(kt + tile_off<BT>(jt, c), kx, T());
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float* qr = Qs + r * D + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4)
          sc[r] = dot4(*reinterpret_cast<const float4*>(qr + e),
                       make_float4(kx[e], kx[e + 1], kx[e + 2], kx[e + 3]), sc[r]);
      }
    }
    // rows past `rows` have q_pos -1: every pair masked, p = 0
#pragma unroll
    for (int r = 0; r < RR; ++r) {
#pragma unroll
      for (int off = SW; off < 32; off <<= 1) sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
      const bool ok = pair_ok(qp_s[r], kp, qs_s[r], ks, causal, window);
      const float x = ok ? sc[r] : NEG_INF;
      const float m_new = fmaxf(m_i[r], group_max<SW>(x));
      const float p = ok ? expf(x - m_new) : 0.f;
      const float corr = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * corr + group_sum<SW>(p);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[r][c] *= corr;
      if (h == 0) pw[r * SW + j] = p;
    }
    __syncwarp();

    mbar_wait(&full_v[s], parity);
    const uint8_t* vt = kt + G::TILE_BYTES;
    const int cb = lane * VPL * G::ES;  // byte of the lane's first output column in a row
#pragma unroll
    for (int jj = 0; jj < SW; ++jj) {
      const int row = w * SW + jj;
      const T* src = reinterpret_cast<const T*>(vt + tile_off<BT>(row, cb >> 4) + (cb & 15));
      float vx[VPL];
      if constexpr (VPL == 8) {  // D = 256: whole 16-byte chunks
#pragma unroll
        for (int q4 = 0; q4 < VPL * G::ES / 16; ++q4)
          unpack16(vt + tile_off<BT>(row, (cb >> 4) + q4), vx + q4 * G::EPC, T());
      } else if constexpr (VPL == 4) {
        const float4 x = load4(src);
        vx[0] = x.x; vx[1] = x.y; vx[2] = x.z; vx[3] = x.w;
      } else {
        const float2 x = load2(src);
        vx[0] = x.x; vx[1] = x.y;
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float p = pw[r * SW + jj];
#pragma unroll
        for (int c = 0; c < VPL; ++c) acc[r][c] = fmaf(p, vx[c], acc[r][c]);
      }
    }
    __syncthreads();  // every warp is done with stage s and with its p
    if (w == 0) {
      const int t_next = scan.take(kp_row, ks_row, qb, causal, window);
      issue<G, BT>(ring, s, t_next, scan.tp, scan.ts, &k_map, &v_map, full_k, full_v, ring_tile,
                   kp_s, ks_s, kvh, b);
    }
  }

  // ---- the warps' partials into the block's (m, l, acc) -------------------
  __syncthreads();  // the ring is free: every issued load has been consumed
  float* Wm = reinterpret_cast<float*>(ring);  // [NW][RB]
  float* Wl = Wm + NW * RB;                    // [NW][RB]
  float* Wacc = Wl + NW * RB;                  // [NW][RB][D]
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    if (r < rows) {
      if (lane == 0) {
        Wm[w * RB + r] = m_i[r];
        Wl[w * RB + r] = l_i[r];
      }
#pragma unroll
      for (int c = 0; c < VPL; ++c) Wacc[(w * RB + r) * D + lane * VPL + c] = acc[r][c];
    }
  }
  __syncthreads();
  float* Pacc = Qs;  // [rows][D]: q is no longer read
  for (int e = tid; e < rows * D; e += NT) {
    const int r = e / D, col = e % D;
    float M = NEG_INF;
#pragma unroll
    for (int v = 0; v < NW; ++v) M = fmaxf(M, Wm[v * RB + r]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int v = 0; v < NW; ++v) {
      const float wt = expf(Wm[v * RB + r] - M);
      a += wt * Wacc[(v * RB + r) * D + col];
      l += wt * Wl[v * RB + r];
    }
    Pacc[e] = a;
    if (col == 0) {
      blk_m[r] = M;
      blk_l[r] = l;
    }
  }
  cluster.sync();  // every split's partial is in its shared memory

  // ---- merge across the cluster (distributed shared memory) ---------------
  {
    const int r = tid / MAX_SPLITS, sp = tid % MAX_SPLITS;  // 16 rows x 8 splits = NT threads
    const bool have = r < rows && sp < ns;
    float m = NEG_INF, l = 0.f;
    if (have) {
      m = *cluster.map_shared_rank(&blk_m[r], sp);
      l = *cluster.map_shared_rank(&blk_l[r], sp);
    }
    const float M = group_max<MAX_SPLITS>(m);
    const float wt = have ? expf(m - M) : 0.f;
    const float ls = group_sum<MAX_SPLITS>(wt * l);
    coef[r][sp] = wt;
    if (sp == 0) lsum[r] = ls;
    if (lse != nullptr && split == 0 && sp == 0 && r < rows) {
      const int rr = rg * RB + r;
      lse[((size_t)b * L + rr % L) * H + kvh * Gq + rr / L] = ls > 0.f ? M + logf(ls) : NEG_INF;
    }
  }
  __syncthreads();
  for (int e = split * NT + tid; e < rows * D; e += ns * NT) {
    const int r = e / D, col = e % D;
    float o = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLITS; ++sp)
      if (sp < ns) o += coef[r][sp] * cluster.map_shared_rank(Pacc, sp)[e];
    const float den = lsum[r];
    const int rr = rg * RB + r;
    store1(out + (((size_t)b * L + rr % L) * H + kvh * Gq + rr / L) * D + col,
           den > 0.f ? o / den : 0.f);
  }
  cluster.sync();  // peers may still be reading this block's partial
}

// Tensor map of a (B, C, KV, D) cache of bf16 (es = 2) or f32 (es = 4),
// read in boxes of one 128-byte line of D by `rows` slots of one (kv head,
// batch row), 128-byte swizzle; slots past C read as zeros.
cudaError_t cache_map(CUtensorMap* map, const void* base, int B, int C, int KV, int D, int es,
                      int rows) {
  const repro_sm90_host::EncodeTiledFn fn = repro_sm90_host::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * es, (cuuint64_t)KV * D * es,
                                 (cuuint64_t)C * KV * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / es), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v, *q_pos, *k_pos, *q_seg, *k_seg;
  void* out;
  float* lse;
  int B, L, C, H, KV, causal, window;
  float scale;
  int chunk, splits;
};

// The launch configuration of one call (cluster of `splits` blocks along x).
template <typename T, int D, int BT, int RR>
cudaLaunchConfig_t launch_config(int B, int L, int H, int KV, int splits, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  const int R = (H / KV) * L;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV * ((R + RB - 1) / RB), B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Geo<T, D, BT>::smem(RR);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per instantiation (also keeps the call out of CUDA graph capture).
template <typename T, int D, int BT, int RR>
cudaError_t set_smem() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D, BT, RR>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 Geo<T, D, BT>::smem(RB));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int D, int BT, int RR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = set_smem<T, D, BT, RR>();
  if (err != cudaSuccess) return err;
  CUtensorMap k_map, v_map;
  err = cache_map(&k_map, a.k, a.B, a.C, a.KV, D, sizeof(T), BT);
  if (err == cudaSuccess) err = cache_map(&v_map, a.v, a.B, a.C, a.KV, D, sizeof(T), BT);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config<T, D, BT, RR>(a.B, a.L, a.H, a.KV, a.splits, stream, attr);
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, D, BT, RR>, k_map, v_map,
                           static_cast<const T*>(a.q), static_cast<const int*>(a.q_pos),
                           static_cast<const int*>(a.k_pos), static_cast<const int*>(a.q_seg),
                           static_cast<const int*>(a.k_seg), static_cast<T*>(a.out), a.lse, a.L,
                           a.C, a.H, a.KV, a.causal, a.window, a.scale, a.chunk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int D, int BT, int RR>
cudaError_t active_clusters(int B, int L, int H, int KV, int splits, int* n) {
  const cudaError_t err = set_smem<T, D, BT, RR>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T, D, BT, RR>(B, L, H, KV, splits, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(n, (const void*)decode_kernel<T, D, BT, RR>, &cfg);
}

struct LaunchFn {
  const Args& a;
  cudaStream_t stream;
  template <typename T, int D, int BT, int RR>
  cudaError_t run() const { return launch<T, D, BT, RR>(a, stream); }
};

struct ClustersFn {
  int B, L, H, KV, splits;
  int* n;
  template <typename T, int D, int BT, int RR>
  cudaError_t run() const { return active_clusters<T, D, BT, RR>(B, L, H, KV, splits, n); }
};

// f.run<T, D, BT, RR>() for the instantiation of (dtype, D, tile) whose
// register arrays hold RR >= rows query rows (2, 4, 8 or 16 in bf16, 16 in
// f32: a block's registers, and its row loops, are sized by the rows it
// has); rows = min(16, G * L).  cudaErrorInvalidValue for anything else.
template <typename F>
cudaError_t dispatch(int D, int is_bf16, int tile, int rows, const F& f) {
#define REPRO_DECODE_CASE(T, DD, BT, RR) \
  if (D == DD && tile == BT && rows <= RR) return f.template run<T, DD, BT, RR>();
#define REPRO_DECODE_ROWS(T, DD, BT) \
  REPRO_DECODE_CASE(T, DD, BT, 2) REPRO_DECODE_CASE(T, DD, BT, 4)      \
  REPRO_DECODE_CASE(T, DD, BT, 8) REPRO_DECODE_CASE(T, DD, BT, 16)
  if (is_bf16) {
    REPRO_DECODE_ROWS(__nv_bfloat16, 128, 64)
    REPRO_DECODE_ROWS(__nv_bfloat16, 128, 32)
    REPRO_DECODE_ROWS(__nv_bfloat16, 64, 64)
    REPRO_DECODE_ROWS(__nv_bfloat16, 64, 32)
    REPRO_DECODE_ROWS(__nv_bfloat16, 256, 64)  // recurrentgemma's heads: 64-slot tiles only
  } else {
    REPRO_DECODE_CASE(float, 128, 64, 16)
    REPRO_DECODE_CASE(float, 128, 32, 16)
    REPRO_DECODE_CASE(float, 64, 64, 16)
    REPRO_DECODE_CASE(float, 64, 32, 16)
  }
#undef REPRO_DECODE_ROWS
#undef REPRO_DECODE_CASE
  return cudaErrorInvalidValue;
}

int rows_of(int H, int KV, int L) {  // query rows of a block: G * L, at most RB
  const int R = (H / KV) * L;
  return R < RB ? R : RB;
}

bool valid_plan(int L, int C, int H, int KV, int tile, int chunk, int splits) {
  return L > 0 && C > 0 && KV > 0 && H % KV == 0 && (tile == 32 || tile == 64) && chunk > 0 &&
         chunk % tile == 0 && splits >= 1 && splits <= MAX_SPLITS &&
         splits == (C + chunk - 1) / chunk;
}

}  // namespace

// q (B,L,H,D) lanes, k/v (B,C,KV,D) cache, bf16 (is_bf16=1) or f32;
// positions/segments int32 (B,L) and (B,C); out (B,L,H,D) in q's dtype;
// lse (B,L,H) f32, or null for none.
// One launch: clusters of `splits` blocks, block s of a cluster taking
// slots [s * chunk, (s + 1) * chunk) in tiles of `tile` slots; `splits` =
// ceil(C / chunk) <= 8, chunk a multiple of tile (32 or 64).
extern "C" int flash_decode(const void* q, const void* k, const void* v, const void* q_pos,
                            const void* k_pos, const void* q_seg, const void* k_seg, void* out,
                            void* lse, int B, int L, int C, int H, int KV, int D, int is_bf16, int causal,
                            int window, float scale, int tile, int chunk, int splits,
                            void* stream) {
  if (B <= 0 || !valid_plan(L, C, H, KV, tile, chunk, splits)) return cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, k_pos, q_seg, k_seg, out, static_cast<float*>(lse), B, L, C, H,
               KV, causal, window, scale, chunk, splits};
  return dispatch(D, is_bf16, tile, rows_of(H, KV, L),
                  LaunchFn{a, static_cast<cudaStream_t>(stream)});
}

// How many clusters of that launch can be resident on the card at once
// (cudaOccupancyMaxActiveClusters), into *n.
extern "C" int flash_decode_active_clusters(int B, int L, int C, int H, int KV, int D, int is_bf16,
                                            int tile, int chunk, int splits, int* n) {
  if (B <= 0 || !valid_plan(L, C, H, KV, tile, chunk, splits)) return cudaErrorInvalidValue;
  return dispatch(D, is_bf16, tile, rows_of(H, KV, L), ClustersFn{B, L, H, KV, splits, n});
}

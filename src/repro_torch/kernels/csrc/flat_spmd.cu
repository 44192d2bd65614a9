// Per-row-shard VR optimizer updates for Hopper (sm_90a): the flat update of
// one rank's contiguous row range, with the per-leaf sums of all ranks
// combined by a collective between the launches.
//
// Replaces the TPU kernels of repro/kernels/flat_spmd.py, run by
// repro/backend.py::FlatSpmd under shard_map:
//   spmd_leaf_r_partials  K13  _r_partials_kernel:   racc[leaf] = sum r_raw
//   spmd_vr_scale_apply   K14  _scale_apply_kernel:  sg = r ga, r
//   spmd_vr_adam_apply    K15  _adam_apply_kernel:   upd = -lr u, m', v', p'
//   spmd_vr_lamb_compute  K16  _lamb_compute_kernel: u, m', v', p', and the
//                                                    per-leaf sums of u^2, w^2
//   spmd_vr_lars_compute  K17  _lars_compute_kernel: u = r ga + wd w and the
//                                                    same sums
// and the trust-ratio epilogue the reference writes in jnp
// (repro/backend.py::FlatSpmd.vr_lamb / vr_lars):
//   spmd_lamb_apply:  upd = -lr ratio_leaf u, in place on u
//   spmd_lars_apply:  m' = mu m + ratio_leaf u, upd = -lr m', in place.
// The math is flat_update.cu's, formulas in its note.
//
// Design.  Every entry launches a kernel of flat_update.cuh, the same code
// the single-card entries K5-K8 launch, over the shard's blocks: the leaf-id
// pointer is the shard's own slice of the block-leaf-id map (with leaf 0 for
// the zero blocks that pad the last shard), and the per-leaf r sum, which
// the single-card entries compute in their first pass, is an operand here:
// the sum of every shard's K13 output, combined by an all-reduce.  K13 runs
// the single-card entries' two-level sum (an f64 partial per block, added
// in block order by the last block), whose sorted search leaves the padding
// blocks out; K16 and K17 sum u^2 and w^2 the same way (flat_update.cuh::
// norm_sums), so the shard's sums are f64 sums rounded once.  The
// accumulators are one f32 per leaf (not the reference's (leaf_slots, 128)
// lane rows): a (leaf_slots,) racc, and a (2, leaf_slots) acc of the u^2
// and w^2 sums, every slot written by the kernel's last block.  Zero rows (a
// leaf's tail, the padding blocks) add exact zeros to every sum; in them
// r = gamma, sg = 0, u = 0 and p' = b3 p + (1 - b3) gamma, as in the
// reference.
//
// Bound on the card: bytes, each input read once and each output written
// once over the shard's rows (R_s rows of 128 f32 = 512 R_s bytes per f32
// buffer; at bert-large's layout over W shards, 1.4585 GB / W): K13 reads 2
// buffers; K14 reads 3 and writes 2; K15 and K16 read 4 f32 and 3 state
// buffers and write 1 f32 and 3 state; K17 reads 4 and writes 1.  The
// epilogues read and write u (and LARS's m).
#include "flat_update.cuh"

namespace {

bool bad_shape(int n_blocks, int leaf_slots) { return n_blocks <= 0 || leaf_slots <= 0; }

Hyper hyper(float lr, float bc1, float bc2, float bc3, float b1, float b2, float b3, float eps,
            float wd, float gamma, float gsnr_eps) {
  return Hyper{b1, b2, b3, eps, wd, gamma, gsnr_eps, lr, bc1, bc2, bc3};
}

// The two-level u^2 and w^2 sums of K16 and K17 over the shard's blocks:
// acc (2, leaf_slots) f32; partials 2 n_blocks f64, then the u32 ticket,
// which this zeroes.
cudaError_t shard_norms(void* acc, void* partials, int leaf_slots, int n_blocks, cudaStream_t s,
                        Norms* nm) {
  double* part = static_cast<double*>(partials);
  unsigned* ticket = reinterpret_cast<unsigned*>(part + 2 * (int64_t)n_blocks);
  float* uacc = static_cast<float*>(acc);
  *nm = Norms{part, ticket, uacc, uacc + leaf_slots, leaf_slots, 1};
  return cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
}

// The VR-Adam element-wise pass over the shard: TRUST false writes upd =
// -lr u (K15), true stashes u in upd and writes the per-leaf sums to acc
// (K16).
template <bool TRUST>
int adam_pass(const void* g, const void* ga, const void* g2, void* m, void* v, void* p,
              const void* w, void* upd, const void* leaf_ids, const void* inv_sizes,
              const void* racc, void* acc, void* partials, int leaf_slots, int n_blocks,
              int state_is_bf16, const Hyper& hp, void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Norms nm{};
  if (TRUST) {
    cudaError_t err = shard_norms(acc, partials, leaf_slots, n_blocks, s, &nm);
    if (err != cudaSuccess) return err;
  }
  const float* gf = static_cast<const float*>(g);
  const float* gaf = static_cast<const float*>(ga);
  const float* g2f = static_cast<const float*>(g2);
  const float* wf = static_cast<const float*>(w);
  float* uf = static_cast<float*>(upd);
  const int* ids = static_cast<const int*>(leaf_ids);
  const float* inv = static_cast<const float*>(inv_sizes);
  const float* ra = static_cast<const float*>(racc);
  if (state_is_bf16)
    adam_kernel<__nv_bfloat16, TRUST><<<n_blocks, NT, 0, s>>>(
        gf, gaf, g2f, static_cast<__nv_bfloat16*>(m), static_cast<__nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(p), wf, uf, ids, inv, ra, nm, hp);
  else
    adam_kernel<float, TRUST><<<n_blocks, NT, 0, s>>>(
        gf, gaf, g2f, static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(p),
        wf, uf, ids, inv, ra, nm, hp);
  return cudaGetLastError();
}

}  // namespace

// Shapes of every entry, over the shard: g, ga, g2, w, upd, u, sg, r:
// (n_blocks * 64, 128) f32; m, v, p: the same in the state dtype (f32 for
// LARS's m); leaf_ids: (n_blocks,) int32, the shard's slice of the map;
// inv_sizes: (leaf_slots,) f32; racc: (leaf_slots,) f32; acc: (2,
// leaf_slots) f32, the u^2 sums then the w^2 sums; partials (K13: n_blocks
// + 1, K16 and K17: 2 n_blocks + 1 f64): the blocks' partial sums, then the
// ticket of the last-block combine.

// K13: racc = per-leaf sums of r_raw over the shard, two-level as K5-K8's
// (flat_update.cuh::r_sums_kernel); partials: n_blocks f64, then the u32
// ticket, zeroed here.
extern "C" int spmd_leaf_r_partials(const void* g, const void* g2, const void* leaf_ids,
                                    void* racc, void* partials, int leaf_slots, int n_blocks,
                                    float gsnr_eps, void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(partials);
  unsigned* ticket = reinterpret_cast<unsigned*>(part + n_blocks);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  r_sums_kernel<<<n_blocks, NT, 0, s>>>(static_cast<const float*>(g),
                                        static_cast<const float*>(g2),
                                        static_cast<const int*>(leaf_ids), part, ticket,
                                        static_cast<float*>(racc), leaf_slots, 1, gsnr_eps);
  return cudaGetLastError();
}

// K14: sg = r ga and r, from the combined racc.
extern "C" int spmd_vr_scale_apply(const void* g, const void* ga, const void* g2, void* sg,
                                   void* r, const void* leaf_ids, const void* inv_sizes,
                                   const void* racc, int leaf_slots, int n_blocks, float gamma,
                                   float gsnr_eps, void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  scale_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(ga), static_cast<const float*>(g2),
      static_cast<float*>(sg), static_cast<float*>(r), static_cast<const int*>(leaf_ids),
      static_cast<const float*>(inv_sizes), static_cast<const float*>(racc), gamma, gsnr_eps);
  return cudaGetLastError();
}

// K15: VR-Adam, upd = -lr (direction + wd w); m, v, p in place.
extern "C" int spmd_vr_adam_apply(const void* g, const void* ga, const void* g2, void* m,
                                  void* v, void* p, const void* w, void* upd,
                                  const void* leaf_ids, const void* inv_sizes, const void* racc,
                                  int leaf_slots, int n_blocks, int state_is_bf16, float lr,
                                  float bc1, float bc2, float bc3, float b1, float b2, float b3,
                                  float eps, float wd, float gamma, float gsnr_eps,
                                  void* stream) {
  return adam_pass<false>(g, ga, g2, m, v, p, w, upd, leaf_ids, inv_sizes, racc, nullptr,
                          nullptr, leaf_slots, n_blocks, state_is_bf16,
                          hyper(lr, bc1, bc2, bc3, b1, b2, b3, eps, wd, gamma, gsnr_eps), stream);
}

// K16: VR-LAMB before the trust ratio: u = direction + wd w into u, m, v, p
// in place, the per-leaf sums of u^2 and w^2 into acc.
extern "C" int spmd_vr_lamb_compute(const void* g, const void* ga, const void* g2, void* m,
                                    void* v, void* p, const void* w, void* u,
                                    const void* leaf_ids, const void* inv_sizes,
                                    const void* racc, void* acc, void* partials, int leaf_slots,
                                    int n_blocks,
                                    int state_is_bf16, float bc1, float bc2, float bc3, float b1,
                                    float b2, float b3, float eps, float wd, float gamma,
                                    float gsnr_eps, void* stream) {
  return adam_pass<true>(g, ga, g2, m, v, p, w, u, leaf_ids, inv_sizes, racc, acc, partials,
                         leaf_slots, n_blocks, state_is_bf16,
                         hyper(0.f, bc1, bc2, bc3, b1, b2, b3, eps, wd, gamma, gsnr_eps), stream);
}

// K17: VR-LARS before the trust ratio: u = r ga + wd w, and the per-leaf
// sums of u^2 and w^2 into acc.
extern "C" int spmd_vr_lars_compute(const void* g, const void* ga, const void* g2, const void* w,
                                    void* u, const void* leaf_ids, const void* inv_sizes,
                                    const void* racc, void* acc, void* partials, int leaf_slots,
                                    int n_blocks, float gamma, float wd, float gsnr_eps,
                                    void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Norms nm;
  cudaError_t err = shard_norms(acc, partials, leaf_slots, n_blocks, s, &nm);
  if (err != cudaSuccess) return err;
  lars_compute_kernel<<<n_blocks, NT, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(ga), static_cast<const float*>(g2),
      static_cast<const float*>(w), static_cast<float*>(u), static_cast<const int*>(leaf_ids),
      static_cast<const float*>(inv_sizes), static_cast<const float*>(racc), nm, gamma, wd,
      gsnr_eps);
  return cudaGetLastError();
}

// The VR-LAMB epilogue: u <- -lr ratio_leaf u, from the combined acc.
extern "C" int spmd_lamb_apply(void* u, const void* leaf_ids, const void* acc, int leaf_slots,
                               int n_blocks, float lr, void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(acc);
  lamb_apply_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(u), static_cast<const int*>(leaf_ids), a, a + leaf_slots, lr);
  return cudaGetLastError();
}

// The VR-LARS epilogue: m <- mu m + ratio_leaf u, u <- -lr m, from the
// combined acc; m f32.
extern "C" int spmd_lars_apply(void* m, void* u, const void* leaf_ids, const void* acc,
                               int leaf_slots, int n_blocks, float lr, float mu, float trust,
                               void* stream) {
  if (bad_shape(n_blocks, leaf_slots)) return cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(acc);
  lars_apply_kernel<<<n_blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(m), static_cast<float*>(u), static_cast<const int*>(leaf_ids), a,
      a + leaf_slots, lr, mu, trust);
  return cudaGetLastError();
}

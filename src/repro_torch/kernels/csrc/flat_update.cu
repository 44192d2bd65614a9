// Flat VR optimizer updates for Hopper (sm_90a): the whole optimizer step over
// the (n_rows, 128) flat buffer of every parameter.
//
// Replaces the TPU kernels of repro/kernels/flat_update.py (bodies _raw_r,
// _inv_mean_r, _adam_math and _trust_ratio there), with the same math, all in
// f32:
//   r_raw = g^2 / (max(g2 - g^2, 0) + gsnr_eps)
//   r     = clip(r_raw / mean_leaf(r_raw), gamma, 1)
//
//   flat_vr_scale (_vr_scale_kernel, VR-SGD / VR-Momentum):
//     sg = r ga, and r itself
//   flat_vr_adam (_vr_adam_kernel) and flat_vr_lamb (_vr_lamb_kernel):
//     p' = b3 p + (1 - b3) r;   ghat = (p' / bc3) ga
//     m' = b1 m + (1 - b1) ghat;   v' = b2 v + (1 - b2) ghat^2
//     u  = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd w
//     VR-Adam: upd = -lr u
//     VR-LAMB: upd = -lr ratio_leaf u,  ratio = clip(|w|, 0, 10) / (|u| + 1e-12)
//              where both norms are > 0, else 1
//     with m', v', p' stored in the state dtype (f32 or bf16), in place.
//   flat_vr_lars (_vr_lars_kernel):
//     u  = r ga + wd w
//     m' = mu m + ratio_leaf u,  ratio = trust |w| / (|u| + 1e-12) where both
//          norms are > 0, else 1 (LARS: no clip of |w|);  upd = -lr m'
//     with m' in f32, in place.
//
// Design.  The TPU kernels run two or three sequential grid phases in one
// launch, carrying per-leaf sums in scratch rows.  A CUDA grid has no order
// between blocks, so the phases are launches on one stream:
//   1. r_partials: per-leaf sum of r_raw (every entry);
//   2. the element-wise pass: scale / adam write their outputs here; lamb and
//      lars stash u in ``upd`` and add per-leaf sums of u^2 and w^2;
//   3. (lamb, lars) the trust-ratio apply over the stashed u.
// One block of 256 threads handles one 64-row block of the layout, which
// lies in exactly one leaf (block_leaf_ids).  The per-leaf sum of r_raw is
// two-level: each block writes its sum (f32 over a thread's 32 elements,
// f64 across the block) to its own f64 slot, and the last block to finish
// (a __threadfence and a ticket counter) adds every leaf's slots in block
// order in f64 and writes the leaf's sum, rounded once, to the f32 racc
// row.  An f32 atomicAdd of each block's partial into one slot, the first
// design, rounds each addition to the growing sum's ulp: over a leaf of
// 212,992 blocks (DLRM's (26, 2^19, 128) tables) partials of ~7.5e3 went
// into a sum of ~1.6e9 (ulp 128), an error of up to 1e-3 of the mean
// (PERF.md).  The block order makes the sums the same bits on every run.
// The sums of u^2 and w^2 (lamb, lars) are two-level in the same way: the
// element-wise pass writes each block's two sums to f64 slots and its last
// block writes the leaf's sums to uacc and wacc, which the trust-ratio apply
// reads.  The zero tail of every leaf (g = g2 = ga = w = 0, so r_raw = u =
// 0) keeps the sums exact; 1/size is over the TRUE leaf sizes.  In the tail
// r is clipped up to gamma, so sg = 0 and p' = b3 p + (1 - b3) gamma there,
// as in the reference.  Every leaf slot of the accumulators is written by a
// last block, so the entry zeroes only the tickets (cudaMemsetAsync).
//
// Bound on the card: bytes (each does < 50 flops per element).  At
// bert-large's flat layout (2.85 M rows, 1.46 GB per f32 buffer) the
// functions must move: scale 3 in + 2 out = 5 buffers (7.3 GB, 2.2 ms at
// 3.35 TB/s); adam 7 in + 4 out = 11 f32 buffers (16.0 GB, 4.8 ms; bf16
// state 11.7 GB, 3.5 ms); lamb the same as adam; lars 5 in + 2 out = 7
// buffers (10.2 GB, 3.05 ms).  The passes sweep more, the price of having no
// grid-wide order: g and g2 are read twice by every entry, and lamb/lars
// write u, read it and write again (scale 7, adam 13, lamb 15, lars 11).
#include "flat_update.cuh"

namespace {

// ---- host side -------------------------------------------------------------

struct Flat {
  const int* leaf_ids;
  const float* inv_sizes;
  float* acc;         // (1 or 3, leaf_slots) f32: racc, then uacc and wacc
  double* partials;   // n_sums * n_blocks f64, then n_sums u32 tickets
  int leaf_slots, n_blocks;
};

unsigned* tickets(const Flat& f, int n_sums) {
  return reinterpret_cast<unsigned*>(f.partials + (int64_t)n_sums * f.n_blocks);
}

// Zeroes the n_sums tickets, then writes the per-leaf sums of r_raw into
// row 0 of acc (its slots: the first n_blocks partials and ticket 0).
cudaError_t r_partials(const Flat& f, int n_sums, const float* g, const float* g2, float gsnr_eps,
                       cudaStream_t s) {
  unsigned* ticket = tickets(f, n_sums);
  cudaError_t err = cudaMemsetAsync(ticket, 0, n_sums * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  r_sums_kernel<<<f.n_blocks, NT, 0, s>>>(g, g2, f.leaf_ids, f.partials, ticket, f.acc,
                                          f.leaf_slots, 0, gsnr_eps);
  return cudaGetLastError();
}

// The u^2 and w^2 sums of the trust pass: every partial slot (the r sums
// are done with theirs) and ticket 1, into rows 1 and 2 of acc.
Norms norms(const Flat& f) {
  return Norms{f.partials, tickets(f, 2) + 1, f.acc + f.leaf_slots, f.acc + 2 * f.leaf_slots,
               f.leaf_slots, 0};
}

template <typename S, bool TRUST>
cudaError_t run_adam(const Flat& f, const float* g, const float* ga, const float* g2, void* m,
                     void* v, void* p, const float* w, float* upd, const Hyper& hp,
                     cudaStream_t s) {
  const Norms nm = TRUST ? norms(f) : Norms{};
  cudaError_t err = r_partials(f, TRUST ? 2 : 1, g, g2, hp.gsnr_eps, s);
  if (err != cudaSuccess) return err;
  adam_kernel<S, TRUST><<<f.n_blocks, NT, 0, s>>>(
      g, ga, g2, static_cast<S*>(m), static_cast<S*>(v), static_cast<S*>(p), w, upd, f.leaf_ids,
      f.inv_sizes, f.acc, nm, hp);
  if ((err = cudaGetLastError()) != cudaSuccess || !TRUST) return err;
  lamb_apply_kernel<<<f.n_blocks, NT, 0, s>>>(upd, f.leaf_ids, nm.uacc, nm.wacc, hp.lr);
  return cudaGetLastError();
}

template <bool TRUST>
int adam_entry(const void* g, const void* ga, const void* g2, void* m, void* v, void* p,
               const void* w, void* upd, const void* leaf_ids, const void* inv_sizes, void* acc,
               void* partials, int leaf_slots, int n_blocks, int state_is_bf16, float lr,
               float bc1, float bc2, float bc3, float b1, float b2, float b3, float eps, float wd,
               float gamma, float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Hyper hp{b1, b2, b3, eps, wd, gamma, gsnr_eps, lr, bc1, bc2, bc3};
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), static_cast<double*>(partials), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* gaf = static_cast<const float*>(ga);
  const float* g2f = static_cast<const float*>(g2);
  const float* wf = static_cast<const float*>(w);
  float* uf = static_cast<float*>(upd);
  if (state_is_bf16)
    return run_adam<__nv_bfloat16, TRUST>(f, gf, gaf, g2f, m, v, p, wf, uf, hp, s);
  return run_adam<float, TRUST>(f, gf, gaf, g2f, m, v, p, wf, uf, hp, s);
}

}  // namespace

// Shapes of every entry: g, ga, g2, w, upd, sg, r: (n_blocks * 64, 128) f32;
// leaf_ids: (n_blocks,) int32, sorted; inv_sizes: (leaf_slots,) f32; acc:
// f32 scratch of (1 or 3, leaf_slots); partials: f64 scratch of n_blocks + 1
// (scale, adam) or 2 n_blocks + 1 (lamb, lars; the last slot holds the
// tickets).  The state m, v, p is updated in place.

// VR-LAMB.  m, v, p: f32 (state_is_bf16=0) or bf16; acc (3, leaf_slots).
extern "C" int flat_vr_lamb(const void* g, const void* ga, const void* g2, void* m, void* v,
                            void* p, const void* w, void* upd, const void* leaf_ids,
                            const void* inv_sizes, void* acc, void* partials, int leaf_slots,
                            int n_blocks, int state_is_bf16, float lr, float bc1, float bc2,
                            float bc3, float b1, float b2, float b3, float eps, float wd,
                            float gamma, float gsnr_eps, void* stream) {
  return adam_entry<true>(g, ga, g2, m, v, p, w, upd, leaf_ids, inv_sizes, acc, partials,
                          leaf_slots, n_blocks, state_is_bf16, lr, bc1, bc2, bc3, b1, b2, b3, eps,
                          wd, gamma, gsnr_eps, stream);
}

// VR-Adam.  m, v, p: f32 (state_is_bf16=0) or bf16; acc (1, leaf_slots).
extern "C" int flat_vr_adam(const void* g, const void* ga, const void* g2, void* m, void* v,
                            void* p, const void* w, void* upd, const void* leaf_ids,
                            const void* inv_sizes, void* acc, void* partials, int leaf_slots,
                            int n_blocks, int state_is_bf16, float lr, float bc1, float bc2,
                            float bc3, float b1, float b2, float b3, float eps, float wd,
                            float gamma, float gsnr_eps, void* stream) {
  return adam_entry<false>(g, ga, g2, m, v, p, w, upd, leaf_ids, inv_sizes, acc, partials,
                           leaf_slots, n_blocks, state_is_bf16, lr, bc1, bc2, bc3, b1, b2, b3, eps,
                           wd, gamma, gsnr_eps, stream);
}

// VR scale (VR-SGD / VR-Momentum): sg = r ga and r; acc (1, leaf_slots).
extern "C" int flat_vr_scale(const void* g, const void* ga, const void* g2, void* sg, void* r,
                             const void* leaf_ids, const void* inv_sizes, void* acc,
                             void* partials, int leaf_slots, int n_blocks, float gamma,
                             float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), static_cast<double*>(partials), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* g2f = static_cast<const float*>(g2);
  cudaError_t err = r_partials(f, 1, gf, g2f, gsnr_eps, s);
  if (err != cudaSuccess) return err;
  scale_kernel<<<n_blocks, NT, 0, s>>>(gf, static_cast<const float*>(ga), g2f,
                                       static_cast<float*>(sg), static_cast<float*>(r), f.leaf_ids,
                                       f.inv_sizes, f.acc, gamma, gsnr_eps);
  return cudaGetLastError();
}

// VR-LARS.  m: f32, updated in place; acc (3, leaf_slots).
extern "C" int flat_vr_lars(const void* g, const void* ga, const void* g2, void* m, const void* w,
                            void* upd, const void* leaf_ids, const void* inv_sizes, void* acc,
                            void* partials, int leaf_slots, int n_blocks, float lr, float gamma,
                            float mu, float wd, float trust, float gsnr_eps, void* stream) {
  if (n_blocks <= 0 || leaf_slots <= 0) return cudaErrorInvalidValue;
  const Flat f{static_cast<const int*>(leaf_ids), static_cast<const float*>(inv_sizes),
               static_cast<float*>(acc), static_cast<double*>(partials), leaf_slots, n_blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* g2f = static_cast<const float*>(g2);
  float* uf = static_cast<float*>(upd);
  const Norms nm = norms(f);
  cudaError_t err = r_partials(f, 2, gf, g2f, gsnr_eps, s);
  if (err != cudaSuccess) return err;
  lars_compute_kernel<<<n_blocks, NT, 0, s>>>(gf, static_cast<const float*>(ga), g2f,
                                              static_cast<const float*>(w), uf, f.leaf_ids,
                                              f.inv_sizes, f.acc, nm, gamma, wd, gsnr_eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  lars_apply_kernel<<<n_blocks, NT, 0, s>>>(static_cast<float*>(m), uf, f.leaf_ids, nm.uacc,
                                            nm.wacc, lr, mu, trust);
  return cudaGetLastError();
}

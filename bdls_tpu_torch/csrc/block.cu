// The fused block program for Hopper (sm_90a): SHA-256 -> ECDSA verify ->
// N-of-M policy tally, per-tx flags out, no return to the host between
// the stages (K7).
//
// Replaces the TPU program bdls_tpu/ops/block_verify.py:
// _jitted_block_cached -> block_kernel: the in-kernel hash
// (ops/sha256.py:sha256_words -> words_to_e16), verify_fold, then the
// policy as bitmap algebra, hits = tx_onehot · (valid · org_onehot),
// has = hits > 0 & org_mask > 0, flags = count(has) >= required ? VALID
// : POLICY_FAILURE. The TPU built the (T, O) hit bitmap with two one-hot
// contractions for its matrix unit; here each lane stores its own hit:
//
//   1. cudaMemsetAsync zeroes the (T, O) byte bitmap `hit`;
//   2. block_lane_kernel<C>: csrc/block.cuh's block_lane_group (a
//      thread group a lane, K1's body of csrc/verify_group.cuh; one
//      share hashes beside s's inverse, the digest is the verify's e)
//      -> valid[b]; share 0 of a valid lane with 0 <= tx < T and
//      0 <= org < O stores hit[tx·O + org] = 1. Every such store writes
//      the same 1, so two lanes of one (tx, org) need no atomic, and two
//      endorsements from one org count once. The mxu build runs the same
//      body over K5's warp-collective products (csrc/mxu.cuh);
//   3. block_tally_kernel, one thread a tx: csrc/block.cuh's tally_tx,
//      the in-mask hit count against required.
//
// What bounds it: the verify's step latency, as K1 (csrc/verify.cu); the
// hash, some 2,000 integer instructions a 64-byte block on one share,
// runs beside the binary inverse, the tally O bytes a tx.
//
// Interface: plain C, bound with ctypes (bdls_tpu_torch/ops/_build.py).
// The three steps go on the caller's stream, in order, without
// synchronising; the entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "block.cuh"

namespace bdls {

constexpr int BLOCK_LANE_THREADS = grp::GROUP;

// a group a lane, the lanes' states in dynamic shared memory; a group
// past L runs lane L - 1 as filler and stores nothing (in the mxu build
// it also makes every K5 call of the warp)
template <class C>
__global__ void block_lane_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ nblocks,
                                  const int32_t* __restrict__ qx,
                                  const int32_t* __restrict__ qy,
                                  const int32_t* __restrict__ r,
                                  const int32_t* __restrict__ s,
                                  const int32_t* __restrict__ lane_tx,
                                  const int32_t* __restrict__ lane_org,
                                  const uint32_t* __restrict__ g32,
                                  uint8_t* __restrict__ hit,
                                  uint8_t* __restrict__ valid, int NB, int L,
                                  int T, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / grp::GROUP;
  const int b = blockIdx.x * (blockDim.x / grp::GROUP) + group;
  const bool live = b < L;
  const int lane = live ? b : L - 1;
  grp::lane_state& st = reinterpret_cast<grp::lane_state*>(smem)[group];
  const grp::gctx g{(int)(threadIdx.x % grp::GROUP), grp::warp_mask()};
  const bool ok = block_lane_group<C>(g, st, words, nblocks[lane], NB, qx,
                                      qy, r, s, g32, lane, L);
  if (!grp::votes(g.share, live)) return;
  valid[b] = ok ? 1 : 0;
  const int tx = lane_tx[b], org = lane_org[b];
  if (ok && tx >= 0 && tx < T && org >= 0 && org < O)
    hit[(size_t)tx * O + org] = 1;
}

__global__ void block_tally_kernel(const uint8_t* __restrict__ hit,
                                   const uint32_t* __restrict__ org_mask,
                                   const int32_t* __restrict__ required,
                                   int32_t* __restrict__ flags, int T,
                                   int O) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  flags[t] = tally_tx(hit, org_mask, required, t, O);
}

}  // namespace bdls

// curve: 0 = P-256, 1 = secp256k1. words: (NB, 16, L) uint32; nblocks,
// lane_tx, lane_org: (L,) int32; qx, qy, r, s: (16, L) int32 limbs;
// org_mask: (T, O) uint32; required: (T,) int32; gtab: the curve's
// (32, 256, 3, 8) positioned G tables in Montgomery form; hit: (T, O)
// bytes of scratch;
// valid: L bytes; flags: (T,) int32. threads: a block's threads, a
// multiple of the build's threads a lane (verify.cu's
// bdls_verify_lane_threads; whole warps, at most BDLS_MXU_WARPS, in the
// mxu build); the tally runs blocks of as many.
extern "C" int bdls_verify_block(int curve, const void* words,
                                 const void* nblocks, const void* qx,
                                 const void* qy, const void* r, const void* s,
                                 const void* lane_tx, const void* lane_org,
                                 const void* org_mask, const void* required,
                                 const void* gtab, void* hit, void* valid,
                                 void* flags, int NB, int L, int T, int O,
                                 int threads, void* stream) {
  if (T <= 0) return 0;
  if (L < 0 || threads <= 0 || threads > 1024 || NB <= 0 || O <= 0 ||
      threads % bdls::BLOCK_LANE_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  if (curve != 0 && curve != 1) return (int)cudaErrorInvalidValue;
  if (!bdls::grp::block_fits(threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(threads / bdls::BLOCK_LANE_THREADS) *
                      sizeof(bdls::grp::lane_state);
  if (smem + bdls::grp::STATIC_SMEM > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int lanes = threads / bdls::BLOCK_LANE_THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(hit, 0, (size_t)T * O, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L > 0 ? (L + lanes - 1) / lanes : 1);
  const uint32_t* w = (const uint32_t*)words;
  const int32_t* nb = (const int32_t*)nblocks;
  const int32_t* a[4] = {(const int32_t*)qx, (const int32_t*)qy,
                         (const int32_t*)r, (const int32_t*)s};
  const int32_t* tx = (const int32_t*)lane_tx;
  const int32_t* org = (const int32_t*)lane_org;
  const uint32_t* g = (const uint32_t*)gtab;
  if (L > 0 && curve == 0) {
    bdls::block_lane_kernel<bdls::CurveP256><<<grid, threads, smem, st>>>(
        w, nb, a[0], a[1], a[2], a[3], tx, org, g, (uint8_t*)hit,
        (uint8_t*)valid, NB, L, T, O);
  } else if (L > 0) {
    bdls::block_lane_kernel<bdls::CurveK256><<<grid, threads, smem, st>>>(
        w, nb, a[0], a[1], a[2], a[3], tx, org, g, (uint8_t*)hit,
        (uint8_t*)valid, NB, L, T, O);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bdls::block_tally_kernel<<<(T + threads - 1) / threads, threads, 0, st>>>(
      (const uint8_t*)hit, (const uint32_t*)org_mask,
      (const int32_t*)required, (int32_t*)flags, T, O);
  return (int)cudaGetLastError();
}

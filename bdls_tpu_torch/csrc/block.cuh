// The bodies of the fused block program's kernels in csrc/block.cu (K7),
// one lane and one tx, kept in a header so the host build of the same
// code (tests/test_torch_host_kernel.py) checks them against the plain
// PyTorch block_kernel, lane for lane and tx for tx.
//
// SHA-256 of the lane's padded message (csrc/sha256.cuh:lane_digest, the
// one-thread body with the schedule inline; K6 no longer shares it, its
// schedule and rounds run in two warps), then the digest as the verify's
// e, then K1's lane body, a thread group a lane
// (block_lane_group over csrc/verify_group.cuh: one share hashes while
// another inverts s; in the mxu build the round's products go through
// K5). The hash finishes before the ladder starts, so only its eight
// digest words live on into the verify.
#pragma once

#include "sha256.cuh"
#include "verify_group.cuh"

namespace bdls {

// Big-endian digest words (word 0 most significant) -> the 256-bit
// integer as eight little-endian 32-bit limbs: word j is limb 7 - j, the
// layout load_limbs16 builds from ops/sha256.py:words_to_e16.
BDLS_HD void digest_to_fe(fe& e, const uint32_t st[8]) {
  BDLS_UNROLL
  for (int j = 0; j < 8; ++j) e.v[7 - j] = st[j];
}

// Lane b's verdict on the group body: the four key and signature limb
// arrays loaded, the hash on its own share beside s's inverse.
template <class C>
BDLS_HD bool block_lane_group(const grp::gctx& g, grp::lane_state& st,
                              const uint32_t* words, int nblocks, int NB,
                              const int32_t* qx, const int32_t* qy,
                              const int32_t* r, const int32_t* s,
                              const uint32_t* g32, int b, int L) {
  const int32_t* in[4] = {qx, qy, r, s};
  return grp::verify_group<C, true>(
      g, st, [&](int t, fe& v) { load_limbs16(v, in[t], b, L); },
      [&](fe& e) {
        uint32_t h[8];
        sha::lane_digest(h, words, nblocks, NB, b, L);
        digest_to_fe(e, h);
      },
      g32);
}

// Tx t's flag from the (T, O) hit bitmap: the count of its orgs that hit
// and count toward its policy, against required[t].
BDLS_HD int32_t tally_tx(const uint8_t* hit, const uint32_t* org_mask,
                         const int32_t* required, int t, int O) {
  int cnt = 0;
  for (int o = 0; o < O; ++o) {
    const size_t i = (size_t)t * O + o;
    cnt += (hit[i] != 0 && org_mask[i] != 0u) ? 1 : 0;
  }
  return cnt >= required[t] ? 0 : 2;   // TXFLAG_VALID : POLICY_FAILURE
}

}  // namespace bdls

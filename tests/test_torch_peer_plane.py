"""Phase 6l rehearsed on the CPU: ``chip_smoke.py:drive_peer_plane`` on
the port's ``SwCSP``, at 2 blocks of 40 transactions (1 in 10 hostile,
each of the four kinds twice), with every check the card's run makes
but its launches: the 8 ledgers and KV states equal, the flags as
built, the alive decisions equal to the host run's, the tampered and
the outsider's alive messages refused, one failover to the other
eligible peer, the snapshot joiner without a replay, push and state
transfer, the policy's verdicts equal to the committed flags, and the
contract runtime's write-sets byte-equal to the in-process ones."""

from __future__ import annotations

import sys
from pathlib import Path

from bdls_tpu_torch.crypto.sw import SwCSP


def test_phase_6l_rehearsed_on_the_cpu():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    row = chip_smoke.drive_peer_plane("cpu", n_blocks=2, block_txs=40,
                                      hostile_every=10, offset=5,
                                      make_csp=SwCSP)
    assert row["peers"] == 8
    assert row["hostile"] == {"bad_payload": 2, "duplicate_txid": 2,
                              "flipped_endorsement": 2,
                              "unknown_endorser": 2}
    assert row["leaders"] == ["org2-peer0:7051", "org1-peer0:7051"]
    assert row["membership_stats"]["alive_rejected"] == 2
    assert row["gossip_stats"]["pushed"] and \
        row["gossip_stats"]["transferred"]
    assert row["snapshot"]["height"] == 3
    # the policy judged each VALID or ENDORSEMENT_POLICY_FAILURE
    # transaction of block 1: all but its duplicate and its bad payload
    assert row["policy"]["txs"] == 38
    assert row["policy"]["layouts"] == [{"org1": 1, "org2": 1}]
    assert row["contract_runtime"]["txs"] == 39
    assert row["contract_runtime"]["launches"] == 1
    assert row["alive_decisions"] > row["alive_checks"]["count"] > 0
    assert [c["peers"] for c in row["commits"].values()] == [7, 7]
    assert row["launches"] == {}

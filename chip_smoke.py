"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   device count; no CUDA device is a failure;
2. build the kernels of ``bdls_tpu_torch/csrc`` in phase 6g's first
   process (below; the main path's requests are made before it) into
   ``build/`` and an empty library store (``verify.cu``, the
   generic verify K1, whose captured graphs are K3; ``pinned.cu``, the
   pinned-key verify K2; ``sha256.cu``, the SHA-256 K6; ``block.cu``,
   the fused block program K7; ``ed25519.cu``, the Ed25519 verify K8;
   ``bls.cu``, the BLS12-381 certificate check K9 and its full-exponent
   final exponentiation K11; ``mont16.cu``, the gen-1 verify K4; each of
   ``verify.cu``, ``pinned.cu`` and ``mont16.cu`` also holds its
   counting build, a mesh shard's program with K10's count as its
   epilogue (``*_count`` kernels); and the mxu builds of ``verify.cu``,
   ``pinned.cu``, ``block.cu`` and ``ed25519.cu`` with
   ``-DBDLS_MUL_MXU``, whose products are K5's, ``csrc/mxu.cuh``) with
   nvcc for sm_90a, one compiler per build side by side, and print the
   build time and each kernel's ``-Xptxas -v`` registers, shared memory,
   stack frame and spills (for ``bls.cu`` also each called function's
   frame and spills), and the geometry of K1's, K2's and K7's vpu
   builds, a thread group a lane (``csrc/verify_group.cuh``,
   ``csrc/pinned_group.cuh``): threads a lane, lanes a block, blocks at
   128, 2048 and 8192 lanes, and the ptxas lines of K2's group body; and
   K8's group body's (``csrc/edwards_group.cuh``) registers, spills,
   threads a lane and shared bytes a lane and a block, and K4's
   (``csrc/mont16_group.cuh``, both kernels, both curves);
3. per curve, at the bucket the main path launches (128 lanes for
   secp256k1, 2048 for P-256), the K1 kernel against the plain PyTorch
   version on the same card, lane for lane, and against the port's
   pure-Python ECDSA: valid, tampered and hostile lanes and the
   ladder's edges (R at infinity, u1·G = u2·Q, both signs of
   secp256k1's second GLV half: ``vectors.ladder_lanes``), filled up
   with the main path's own signatures (the forged votes and tampered
   endorsements included);
4. the same for K2 (its vpu build a thread group a lane,
   ``csrc/pinned_group.cuh``) against its plain version, over a pool on
   the card: 128 pinned consenter keys (secp256k1, 128 lanes) and 16
   pinned endorser keys (P-256, 2048 lanes), with tampered digest, r and
   s, r or s out of [1, n), a lane under another key's slot, a u2 with a
   negative GLV half, the forged r + n lane and u1 with zero bytes and
   u1 = 0 (G entries at infinity) mixed in;
4b. K6 (a schedule warp and a rounds warp a CTA of 32 lanes,
   ``csrc/sha256.cu``) against hashlib and its plain version, exactly, at
   128, 2048, 2049 and 8192 lanes (the block lane's preimages, the
   padding boundaries, a count above NB, filler lanes of counts 0 and
   -1; the last CTA at 2049 with one live lane) and on a uniform batch of
   2048 lanes of 16 blocks; K7 against its plain version, lane for lane
   and tx for tx, on a hostile 1000-tx P-256 block at the main shape
   (L 2048, T 2048, NB 16, O 4) and a hostile 50-tx secp256k1 block
   (L 128): tampered, high-S and overlong lanes, r and s out of range,
   a key off the curve, under-endorsed txs, the sentinel policy, one org
   endorsing twice;
3c. K8 (a thread group a lane, ``csrc/edwards_group.cuh``) against its
   plain twin and the RFC 8032 oracle at 128 and 2048 lanes: the §7.1
   vectors, seeded valid lanes, tampered message / R / S / key, S = L -
   1, L, S + L and 2^256 - 1, A off the curve or out of range,
   non-canonical R, R with x = 0 and the sign bit set, an R that does
   not decompress, the identity as A and R, small-order A and torsion in
   A and R, rows with a chosen k (a zero top digit, carry nibble 0 and
   1, ``vectors.ed25519_k_rows``, against the equation with k as it
   is), filled up with the main path's votes;
3d. K9 (its Miller launch and its final launch) against its plain twin
   on the card, stage for stage ((n, d), both final exponentiations,
   the verdicts), and against the oracle's verdicts, on 10 lanes: valid
   certificates of the 128- and 1024-validator committees, a wrong
   binding, no signature, under quorum, a signer out of range (the last
   three masked by ``certificate_lanes``), a byzantine signature
   ``pt_add(sig, G1)`` (on E(FQ12), off the twist's image: the Miller
   launch's dense path), the degenerate y = 0 "signature" and an
   all-zero lane fed to the kernel directly; each lane's form read from
   its words by the kernel's rule (the dense lanes must be the forged
   and the y = 0 ones, a twisted pair's d one tower coefficient);
3e. K4 against its plain twin (``ops/ecdsa.py:verify_kernel``) on the
   card and the integer ECDSA, lane for lane, on phase 3's batches (128
   secp256k1 lanes in 32 one-warp blocks, 2048 P-256 lanes in 512; the
   hostile set with s = n among them) and a ragged 2049 P-256 lanes,
   each with the lanes that take the ladder's exceptional selects;
3f. K5's warp call (``bdls_field_mul`` of the mxu build) against the
   CIOS product of the vpu build and Python integers, bit for bit, on
   P-256 p and n, secp256k1 p and n and 2^255 - 19, at edge values and
   4096 seeded pairs each; then the mxu builds of K1, K2 and K8 (the
   group bodies over K5) against their vpu kernels and their plain twins
   under the "mxu" engine, lane for lane, on the inputs of phases 3, 4
   and 3c tiled to 128, 2048, 8192 and 2049 lanes (a warp ending in a
   part group), the counting builds of K1 and K2 (K10's shards) at 2049
   with their partials, and K7's on phase 4b's blocks, lane for lane and
   tx for tx;
3g. K10: the fused count, each counting build (K1, K1 + K5, K4, K2)
   against its plain build's verdicts and the plain twin's count at
   2048, 8192 and 2000 lanes (masks all-on, all-off, random); the split
   (``sharded_verify_masked`` and ``pjit_verify_masked``) over a
   two-shard mesh of the one card and a one-shard mesh against one
   unsplit launch of the same program and the integer ECDSA, lane for
   lane with equal ``n_valid``, at 2048 and 8192 P-256 lanes (phase 3's
   batch, hostile lanes included) and a padded 2000-of-2048 batch, under
   ``fold``, ``mxu`` and ``mont16``; the pinned split over phase 4's
   pools;
3h. K11 (the exact x-chain, a warp a side) against its plain twin
   (square-and-multiply) on the card and the oracle's
   ``v.pow((p^12 - 1)//r)``, value for value, on phase 3d's 10 lanes (20
   sides, the zero lane included), and K9's x-chain values as their
   cubes;
5. the K1 main path through ``TorchCSP(device="cuda", key_cache_size=0,
   use_cpu_fallback=False, latency_max_lanes=0)`` (the latency tier
   off; phase 6d drives it): one 128-validator secp256k1 vote round
   (``submit`` + ``flush``, two forged votes) and one 1000-tx x
   2-endorsement P-256 batch (``verify_batch``, 2000 lanes, a few
   tampered); exact verdicts, no fallback, and launch counts (set to 0
   just before, read just after): one launch per curve;
6. the K2 main path through ``TorchCSP(device="cuda")`` (the key cache
   on, as by default): the consensus seam ``CspBatchVerifier`` with 128
   consenters pinned verifies 128 envelopes (2 forged, 1 from a key
   outside the set): K2 for 127 lanes and K1 for the new key, one launch
   each; after the background build, a second round all K2;
   ``TorchBatchVerifier`` gives the same verdicts; then a 2000-lane
   P-256 block from 16 pinned endorsers in one K2 launch, no fallback;
6b. the block lane: the 1000-tx x 2-endorsement P-256 block (4 orgs,
   preimages of 200-1000 bytes) through ``TorchCSP(device="cuda")
   .verify_block`` with the default key cache: exactly one K7 launch and
   no other, no fallback, one block counted, the host oracle's flags;
   the secp256k1 block through the same entry (one K7 launch, and no
   K6 launch on either: K7 hashes with its own body); the block's
   preimages through ``sha256_batch`` (one K6 launch);
6c. the Ed25519 vote path: a 128-validator committee's 85-vote quorum
   and a 1024-validator committee's 683-vote quorum (a few forged)
   through ``TorchCSP(device="cuda")`` ``submit`` + ``flush``: exact
   verdicts, equal to the plain twin on the round's marshaled lanes (the
   marshaling and the plain twin timed), one K8 launch a round, no K1,
   K2 or K3 launch, no fallback;
6d. K3 at full width: a 128-validator secp256k1 committee on
   ``TorchCSP(device="cuda", key_cache_size=0)`` after ``warmup``
   captured the latency buckets; ``CspBatchVerifier`` sets the quorum
   hint to 85; 85 ``submit`` calls (2 forged) at the reference's flush
   interval (2 ms) go out as one speculative flush, launched inside the
   interval, through exactly one K3 replay, no eager K1 launch, no cold
   fallback; once with the vote
   buckets off (bucket 128), once with ``VOTE_BUCKETS`` (bucket 85);
   then the ring repro: 21 requests at ``buckets=(8,)``, three runs,
   the same right verdicts;
6e. the certificate lane: ``TorchCSP(device="cuda").verify_certificates``
   with 2 certificates a call for committees of 128 (quorum 85) and 1024
   (quorum 683) validators, warmed as ``tools/tpu_ablate.py:cert_sweep``
   warms them, then counted: the verdicts of construction, one launch of
   each K9 kernel and no other, the host backend unused; 9 calls a
   committee by the host clock beside the oracle's time; a cross-round
   batch of 64 certificates (2 forged) in one launch pair;
5b. the main path under ``kernel_field="mont16"``: the 128-vote
   secp256k1 round (a counted cold fallback, then exactly one K4
   launch), the 2000-lane P-256 batch (one K4 launch), the vote round
   through ``CspBatchVerifier`` with 128 consenters pinned (K2 for 127
   lanes, K4 for the new key), the pinned block batch (one K2 launch) and
   ``verify_block`` (one K7 launch); no other kernel;
5c. the same under ``kernel_field="mxu"``, where only mxu builds may
   run: the vote round as one K3 replay over K1 + K5, the batch one
   K1 + K5 launch, the pinned lanes K2 + K5, ``verify_block`` one K7 + K5
   launch a block (the 1000-tx P-256 block and the 50-tx secp256k1 one),
   and an 85-vote Ed25519 round, one K8 + K5 launch;
5d. the mesh main path: ``TorchCSP(device="cuda", mesh_threshold=2048)``
   on the real device list does not split on one card (one K1 launch,
   no K10); with a two-shard mesh of the card stood in for the device
   list (``parallel.mesh.mesh_devices`` replaced for the phase), the
   2000-lane P-256 batch and the pinned 2000-lane block each take two
   shard launches (the counting builds of K1, K2) and no count launch,
   no unsplit launch, the oracle's verdicts, in both shard modes;
6f. the ``"kernel"`` certificate path: ``verify_certificates(...,
   backend="kernel")`` for the committees of 128 and 1024, 2 a call, and
   the batch of 64: one Miller launch and one K11 launch a call, no K9
   final launch, the host backend unused; the default call still
   launches K9's two;
6g. the provider plane, in processes of their own started with
   ``BDLS_TPU_AOT_CACHE`` (``python3 chip_smoke.py --provider-child
   ROLE DIR``, never by hand): the first (run as phase 2) builds and
   stores the 11 libraries with nvcc, pins the 128 consenters and the 16
   endorsers of phase 6, runs the 127-vote round through
   ``CspBatchVerifier`` (all K2) and writes ``snapshot_to``; the second,
   with nvcc hidden (``PATH`` without it, ``CUDA_HOME`` an empty
   directory), loads all 11 from the store
   (``tpu_compile_cache_hits_total{kind="persistent"}`` = 11, no nvcc
   build), ``restore_from``s the snapshot, and runs the vote round (all
   K2 hits), phase 6's pinned block (one K2 launch) and phase 5's block
   (one K1 launch), each equal to the integer ECDSA; each prints its time
   to the first verdict. Then the two libraries nvcc made fastest are
   poisoned (one truncated, one byte flipped) in two copies of the
   store: a process with nvcc counts one ``truncated`` and one
   ``corrupt`` reject, rebuilds those two, loads 9 and gives the same
   verdicts; a process without nvcc must raise (its exit code and
   message read here). Meanwhile this process, with
   ``BDLS_TPU_PROFILE_DIR`` set, captures phase 5's block batch (K1) and
   ``verify_block`` (K7) under ``torch.profiler``: two captures, the
   traces naming both kernels, and the five device operations that took
   the most time; ``pending_cap`` 2 around real K1 launches under both
   policies; and ``chaos_stall_s`` 0.05 on two K3 quorum rounds of 85
   votes: the same verdicts, each at least the stall late, flushes back
   at once, ``max_inflight`` 2 or more;
6h. the verification daemon on the card (``bdls_tpu_torch.sidecar``):
   ``VerifydServer(transport="socket")`` in process with its provider
   from the factory (``TorchCSP`` on the card, the key cache on, every
   pair warmed) and port ``RemoteCSP`` clients: two tenants behind a
   barrier send half of phase 5's 2000-lane P-256 batch each, one lane
   with a 33-byte sig_r among them, and meet in one flush (a 100 ms
   window; one K1 launch, ``multi_tenant_buckets`` >= 1); the 128
   envelopes of phase 6 through ``CspBatchVerifier(RemoteCSP)`` once the
   daemon's stats frame lists the 128 consenters warmed by warm frames
   (lane_hint 85: a quorum flush, one K2 launch and one for the
   outsider); 85 votes through a second daemon over
   ``TorchCSP(key_cache_size=0)`` (one K3 replay); ``verify_block`` of
   phase 6b's block (one K7 launch, the host oracle's flags); the
   committee of 128 and 2 certificates, one forged, as raw frames (one
   launch of each K9 kernel); a daemon with watermarks (0, 0, 0) sheds a
   firehose batch (a SHED frame with its retry hint, the client's
   fallback counted as ``shed``) and not a vote batch, and answers an
   oversized frame and closes; ``stop()`` (the next batch falls back,
   counted ``disconnected``), a successor on the same port restores the
   warm snapshot (the 128 consenters at least) and the clients
   reconnect, the seam client's rewarm sending 0 keys and skipping 128;
   the daemon in a process of its own (``python3 -m
   bdls_tpu_torch.cli.main verifyd`` over phase 2's store: its JSON line,
   the vote round and the 2000-lane batch exact, SIGINT, exit 0); then
   the round trips (vote round, 2000-lane batch, ``verify_block``, the
   certificate pair) in turns with the same calls on the daemon's own
   ``TorchCSP`` in process, median of 9, and the codec's encode and
   decode times of the 2000-lane and the block frames. Every client
   outside the overload and death checks ends with no fallback, every
   daemon with no flush error. The daemons serve the operations endpoint
   (``ops_port=0``): after the round trips the successor's ``/healthz``
   answers 200, its ``/metrics`` holds ``verifyd_requests_total`` for the
   firehose tenant and the card provider's ``tpu_verify_*``, its
   ``/debug/slo`` binds ``coalesced_bucket_floor`` and
   ``sidecar_queue_wait_p99`` and its ``/debug/tsdb`` has a sample of
   ``verifyd_requests_total``; the CLI daemon runs with ``--ops-port 0``,
   its line names the port and its ``/healthz`` answers;
6i. the BDLS consensus engine deciding heights through the card
   (``bdls_tpu_torch.consensus``): ``rounds.build_net`` of 128
   validators (``BASELINE.json`` config 4, a signature a vote), one
   ``CacheVerifier`` a node over one shared cache, each node's misses
   sent to the card verifier ``CspBatchVerifier(TorchCSP(),
   consenters=participants)`` (device ``None``: the card), which is also
   the pre-pass sidecar of ``rounds.run_rounds``, driven to 2 decided
   heights (else a failure after 60 virtual or 240 wall seconds); then 4
   validators (config 2's shape) to 10 heights the same way. Checked in
   each: every node at the height with one state a height, the first
   batch lane for lane against ``cpu_verify_envelope``, every miss
   verified on the card and each a node's own loopback message, K2
   launched, an envelope with its ``sig_s`` flipped False in a card batch
   and ``ErrMessageSignature`` from ``node.receive_message``. Printed:
   virtual s a height, wall s, wall verify s a height, batch calls,
   batched signatures, the largest batch, cache hits and misses,
   ``verify_fits_round``, each build's launches and ``slo.evaluate``'s
   ``round_latency_p99`` over the run's ``engine.height`` spans, printed
   as ``sim_host_s_per_height_p99``: those spans time the host clock of
   the whole one-process simulation, not a round;
6j. the transaction flow at ``BASELINE.json`` config 3
   (:mod:`bdls_tpu_torch.models.txflow`, the reference's
   ``tests/test_gateway.py`` assembly; the workload and its hostile
   transactions from ``tests/_txflow_workload.py``): 32 validators, one
   ``Chain`` each on a seeded ``VirtualNetwork`` with a ``MemoryLedger`` and
   ``BatchConfig(max_message_count=1000)``, every chain sharing one
   ``CspBatchVerifier(TorchCSP(), consenters=participants)``; two peers
   (org1, org2) with an MSP of them and the client and
   ``EndorsementPolicy(required=2)``, the same ``TorchCSP`` serving
   them and the gateway. The gateway submits 1,000 ``kvput``
   transactions with explicit tx ids, 1 in 100 hostile (an endorsement's
   ``sig_s`` flipped, an endorser the MSP does not know, a duplicate tx
   id, an undecodable payload), then the network runs until both peers
   have committed the 1000-tx block (else a failure after 60 virtual or
   400 wall seconds; depth cut from two blocks to one). Launch counts
   are set to 0 just before the first submit and read after the last
   commit. Checked: every peer's flags equal the
   port's ``TxValidator`` over ``SwCSP`` on the same block bytes and the
   flag each transaction was built to get; both peers' KV states equal
   the honest writes; all 32 orderer ledgers hold the same block bytes;
   K7 launched once a committed block on each peer and
   ``tpu_block_blocks_total`` agrees; no provider or block fallback.
   Printed: heights decided, virtual s a height, wall s, transactions
   committed a second from the first submit to the last commit (host
   clock), each block's ``commit_block`` wall ms beside K7's CUDA-event
   ms, and the launches of K1, K2, K3 and K7;
6k. config 2 through the orderer node (:func:`drive_orderer`;
   ``BASELINE.json`` config 2, 4 BDLS validators, one channel, an
   empty-tx firehose): four ``OrdererNode``s in one process, each with
   its own ``TorchCSP()``, no verifier (the engines verify on the card)
   and a ``FileLedger``, over the port's authenticated cluster on
   loopback TCP, ``make_channel_config``'s batch defaults (500
   messages, 2 s timeout); 2,000 transactions of the reference test's
   ``make_tx`` shape signed before the window, 1 in 100 with a flipped
   ``sig_s`` bit, 1 in 200 from an org that may not write, broadcast
   round-robin from one client thread a running node once the mesh has
   formed; node 3 joins after block 2 and must pull the blocks it
   missed (their proofs checked by its engine), then consent. A
   failure after 120 s. Launch counts set to 0 just before the first
   broadcast and read after the last commit. Checked: the four ledgers
   byte-equal, every valid transaction once, every hostile broadcast
   refused with ``ErrBadSignature`` / ``ErrPolicyViolation``, no
   ``auth_fail`` and no failed tag, K1 or K2 launched, no provider
   fallback, the late joiner's pulls and consensus frames after them,
   and the host AES-256-GCM against ``tests/aes_gcm_kat.json``. Printed:
   valid tx a second (first broadcast to the last commit on the slowest
   node, host clock), broadcast and submit-to-commit ms (median, p99),
   the blocks, the catch-up, the frames and bytes sealed and AES-GCM's
   MB/s (in the run, and alone on a 32 MB frame), the launches and node
   0's ``consensus_bdls_*`` gauges, each chain's relays
   (sent, refused, sent again) and each cluster's refused sends and
   router errors. ``python3 chip_smoke.py --phase 6k`` runs phase 1, the
   build and this phase alone;
6l. config 3's blocks through a gossiping peer network
   (:func:`drive_peer_plane`): ``BASELINE.json`` config 3 at its
   published widths, 1000-tx blocks of ``kvput`` transactions, each
   endorsed by org1 and org2 with P-256 keys, 1 in 100 hostile (the four
   kinds of ``tests/_txflow_workload.py``, as 6j), built before the
   window as 6j's gateway builds them, chained with ``make_block`` and
   served by an orderer stand-in (a block list revealed step by step):
   ordering has its own phases, 6j and 6k. The endorsement policy is
   Fabric's sample ``configtx.yaml`` application default, ``ImplicitMeta
   "MAJORITY Endorsement"`` over ``org1.member`` and ``org2.member``;
   the gossip knobs are Fabric's sample ``core.yaml`` ``peer.gossip``
   defaults: ``propagatePeerNum`` 3 as the fanout,
   ``aliveTimeInterval`` 5 s, ``aliveExpirationTimeout`` 25 s and
   ``election.leaderElectionDuration`` 5 s. Fabric's ``integration/nwo``
   standard networks have 2 peer orgs; each has 4 peers here, so that a
   fanout of 3 does not reach every peer in one hop and both push and
   state transfer run. 8 ``PeerNode``s, each with its own ``TorchCSP()``
   and P-256 key in the channel MSP, a ``GossipNode`` and a
   ``DiscoveryNode``; only each org's peer0 has the orderer source, and
   every peer bootstraps to org1 peer0. A virtual clock of 0.25 s a
   step ticks every node; verification and commits are real. 1: seven
   peers start (org2 peer3 waits) until every view holds the other six
   and one leader leads (org2 peer0, the smaller eligible identity);
   then a tampered alive message and one from a key outside the MSP;
   2: blocks 1 and 2 revealed, until all seven are at height 3; 3: the
   leader goes offline; 4: block 3 revealed, until org1 peer0 leads and
   every online peer is at height 4; 5: org1 peer1 exports a snapshot,
   org2 peer3 starts from it (``bootstrap_from_snapshot``), joins
   through org1 peer0 and is at height 4; the old leader comes back and
   catches up by one anti-entropy round. The same timeline runs first on
   ``SwCSP`` over blocks of one transaction, host only, for the
   verdict each receiver gives each alive message. Launch counts are
   set to 0 just before step 1 and read after step 5. Checked: the 8
   ledgers and KV states equal at height 4 (the joiner's from its
   anchor), the flags as built, every alive decision equal to the host
   run's, both hostile alive messages refused, one failover (org2 peer0,
   then org1 peer0), no replay by the joiner, some blocks by push and
   some by state transfer, K1 or K2 and K7 launched, K7 once a commit,
   no provider fallback; on org1 peer1's provider the ImplicitMeta
   policy's verdict on each VALID or ENDORSEMENT_POLICY_FAILURE
   transaction of block 1 equals its committed flag, and the layout
   ``DiscoveryService.endorsement_descriptor`` names satisfies it; block
   1's write-sets again through an ``Endorser`` over an
   ``ExternalContract`` (the ``kvput`` contract in a child process)
   are byte-equal. Printed: each stage's wall s, each block's
   ``commit_block`` ms on the peers (median, max) and K7's CUDA-event
   ms, the alive checks (count, launches, ms a check median and p99),
   the policy's ms a transaction, the gossip and membership ``stats``,
   the snapshot's bytes and the joiner's time to height 4.
   ``python3 chip_smoke.py --phase 6l`` runs phase 1, the build and
   this phase alone;
7. timing with CUDA events after warm-up: each kernel's ms and
   verifies/s at buckets 128, 2048 and 8192 (the batches of phases 3 and
   4, tiled, verdicts checked; K2 also against its plain version at 128,
   2048 and 8192 for both curves, and timed in turns with K1's group body
   on the same lanes), the provider's end-to-end verifies/s at 8192, the
   vote round through the seam and the pinned block batch with the key
   cache on and off in turns, the key cache's lookup of that block (of
   its requests, of their keys) and its identifiers hashed without the
   memo, and the plain versions' times, with each kernel's bound
   (:func:`needed_muls`, :func:`needed_muls_pinned`);
   K6 at the main block's shape (2048 lanes, NB 16), its first 128
   lanes, the main block tiled four times (8192) and the uniform batch,
   each with the ns a round on its longest lane, its plain twin and
   bound (:func:`sha_bound_ms`); K7 at the main shape and on secp256k1,
   with its plain twin and bound (:func:`block_bound_ms`), and
   9 ``verify_block`` calls against 9 lane-at-a-time calls (hashlib plus
   K1), in turns; a K3 replay against an eager K1 launch at buckets 85,
   128 and 171, and the quorum's submit-to-verdict median of 9 rounds
   with the latency tier on and off, in turns; K8 at 128, 2048 and 8192
   lanes with its bound (:func:`needed_muls_ed25519`), equal to its plain
   twin at 8192; K9's two
   launches at 1, 2, 16 and 128 certificates (phase 3d's twisted lanes,
   as the kernel's classifier reads them, tiled) with their bounds (:func:`k9_bound_ms`), and the Miller launch
   on all-dense batches (every signature forged off the twist's image)
   of 1 and 2 certificates; 7f: K4 and the mxu builds of K1, K2 and K8 at
   128, 2048 and 8192 lanes, K7 + K5 at the main block shape, each with
   the bound of the function it computes, and K5's product alone (65,536
   products) beside the CIOS build, its plain twin and one float64
   ``torch.matmul`` of the plain twin's contraction, and K5's call's
   latency (one warp, 4,096 dependent calls, ``bdls_field_chain``) beside
   the vpu bodies' product on each thread; 7g: K11 at 1, 2, 16
   and 128 certificates with its bound (:func:`k11_bound_ms`), the K10
   split (two shards of one card) against the unsplit K1 at 2048 and
   8192 lanes in turns with its bound (:func:`split_bound_ms`), and the
   shard launch with its count against the same launch without it and
   against K1 + ``(ok & mask).sum()``, in turns, at 1024 lanes (a shard
   of the main path's 2048 bucket), 2048 and 8192 (K1), and K2's at
   1024;
8. the run's wall time and its seconds by phase (``phase_seconds``), one
   ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Everything is made from fixed seeds. Results also go to
``build/chip_smoke.json``, with the hand counts of the kernels' work
under ``static_counts`` (:func:`static_counts`): the ``kernels`` line
carries only what the run measured, its launch counts and its bounds.
"""

from __future__ import annotations

import faulthandler
import gc
import hashlib
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
BUCKETS = (128, 2048, 8192)
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
SMS = 132
# 32-bit integer multiply (and multiply-add) results per clock per SM,
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table)
IMUL_PER_CLK_PER_SM = 64
# 32-bit multiply instructions; a widening 32x32->64 product counts as
# two (low and high halves)
MUL = 2 * 64                     # 256 x 256-bit schoolbook product
SQR = 2 * 36                     # 256-bit square: 28 cross products + 8
RED_P = {"P-256": 0,             # Solinas reduction: additions only
         # p = 2^256 - 2^32 - 977: high half times 977, then the carry
         "secp256k1": 2 * 8 + 2}
RED_N = 2 * 64 + 8               # Montgomery reduction mod the order n
# one 8x32-bit CIOS Montgomery product as the kernel does it: 8 rounds
# of 8 widening a·b products, one q = t0·n0 and 8 widening q·m products
MUL32_PER_MONT = 8 * (8 * 2 + 1 + 8 * 2)
LIMB_BYTES_PER_LANE = 5 * 16 * 4   # five (16, B) int32 arrays
G_TABLE_BYTES = 256 * 3 * 8 * 4
MAIN_BUCKET = {"secp256k1": 128, "P-256": 2048}
# bytes of one pinned lane's inputs and output: r, s, e as (16, B)
# int32, the int32 slot, one verdict byte
PINNED_LANE_BYTES = 3 * 16 * 4 + 4 + 1
ENTRY_BYTES = 2 * 8 * 4          # an affine table entry: x and y


def log(*a):
    print(*a, flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def mont_muls_per_verify(curve) -> int:
    """Montgomery products one lane of csrc/verify_group.cuh (K1's and
    K7's vpu builds) performs, the kernel's own work: r, r + n and Q
    into Montgomery form mod p, s^-1 (a binary inverse: no product) into
    it mod n, y^2, x^2, x^3, u1, u2; the [2..8]·Q table (4 doublings, 3
    additions); on secp256k1 the 9 β·X of ψ(Q)'s table; u2·Q (P-256: 256
    doublings, 65 additions; secp256k1: 132 and 68, the GLV halves);
    u1·G (32 additions), the join, X == r·Z and X == (r + n)·Z. A
    doubling is 9 products (a = 0) or 13 (a = -3), an addition 14."""
    dbl, add = (9, 14) if curve.a_kind == "zero" else (13, 14)
    ladder = (132 * dbl + 68 * add + 9 if curve.a_kind == "zero"
              else 256 * dbl + 65 * add)
    return 10 + 4 * dbl + 3 * add + ladder + 33 * add + 2


def mont_muls_per_verify_thread(curve) -> int:
    """Montgomery products one lane of csrc/verify.cuh:verify_lane (the
    mxu builds' one-thread body) performs, dead first ladder step
    included."""
    dbl, add = (9, 14) if curve.a_kind == "zero" else (13, 14)
    fermat = 256 + bin(curve.fn.modulus - 2).count("1")
    return (1 + fermat + 2            # s to Montgomery, s^-1, u1, u2
            + 2 + 3                   # Q to Montgomery, on-curve check
            + dbl + 6 * add           # [2..8]·Q table
            + 33 * (8 * dbl + 3 * add)  # the dual ladder
            + 4)                      # X == r·Z and X == (r + n)·Z


def needed_muls(curve, lanes) -> float:
    """32-bit multiplies that verifying ``lanes`` in one launch needs, at
    the least work known for the function, not this kernel's choices:

    - Jacobian formulas of the Explicit-Formulas Database (dbl-2001-b for
      a = -3, dbl-2009-l for a = 0, add-2007-bl, madd-2007-bl with the G
      table affine): no multiply by b;
    - special-form reduction mod p, Montgomery mod n;
    - one Fermat inverse per launch and 3 products a lane (the batch
      inverse of s, as the reference's ``fold.batch_inv`` does);
    - P-256: 64 signed 4-bit windows of u2 (256 doublings) and 32 bytes
      of u1; secp256k1: the reference's GLV ladder (``dual_ladder_glv``),
      two 132-bit halves (132 doublings, 66 windows, a psi(Q) table) and
      32 positioned G bytes that are never doubled;
    - a zero window or byte needs no add: 1/16 of windows and 1/256 of
      bytes, the rate for uniform scalars;
    - a lane outside [1, n) or off the curve needs no ladder; the
      r + n product only where r + n < p.
    """
    name, p, n = curve.name, curve.fp.modulus, curve.fn.modulus
    mp, sp = MUL + RED_P[name], SQR + RED_P[name]
    mn, sn = MUL + RED_N, SQR + RED_N
    dbl = (3 if name == "P-256" else 2) * mp + 5 * sp
    add = 11 * mp + 5 * sp
    madd = 7 * mp + 4 * sp
    table = dbl + 6 * add                   # [2..8]·Q
    if name == "P-256":
        ladder = 256 * dbl + 64 * 15 / 16 * add + 32 * 255 / 256 * madd
    else:
        ladder = (2 * MUL + 4 * 2 * 16      # GLV split of u2
                  + 8 * mp                  # psi(Q) table: beta·X
                  + 132 * dbl + 66 * 15 / 16 * add
                  + 32 * 255 / 256 * madd + add)
    per_lane = 5 * mn + table + ladder + sp + mp   # ... X == r·Z^2
    total = (bin(n - 2).count("1") - 1) * mn + 255 * sn
    for qx, qy, r, s, _, _ in lanes:
        if not (qx < p and qy < p and (qx, qy) != (0, 0)
                and 0 < r < n and 0 < s < n):
            continue
        total += 2 * sp + mp                # y^2 == x^3 + a·x + b
        if (qy * qy - qx ** 3 - curve.a * qx - curve.b) % p:
            continue
        total += per_lane + (mp if r + n < p else 0)
    return total


def _pinned_work(curve, r, s, e):
    """Nonzero table entries one pinned lane adds: (Q entries as
    (half, position, digit) keys, G bytes as (position, byte) keys)."""
    from bdls_tpu_torch.ops import glv

    n = curve.fn.modulus
    w = pow(s, -1, n)
    u1, u2 = e * w % n, r * w % n
    g = [(j, (u1 >> (8 * j)) & 0xFF) for j in range(32)
         if (u1 >> (8 * j)) & 0xFF]
    if curve.name == "secp256k1":
        halves, nd = [abs(k) for k in glv.decompose_host(u2)], 33
    else:
        halves, nd = [u2], 64
    q = []
    for h, k in enumerate(halves):
        wd = k + sum(8 << (4 * i) for i in range(nd))
        for i in range(nd + 1):
            nib = (wd >> (4 * i)) & 0xF
            mag = abs(nib - 8) if i < nd else nib
            if mag:
                q.append((h, i, mag))
    return q, g


def needed_muls_pinned(curve, lanes) -> float:
    """32-bit multiplies that verifying ``lanes`` through pinned tables
    in one launch needs, at the least work known, not this kernel's
    choices: no doublings; one mixed addition (madd-2007-bl) per nonzero
    Q entry (at most 68 on secp256k1, 66 on P-256) and per nonzero byte
    of u1 (32 positioned G tables), all entries affine, the first entry
    loaded for free; the GLV split of u2 on secp256k1; one Fermat
    inverse per launch and 3 products a lane (the batch inverse of s),
    u1 and u2; X == r·Z, and (r + n)·Z where r + n < p. Lanes outside
    [1, n) need no ladder. The digits are counted from these lanes'
    scalars. ``lanes`` are (r, s, e) ints."""
    name, p, n = curve.name, curve.fp.modulus, curve.fn.modulus
    mp, sp = MUL + RED_P[name], SQR + RED_P[name]
    mn = MUL + RED_N
    madd = 7 * mp + 4 * sp
    split = 2 * MUL + 4 * 2 * 16 if name == "secp256k1" else 0
    total = (bin(n - 2).count("1") - 1) * mn + 255 * (SQR + RED_N)
    memo = {}
    for r, s, e in lanes:
        if not (0 < r < n and 0 < s < n):
            continue
        if (r, s, e) not in memo:
            q, g = _pinned_work(curve, r, s, e)
            adds = max(len(q) + len(g) - 1, 0)
            memo[r, s, e] = (5 * mn + split + adds * madd + mp
                             + (mp if r + n < p else 0))
        total += memo[r, s, e]
    return total


def pinned_bound_ms(curve, lanes, slots,
                    sm_clock_hz: float) -> tuple[float, str]:
    """The pinned kernel's bound: the larger of the multiplies over the
    card's multiply rate and the bytes over its memory rate. Bytes: each
    lane's inputs and verdict, and each table entry the batch needs,
    read once."""
    t_ops = needed_muls_pinned(curve, lanes) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    entries = set()
    for (r, s, e), slot in set(zip(lanes, slots)):
        n = curve.fn.modulus
        if 0 < r < n and 0 < s < n:
            q, g = _pinned_work(curve, r, s, e)
            entries.update((slot,) + k for k in q)
            entries.update(g)
    t_bytes = (PINNED_LANE_BYTES * len(lanes)
               + ENTRY_BYTES * len(entries)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pinned_kernel_muls(curve) -> int:
    """32-bit multiplies one lane of csrc/pinned_group.cuh (K2's vpu
    build) issues: r·R, (r + n)·R and s^-1·R into Montgomery form (the
    inverse is a binary Euclid: no product), u1 and u2; 99 (secp256k1)
    or 96 (P-256) complete additions of 14 products, the chains' and the
    join's (100 or 97 entries, each chain starting as its first); X ==
    r·Z and X == (r + n)·Z; the GLV split on secp256k1."""
    nadd = 99 if curve.a_kind == "zero" else 96
    split = (2 * 64 * 2 + 2 * 20 * 2) if curve.a_kind == "zero" else 0
    return (3 + 2 + nadd * 14 + 2) * MUL32_PER_MONT + split


def bound_ms(curve, lanes, sm_clock_hz: float) -> tuple[float, str]:
    t_ops = needed_muls(curve, lanes) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = (LIMB_BYTES_PER_LANE * len(lanes) + len(lanes)
               + G_TABLE_BYTES) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, launches: int = 32, replays: int = 8) -> float:
    """``fn``'s launches captured into one CUDA graph and replayed: the
    time a launch takes on the device with no host between launches, by
    CUDA events over the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays) / launches


def make_pinned_inputs(sw, rng) -> dict:
    """The K2 main path's inputs: 128 consenter keys and 128 envelopes
    of one vote round (127 consenters vote, 2 of them forged, and one
    key outside the set), and a 1000-tx x 2-endorsement block from 16
    endorsers (a few tampered)."""
    from bdls_tpu_torch.consensus.identity import identity_of_key, \
        sign_payload
    from bdls_tpu_torch.crypto.csp import VerifyRequest

    consenters = [sw.key_gen("secp256k1", rng) for _ in range(128)]
    outsider = sw.key_gen("secp256k1", rng)
    envs, env_ok = [], []
    for v, key in enumerate(consenters[:127]):
        env = sign_payload(key, b"<lock> height 42 round 7 from %d" % v)
        forged = v % 61 == 7
        if forged:
            env.payload += b" (forged)"
        envs.append(env)
        env_ok.append(not forged)
    envs.append(sign_payload(outsider, b"<lock> height 42 round 7"))
    env_ok.append(True)
    endorsers = [sw.key_gen("P-256", rng) for _ in range(16)]
    block, block_ok = [], []
    for tx in range(1000):
        digest = sw.hash(b"tx-%d" % tx + rng.bytes(16))
        for j in range(2):
            key = endorsers[(2 * tx + j) % len(endorsers)]
            r, s = sw.sign(key, digest)
            tampered = tx % 97 == 5 and j == 1
            d = sw.hash(b"forged") if tampered else digest
            block.append(VerifyRequest(key.public_key(), d, r, s))
            block_ok.append(not tampered)
    return {"idents": [identity_of_key(k) for k in consenters],
            "outsider": outsider.public_key(), "envs": envs,
            "env_ok": env_ok,
            "endorsers": [k.public_key() for k in endorsers],
            "block": block, "block_ok": block_ok}


def _envelope_lane(env) -> tuple:
    from bdls_tpu_torch.consensus.identity import envelope_digest

    d = envelope_digest(env.version, env.pub_x, env.pub_y, env.payload)
    return (int.from_bytes(env.pub_x, "big"), int.from_bytes(env.pub_y, "big"),
            int.from_bytes(env.sig_r, "big"), int.from_bytes(env.sig_s, "big"),
            d, "main path")


def _pinned_args(lanes, slots, dev):
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs

    cols = vectors.columns(lanes)[2:]
    args = [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in cols]
    return args + [torch.tensor(slots, dtype=torch.int32, device=dev)]


def check_pinned_kernel(pin, rng, dev) -> dict:
    """Phase 4: per curve, K2 on the card against its plain version on
    the same inputs, lane for lane, and against the integer ECDSA, at the
    main path's bucket (phase 7 holds it at the other buckets)."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey
    from bdls_tpu_torch.crypto.key_cache import KeyTableCache
    from bdls_tpu_torch.ops import ecdsa, glv
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import build_pinned_tables, \
        verify_fold_pinned

    def pinnable(curve, lane):
        try:
            build_pinned_tables(curve, lane[0], lane[1])
            return True
        except ValueError:
            return False

    from bdls_tpu_torch.consensus.verifier import identity_keys

    # the main path's requests and its whole key set, pinned
    fills = {
        "secp256k1": ([_envelope_lane(e) for e in pin["envs"][:127]],
                      pin["env_ok"][:127], identity_keys(pin["idents"])),
        "P-256": ([(q.key.x, q.key.y, q.r, q.s, q.digest, "main path")
                   for q in pin["block"]], pin["block_ok"], pin["endorsers"]),
    }
    out = {}
    for curve_name, cv in CURVES.items():
        n = cv.fn.modulus
        mixed = [ln for ln in vectors.mixed_lanes(curve_name, rng)
                 + vectors.zero_byte_lanes(curve_name, rng)
                 if pinnable(curve_name, ln)]
        valid = next(ln for ln in mixed if ln[5] == "valid")
        other = next(ln for ln in mixed if ln[:2] != valid[:2])
        reqs, oks, key_set = fills[curve_name]
        k = MAIN_BUCKET[curve_name] - len(mixed) - 1
        idx = [i % len(reqs) for i in range(k)]
        lanes = mixed + [valid[:5] + ("under another key's slot",)] + [
            reqs[i] for i in idx]
        want = (vectors.expected(curve_name, mixed) + [False]
                + [oks[i] for i in idx])
        cache = KeyTableCache(256, device=dev)
        keys = [PublicKey(curve_name, ln[0], ln[1]) for ln in lanes]
        cache.warm(list(dict.fromkeys(key_set + keys)), wait=True)
        slots, pools = cache.lookup_batch(curve_name, keys)
        slots[len(mixed)] = cache.lookup_batch(
            curve_name, [PublicKey(curve_name, *other[:2])])[0][0]
        args = _pinned_args(lanes, slots, dev)
        kern = ecdsa.verify_pinned_cuda(cv, *args, pools).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = verify_fold_pinned(cv, *args, pools).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: K2 vs plain on {len(lanes)} lanes "
            f"({len(mixed) + 1} mixed, {len(cache)} keys pinned): "
            f"{int(diff.sum())} differ {bad}; valid {int(kern.sum())}; "
            f"plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: K2 disagrees with plain")
        if not np.array_equal(kern, np.array(want)):
            raise SystemExit(f"{curve_name}: K2 disagrees with SwCSP")
        if curve_name == "secp256k1" and not any(
                min(glv.decompose_host(ln[2] * pow(ln[3], -1, n) % n)) < 0
                for ln, ok in zip(lanes, want) if ok):
            raise SystemExit("no valid lane has a negative GLV half")
        # the generic verdicts (K1's): the lane under another key's slot
        # is a valid signature
        generic = np.array(want)
        generic[len(mixed)] = True
        out[curve_name] = {
            "lanes": lanes, "slots": slots, "want": np.array(want),
            "generic": generic,
            "pools": pools, "cache": cache, "keys": len(cache),
            "max_abs_err": int(diff.max()), "plain_ms": plain_ms}
    return out


def drive_pinned_main_path(pin):
    """Phase 6: the consensus vote round through CspBatchVerifier over
    TorchCSP with its key cache, twice, then the pinned block batch.
    Counts are set to 0 just before each run and read just after."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        TorchBatchVerifier, identity_keys
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    verifier = CspBatchVerifier(csp, consenters=pin["idents"])
    csp.warm_keys(identity_keys(pin["idents"]), wait=True)
    csp.warm_keys(pin["endorsers"], wait=True)
    none = {"P-256": 0, "secp256k1": 0}
    k1_only = {"P-256": 0, "secp256k1": 1}

    def run(what, fn, want):
        before = csp.stats["pinned_lanes"]
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t) * 1e3
        k1, k2 = dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED)
        lanes = csp.stats["pinned_lanes"] - before
        log(f"{what}: {ms:.2f} ms, {lanes} pinned lanes, K1 launches {k1}, "
            f"K2 launches {k2}")
        if got != want:
            raise SystemExit(f"{what}: verdicts differ from construction")
        return {"ms": ms, "pinned_lanes": lanes, "k1": k1, "k2": k2}

    envs, env_ok = pin["envs"], pin["env_ok"]
    first = run("vote round through the seam, 128 envelopes, one new key",
                lambda: verifier.verify_envelopes(envs), env_ok)
    if (first["pinned_lanes"], first["k1"], first["k2"]) != (
            127, k1_only, k1_only):
        raise SystemExit(f"first vote round: {first}")
    deadline = time.time() + 60
    while (not csp.key_cache.contains(pin["outsider"])
           and time.time() < deadline):
        time.sleep(0.01)
    second = run("second vote round, the new key pinned in the background",
                 lambda: verifier.verify_envelopes(envs), env_ok)
    if (second["pinned_lanes"], second["k1"], second["k2"]) != (
            128, none, k1_only):
        raise SystemExit(f"second vote round: {second}")
    if TorchBatchVerifier(device="cuda").verify_envelopes(envs) != env_ok:
        raise SystemExit("TorchBatchVerifier: verdicts differ")
    block = run(f"block batch, {len(pin['block'])} lanes from 16 pinned "
                f"endorsers", lambda: csp.verify_batch(pin["block"]),
                pin["block_ok"])
    if (block["pinned_lanes"], block["k1"], block["k2"]) != (
            len(pin["block"]), none, {"P-256": 1, "secp256k1": 0}):
        raise SystemExit(f"pinned block batch: {block}")
    if csp.stats["fallbacks"] != 0:
        raise SystemExit(f"K2 main path: fallbacks {csp.stats}")
    summary = {"vote_round_first": first, "vote_round_second": second,
               "block_batch": block,
               "launches": {"secp256k1": first["k2"]["secp256k1"],
                            "P-256": block["k2"]["P-256"]},
               "key_cache": csp.stats["key_cache"]}
    return summary, (csp, verifier)


def time_pinned(pinned, summary, live, pin, sm_clock_hz, dev) -> None:
    """Phase 7 for K2: at each bucket, the group body against its plain
    twin lane for lane, then its time in turns with K1's group body on
    the same lanes (K2, K1, K1, K2) and its bound; the plain version at
    bucket 8; the vote round through the seam and the pinned block batch
    with the key cache on and off, in turns; and the key cache's lookup
    of the block's requests."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold_pinned

    for curve_name, cv in CURVES.items():
        res = pinned[curve_name]
        lanes, slots, want = res["lanes"], res["slots"], res["want"]
        generic = res["generic"]
        rse = [(ln[2], ln[3], int.from_bytes(ln[4], "big")) for ln in lanes]
        res["needed_muls_per_lane"] = needed_muls_pinned(cv, rse) / len(rse)
        res["buckets"] = {}
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            args = _pinned_args([lanes[i] for i in idx],
                                [slots[i] for i in idx], dev)
            k1_args = lane_args([lanes[i] for i in idx], dev)
            ok = ecdsa.verify_pinned_cuda(cv, *args, res["pools"])
            ok = ok.cpu().numpy()
            if not np.array_equal(ok, want[idx]):
                raise SystemExit(f"{curve_name} K2 B={b}: verdicts differ")
            # every bucket, both curves, lane for lane
            plain = verify_fold_pinned(cv, *args, res["pools"])
            if not np.array_equal(ok, plain.cpu().numpy()):
                raise SystemExit(f"{curve_name} K2 B={b}: kernel "
                                 f"disagrees with plain")
            k1_ok = ecdsa.verify_fold_cuda(cv, *k1_args).cpu().numpy()
            if not np.array_equal(k1_ok, generic[idx]):
                raise SystemExit(f"{curve_name} K1 on K2's lanes B={b}: "
                                 "verdicts differ")
            reps = 20 if b <= 2048 else 10

            def k2():
                return ecdsa.verify_pinned_cuda(cv, *args, res["pools"])

            def k1():
                return ecdsa.verify_fold_cuda(cv, *k1_args)

            turns = [cuda_ms(fn, reps) for fn in (k2, k1, k1, k2)]
            ms, k1_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            bms, by = pinned_bound_ms(cv, [rse[i] for i in idx],
                                      [slots[i] for i in idx], sm_clock_hz)
            res["buckets"][b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                                 "bound_ms": bms, "bound_by": by,
                                 "bound_share": bms / ms,
                                 "k2_ms": [turns[0], turns[3]],
                                 "k1_same_lanes_ms": [turns[1], turns[2]],
                                 "k2_over_k1": ms / k1_ms}
            log(f"{curve_name} K2 B={b}: kernel {turns[0]:.3f} / "
                f"{turns[3]:.3f} ms, K1 on the same lanes {turns[1]:.3f} / "
                f"{turns[2]:.3f} ms (in turns; K2/K1 {ms / k1_ms:.2f}); "
                f"{b / ms * 1e3:,.0f} verifies/s, bound {bms:.4f} ms "
                f"({by}, {bms / ms:.2%} of the kernel time), equal to plain")
        args8 = _pinned_args(lanes[:8], slots[:8], dev)
        t0 = time.perf_counter()
        verify_fold_pinned(cv, *args8, res["pools"])
        torch.cuda.synchronize()
        res["plain_ms_bucket8"] = (time.perf_counter() - t0) * 1e3
        log(f"{curve_name} K2: plain {res['plain_ms']:.0f} ms at "
            f"B={MAIN_BUCKET[curve_name]}, {res['plain_ms_bucket8']:.0f} ms "
            f"at B=8")
        res["cache"].close()

    csp, verifier = live
    envs, env_ok = pin["envs"], pin["env_ok"]

    def rounds(ver, n=9):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            if ver.verify_envelopes(envs) != env_ok:
                raise SystemExit("vote round: verdicts differ")
            out.append((time.perf_counter() - t) * 1e3)
        return sorted(out)

    # the cache off and the latency tier off: K1's eager launch against
    # K2, as in earlier runs (phase 7c times the tier); in turns, a round
    # of each, the order swapped every round
    off_csp = TorchCSP(device="cuda", key_cache_size=0,
                       use_cpu_fallback=False, flush_interval=1.0,
                       latency_max_lanes=0)
    off_csp.warmup([("secp256k1", 128), ("P-256", 2048)])
    off_verifier = CspBatchVerifier(off_csp)
    rounds(off_verifier, 1)
    ecdsa.reset_launches()
    on, off = [], []
    for i in range(9):
        pair = ((verifier, on), (off_verifier, off))
        for ver, got in (pair if i % 2 == 0 else pair[::-1]):
            got += rounds(ver, 1)
    on.sort()
    off.sort()
    seam_launches = (dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED))
    if seam_launches != ({"P-256": 0, "secp256k1": 9},
                         {"P-256": 0, "secp256k1": 9}):
        raise SystemExit(f"vote rounds, cache on and off: launches "
                         f"{seam_launches}, want 9 K2 (on) and 9 K1 (off)")
    # the pinned block batch with the cache on (K2) and off (K1), in
    # turns as the rounds above
    ecdsa.reset_launches()
    blocks, blocks_off = [], []
    for i in range(9):
        pair = ((csp, blocks), (off_csp, blocks_off))
        for c, got in (pair if i % 2 == 0 else pair[::-1]):
            t = time.perf_counter()
            if c.verify_batch(pin["block"]) != pin["block_ok"]:
                raise SystemExit("pinned block batch: verdicts differ")
            got.append((time.perf_counter() - t) * 1e3)
    blocks.sort()
    blocks_off.sort()
    block_launches = (dict(ecdsa.LAUNCHES), dict(ecdsa.LAUNCHES_PINNED))
    off_csp.close()
    if block_launches != ({"P-256": 9, "secp256k1": 0},
                          {"P-256": 9, "secp256k1": 0}):
        raise SystemExit(f"block batches, cache on and off: launches "
                         f"{block_launches}, want 9 K2 (on) and 9 K1 (off)")
    # the cache-on path's own host step, in turns: the key cache's lookup
    # of the block's 2000 requests (their identifiers remembered by
    # csp._ski), the same lookup of their keys, and hashing the 2000
    # identifiers without that memo
    from bdls_tpu_torch.crypto import csp as csp_mod
    hash_ski = csp_mod._ski.__wrapped__
    keys = [q.key for q in pin["block"]]
    warm, keyed, cold = [], [], []
    for _ in range(9):
        t = time.perf_counter()
        csp.key_cache.lookup_batch("P-256", pin["block"])
        warm.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        csp.key_cache.lookup_batch("P-256", keys)
        keyed.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        for k in keys:
            hash_ski(k.x, k.y)
        cold.append((time.perf_counter() - t) * 1e3)
    for got in (warm, keyed, cold):
        got.sort()
    if csp.stats["fallbacks"] != 0:
        raise SystemExit("a fallback happened during K2 timing")
    csp.close()
    summary.update({"vote_round_cache_on_ms": on,
                    "vote_round_cache_off_ms": off,
                    "block_batch_pinned_ms": blocks,
                    "block_batch_cache_off_ms": blocks_off,
                    "block_lookup_ms": warm, "block_lookup_keys_ms": keyed,
                    "block_ski_hash_ms": cold})
    log(f"vote round through the seam, 128 envelopes, in turns: cache on "
        f"median {on[4]:.2f} ms (min {on[0]:.2f}, max {on[-1]:.2f}), 9 K2 "
        f"launches; cache off median {off[4]:.2f} ms (min {off[0]:.2f}, "
        f"max {off[-1]:.2f}), 9 K1 launches")
    log(f"block batch, {len(pin['block'])} lanes from 16 endorsers, in "
        f"turns: cache on median {blocks[4]:.2f} ms (min {blocks[0]:.2f}, "
        f"max {blocks[-1]:.2f}), 9 K2 launches; cache off median "
        f"{blocks_off[4]:.2f} ms (min {blocks_off[0]:.2f}, max "
        f"{blocks_off[-1]:.2f}), 9 K1 launches; the key cache's lookup of "
        f"the block median {warm[4]:.2f} ms (of its keys {keyed[4]:.2f} ms), "
        f"its 2000 identifiers hashed without the memo {cold[4]:.2f} ms")


# 32-bit integer instructions one SHA-256 compression of a 64-byte block
# needs, at the least known for the function, with Hopper's three-input
# add (IADD3) and logic (LOP3) and the funnel-shift rotate (SHF): a round
# takes 6 rotates, 4 logic ops (Σ0, Σ1, Ch, Maj) and 4 adds (T1 of five
# terms in 2, a = T1 + Σ0 + Maj in 1, e = d + T1 in 1); each of the 48
# schedule words 4 rotates, 2 shifts, 2 logic ops and 2 adds; the feed-
# forward 8 adds
SHA_OPS_PER_BLOCK = 64 * (6 + 4 + 4) + 48 * (4 + 2 + 2 + 2) + 8
# 32-bit integer adds, logic ops and shifts per clock per SM, compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table): the same 64 as multiplies
IOP_PER_CLK_PER_SM = 64


def active_blocks(nblocks, NB: int) -> int:
    """512-bit blocks the lanes actually compress."""
    return int(np.minimum(np.maximum(np.asarray(nblocks), 0), NB).sum())


def sha_bound_ms(nblocks, NB: int, sm_clock_hz: float) -> tuple[float, str]:
    """K6's bound: the compressions the lanes need over the integer
    issue rate, against the bytes: the active blocks' words and each
    lane's block count read once, the 32-byte digest written once."""
    blocks = active_blocks(nblocks, NB)
    t_ops = blocks * SHA_OPS_PER_BLOCK / (
        SMS * IOP_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = (64 * blocks + (4 + 32) * len(nblocks)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def limbs_to_ints(a) -> list[int]:
    """(16, L) 16-bit limbs -> L ints."""
    a = np.asarray(a).astype(object)
    return [sum(int(a[k, b]) << (16 * k) for k in range(16))
            for b in range(a.shape[1])]


def block_bound_ms(curve, packed: dict,
                   sm_clock_hz: float) -> tuple[float, str]:
    """K7's bound: the verify multiplies of :func:`needed_muls` on the
    packed lanes (filler lanes fail the curve check and need no ladder)
    plus the SHA-256 work of the active blocks, summed over one 64-a-
    clock issue rate; against the bytes: the active words, the four limb
    arrays, the lane coordinates, the (T, O) mask, required, the flags,
    the verdicts and the G table, each once."""
    cols = [limbs_to_ints(packed[k]) for k in ("qx", "qy", "r", "s")]
    lanes = [(qx, qy, r, s, None, None) for qx, qy, r, s in zip(*cols)]
    NB, _, L = packed["words"].shape
    T, O = packed["org_mask"].shape
    blocks = active_blocks(packed["nblocks"], NB)
    ops = needed_muls(curve, lanes) + blocks * SHA_OPS_PER_BLOCK
    t_ops = ops / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    nbytes = (64 * blocks + 4 * L + 4 * 16 * 4 * L + 2 * 4 * L
              + 4 * T * O + 4 * T + 4 * T + L + G_TABLE_BYTES)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_block_inputs(rng) -> dict:
    """The block lane's inputs: the main path's 1000-tx x 2-endorsement
    P-256 block (4 orgs, 2 endorsers each, one shared preimage of 200-
    1000 bytes a tx, every 97th tx from tx 5 tampered), a hostile block
    of the same shape, and a hostile 50-tx secp256k1 block (128 lanes)."""
    from bdls_tpu_torch.crypto import vectors

    return {
        "main": vectors.block_request("P-256", rng, 1000),
        "P-256": vectors.block_request("P-256", rng, 1000, hostile=True),
        "secp256k1": vectors.block_request("secp256k1", rng, 50,
                                           hostile=True),
    }


def packed_on(packed: dict, dev) -> list:
    from bdls_tpu_torch.ops import _build, block_verify

    return [_build.as_int32(packed[k], dev)
            for k in block_verify.PACKED_KEYS]


def sha_lanes(msgs, n: int) -> list:
    """A K6 batch of ``n`` lanes as (message, block count) pairs: the
    messages, the padding edges (0, 55, 56, 63, 64, 119, 120 and 1015
    bytes), a 16-block message under a count of 99 (clipped to NB 16),
    a filler lane under a count of -1, then zero-count filler lanes."""
    pattern = bytes(range(256)) * 4
    edges = [pattern[:k] for k in (0, 55, 56, 63, 64, 119, 120, 1015)]
    lanes = [(m, None) for m in msgs[:n - 10]] + [(m, None) for m in edges]
    lanes += [(pattern[1:1016], 99), (b"", -1)]
    return lanes + [(b"", 0)] * (n - len(lanes))


def sha_inputs(lanes) -> tuple:
    """(words, nblocks) at NB 16 and, for each lane, the digest K6 must
    give: hashlib's for a lane with blocks (a clipped lane's message has
    16), the IV's big-endian bytes for a count of 0 or less."""
    from bdls_tpu_torch.ops import sha256

    words, nblocks = sha256.pad_messages([m for m, _ in lanes],
                                         max_blocks=16)
    iv = sha256.H0.astype(">u4").tobytes()
    want = []
    for i, (m, count) in enumerate(lanes):
        if count is not None:
            nblocks[i] = count
        want.append(hashlib.sha256(m).digest() if nblocks[i] > 0 else iv)
    return words, nblocks, want


def check_sha256_kernel(blk, rng, dev) -> dict:
    """Phase 4b, K6: against hashlib and its plain version, exactly, at
    128, 2048, 2049 (a last CTA with one live lane) and 8192 lanes (the
    2048 batch tiled four times): the main block's preimages, the padding
    edges, a clipped count, filler lanes of counts 0 and -1; and on the
    uniform batch, 2048 lanes of 16 blocks each. Returns each batch's
    result and the uniform batch's arrays for phase 7b."""
    from bdls_tpu_torch.ops import _build, sha256

    msgs = [ln.msg for ln in blk["main"].lanes]
    tail = rng.bytes(1015)
    batches = {128: sha_lanes(msgs, 128), 2048: sha_lanes(msgs, 2048)}
    batches[2049] = batches[2048] + [(tail, None)]
    batches[8192] = batches[2048] * 4
    batches["uniform"] = [(rng.bytes(int(k)), None)
                          for k in rng.integers(952, 1016, 2048)]
    out = {}
    for name, lanes in batches.items():
        words, nblocks, want = sha_inputs(lanes)
        w, nb = _build.as_int32(words, dev), _build.as_int32(nblocks, dev)
        kern = sha256.sha256_cuda(w, nb).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sha256.sha256_words(w, nb).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        be = kern.view(np.uint32).astype(">u4")
        got = [be[:, i].tobytes() for i in range(len(lanes))]
        bad = [i for i, (g, x) in enumerate(zip(got, want)) if g != x]
        fillers = int((nblocks <= 0).sum())
        same = np.array_equal(kern, plain)
        log(f"K6 vs plain and hashlib at {name} lanes ({len(lanes)} lanes, "
            f"{fillers} filler, longest {int(np.clip(nblocks, 0, 16).max())}"
            f" blocks): {'equal' if same else 'DIFFERS'}"
            f" to plain, {len(bad)} differ from hashlib {bad[:8]}; plain "
            f"{plain_ms:.0f} ms")
        if not same:
            raise SystemExit(f"K6 at {name}: disagrees with its plain "
                             f"version")
        if bad:
            raise SystemExit(f"K6 at {name}: lanes {bad[:8]} disagree with "
                             f"hashlib (or the IV)")
        out[str(name)] = {"lanes": len(lanes), "fillers": fillers,
                          "max_abs_err": 0, "plain_ms_check": plain_ms}
        if name == "uniform":
            out["uniform_arrays"] = (words, nblocks)
    return out


def check_block_kernels(blk, dev) -> dict:
    """Phase 4b: K7 against its plain version, lane for lane and tx for
    tx, on the hostile P-256 block at the main shape and the hostile
    secp256k1 block, and against the host oracle."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import block_lane_screen
    from bdls_tpu_torch.ops import block_verify
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    sw = SwCSP()
    for curve_name in ("P-256", "secp256k1"):
        cv = CURVES[curve_name]
        req = blk[curve_name]
        packed = block_verify.pack_block_request(
            req, lane_ok=block_lane_screen(curve_name))
        ts = packed_on(packed, dev)
        kflags, kvalid = block_verify.verify_block_cuda(cv, *ts)
        kflags, kvalid = kflags.cpu().numpy(), kvalid.cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pflags, pvalid = block_verify.block_kernel(cv, *ts)
        pflags, pvalid = pflags.cpu().numpy(), pvalid.cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        dv = np.abs(kvalid.astype(np.int64) - pvalid.astype(np.int64))
        df = np.abs(kflags.astype(np.int64) - pflags.astype(np.int64))
        host = blocklane.verify_block_host(sw.verify_batch, req)
        NB, _, L = packed["words"].shape
        T, O = packed["org_mask"].shape
        log(f"{curve_name}: K7 vs plain at L {L}, T {T}, NB {NB}, O {O} "
            f"({len(req.lanes)} lanes, {req.ntx} txs): {int(dv.sum())} "
            f"lanes and {int(df.sum() // 2)} txs differ; valid "
            f"{int(kvalid.sum())}, txs valid "
            f"{int((kflags[:req.ntx] == 0).sum())}; plain {plain_ms:.0f} ms")
        if dv.any() or df.any():
            raise SystemExit(f"{curve_name}: K7 disagrees with plain")
        if kflags[:req.ntx].tolist() != host.tolist():
            raise SystemExit(f"{curve_name}: K7 disagrees with the host "
                             f"oracle")
        out[curve_name] = {"packed": packed, "ts": ts,
                           "max_abs_err": int(max(dv.max(), df.max())),
                           "plain_ms": plain_ms,
                           "shape": {"L": L, "T": T, "NB": NB, "O": O}}
    return out


def drive_block_main_path(blk):
    """Phase 6b: the committer's block lane. The 1000-tx block through
    ``TorchCSP(device="cuda").verify_block`` with the default key cache
    (which the block lane does not use): one K7 launch and no other, no
    fallback, the host oracle's flags. Then the hostile secp256k1 block
    through the same entry (K7 secp256k1's own path), and the main
    block's preimages through ``sha256_batch`` (K6's own path). Counts
    are set to 0 just before each run and read just after."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import block_verify, ecdsa, sha256

    sw = SwCSP()
    csp = TorchCSP(device="cuda", use_cpu_fallback=False)
    if csp.key_cache is None:
        raise SystemExit("the default TorchCSP has no key cache")

    def counts():
        return {"K1": dict(ecdsa.LAUNCHES), "K2": dict(ecdsa.LAUNCHES_PINNED),
                "K6": dict(sha256.LAUNCHES_SHA256),
                "K7": dict(block_verify.LAUNCHES_BLOCK)}

    def run(what, req, curve_name):
        want = blocklane.verify_block_host(sw.verify_batch, req)
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = csp.verify_block(req)
        ms = (time.perf_counter() - t) * 1e3
        seen = counts()
        log(f"{what}: {ms:.2f} ms, {int((got == 0).sum())} of {req.ntx} "
            f"txs valid, launches {seen}")
        want_k7 = {"P-256": 0, "secp256k1": 0}
        want_k7[curve_name] = 1
        zero = {"P-256": 0, "secp256k1": 0}
        if seen != {"K1": zero, "K2": zero, "K6": {"sha256": 0},
                    "K7": want_k7}:
            raise SystemExit(f"{what}: launches {seen}")
        if got.tolist() != want.tolist():
            raise SystemExit(f"{what}: flags differ from the host oracle")
        return {"ms": ms, "launches": seen["K7"][curve_name],
                "k6_launches": seen["K6"]["sha256"],
                "txs_valid": int((got == 0).sum()),
                "flags": [int(f) for f in want]}

    main = run(f"block lane, {blk['main'].ntx} txs x 2 endorsements, "
               f"{len(blk['main'].lanes)} lanes", blk["main"], "P-256")
    stats = csp.stats
    if (csp._c_block_fallbacks.value() != 0
            or csp._c_block_blocks.value() != 1
            or stats["pinned_lanes"] != 0 or stats["batches"] != 0):
        raise SystemExit(f"block lane main path: fallbacks "
                         f"{csp._c_block_fallbacks.value()}, blocks "
                         f"{csp._c_block_blocks.value()}, stats {stats}")
    k1 = run(f"secp256k1 block lane, {blk['secp256k1'].ntx} txs, "
             f"{len(blk['secp256k1'].lanes)} lanes", blk["secp256k1"],
             "secp256k1")
    msgs = [ln.msg for ln in blk["main"].lanes]
    ecdsa.reset_launches()
    t = time.perf_counter()
    digests = sha256.sha256_batch(msgs)
    sha_ms = (time.perf_counter() - t) * 1e3
    seen = counts()
    log(f"sha256_batch, {len(msgs)} preimages: {sha_ms:.2f} ms, launches "
        f"{seen}")
    if seen["K6"] != {"sha256": 1} or any(
            v for k in ("K1", "K2", "K7") for v in seen[k].values()):
        raise SystemExit(f"sha256_batch: launches {seen}")
    if digests != [hashlib.sha256(m).digest() for m in msgs]:
        raise SystemExit("sha256_batch: digests differ from hashlib")
    if csp._c_block_fallbacks.value() != 0:
        raise SystemExit("a block-lane fallback happened")
    return {"main": main, "secp256k1": k1,
            "sha256_batch": {"ms": sha_ms, "launches": 1}}, csp


def time_sha256(sha_checked, blk, sm_clock_hz, dev) -> dict:
    """Phase 7b, K6 at its four shapes: the main block (2048 lanes, NB
    16), its first 128 lanes, its arrays tiled four times (8192 lanes)
    and the uniform batch (2048 lanes of 16 blocks). Each: the time a
    launch in a CUDA graph of 32 launches (``ms``: no host between the
    launches, the words warm in L2) and over 50 launches of
    ``sha256_cuda`` from the host (``host_ms``: a launch of some 20 µs is
    shorter than the wrapper's host time, so this reads the host), its
    plain twin's time, its bound (:func:`sha_bound_ms`) and the ns a
    round on its longest lane (``ms`` over that lane's blocks × 64)."""
    from bdls_tpu_torch.crypto.torch_provider import block_lane_screen
    from bdls_tpu_torch.ops import _build, block_verify, sha256

    packed = block_verify.pack_block_request(
        blk["main"], lane_ok=block_lane_screen("P-256"))
    words, nblocks = packed["words"], packed["nblocks"]
    shapes = {"main": (words, nblocks),
              "first 128": (words[:, :, :128], nblocks[:128]),
              "tiled x4": (np.tile(words, (1, 1, 4)), np.tile(nblocks, 4)),
              "uniform": sha_checked["uniform_arrays"]}
    out = {}
    for name, (wd, nbl) in shapes.items():
        NB, _, L = wd.shape
        w, nb = _build.as_int32(wd, dev), _build.as_int32(nbl, dev)
        host_ms = cuda_ms(lambda: sha256.sha256_cuda(w, nb), 50)
        ms = graph_ms(lambda: sha256.sha256_cuda(w, nb))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sha256.sha256_words(w, nb)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bms, by = sha_bound_ms(nbl, NB, sm_clock_hz)
        blocks = active_blocks(nbl, NB)
        longest = int(np.clip(nbl, 0, NB).max())
        ns_round = ms * 1e6 / (64 * longest)
        out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bound_ms": bms,
                     "bound_by": by, "bound_share": bms / ms, "lanes": L,
                     "NB": NB, "active_blocks": blocks,
                     "longest_blocks": longest, "ns_per_round": ns_round}
        log(f"K6 {name} (NB {NB}, {L} lanes, {blocks} active blocks, "
            f"longest {longest}): kernel {ms:.4f} ms in a graph "
            f"({ns_round:.2f} ns a round on the longest lane; {host_ms:.4f} "
            f"ms a launch from the host), bound {bms:.5f} ms ({by}, "
            f"{bms / ms:.2%}), plain {plain_ms:.0f} ms")
    return out


def time_block(checked, blk, csp, sm_clock_hz, dev) -> dict:
    """Phase 7b: K7 (both curves) with CUDA events and their bounds, the
    plain twins on the main block's arrays, then 9 ``verify_block``
    calls and 9 lane-at-a-time calls (``verify_block_host`` over a
    key-cache-off TorchCSP: hashlib plus K1), in turns."""
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP, \
        block_lane_screen
    from bdls_tpu_torch.ops import block_verify, ecdsa, sha256
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    packed = block_verify.pack_block_request(
        blk["main"], lane_ok=block_lane_screen("P-256"))
    ts = packed_on(packed, dev)
    L = packed["words"].shape[2]
    cv = CURVES["P-256"]
    ms = cuda_ms(lambda: block_verify.verify_block_cuda(cv, *ts), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_verify.block_kernel(cv, *ts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    bms, by = block_bound_ms(cv, packed, sm_clock_hz)
    e16 = sha256.words_to_e16(sha256.sha256_cuda(ts[0], ts[1])).contiguous()
    k1_ms = cuda_ms(lambda: ecdsa.verify_fold_cuda(cv, *ts[2:6], e16), 20)
    out["P-256"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "k1_same_lanes_ms": k1_ms}
    log(f"K7 P-256 at the main shape: kernel {ms:.3f} ms (K1 on the same "
        f"{L} lanes {k1_ms:.3f} ms), bound {bms:.4f} ms ({by}, "
        f"{bms / ms:.2%}), plain {plain_ms:.0f} ms")
    kc = checked["secp256k1"]
    cv = CURVES["secp256k1"]
    ms = cuda_ms(lambda: block_verify.verify_block_cuda(cv, *kc["ts"]), 20)
    bms, by = block_bound_ms(cv, kc["packed"], sm_clock_hz)
    out["secp256k1"] = {"ms": ms, "plain_ms": kc["plain_ms"],
                        "bound_ms": bms, "bound_by": by}
    log(f"K7 secp256k1 at L {kc['shape']['L']}: kernel {ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by}, {bms / ms:.2%}), plain {kc['plain_ms']:.0f} "
        f"ms")

    req = blk["main"]
    lane_csp = TorchCSP(device="cuda", key_cache_size=0,
                        use_cpu_fallback=False, flush_interval=1.0)
    lane_csp.warmup([("P-256", 2048)])
    want = blocklane.verify_block_host(lane_csp.verify_batch, req).tolist()
    fused, lane = [], []
    ecdsa.reset_launches()
    for _ in range(9):
        t = time.perf_counter()
        if csp.verify_block(req).tolist() != want:
            raise SystemExit("verify_block: flags differ")
        fused.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        if blocklane.verify_block_host(lane_csp.verify_batch,
                                       req).tolist() != want:
            raise SystemExit("lane-at-a-time: flags differ")
        lane.append((time.perf_counter() - t) * 1e3)
    seen = (dict(block_verify.LAUNCHES_BLOCK), dict(ecdsa.LAUNCHES))
    lane_csp.close()
    csp.close()
    if seen != ({"P-256": 9, "secp256k1": 0}, {"P-256": 9, "secp256k1": 0}):
        raise SystemExit(f"block timing: launches {seen}")
    if csp._c_block_fallbacks.value() or lane_csp.stats["fallbacks"]:
        raise SystemExit("a fallback happened during block timing")
    fused.sort()
    lane.sort()
    out["verify_block_ms"] = fused
    out["lane_at_a_time_ms"] = lane
    log(f"block of {req.ntx} txs, {len(req.lanes)} lanes: verify_block "
        f"median {fused[4]:.2f} ms (min {fused[0]:.2f}, max {fused[-1]:.2f}), "
        f"9 K7 launches; lane at a time (hashlib + K1) median {lane[4]:.2f} "
        f"ms (min {lane[0]:.2f}, max {lane[-1]:.2f}), 9 K1 launches")
    return out


# ---------------------------------------------------------------- Ed25519
# one Montgomery-free 32-bit reduction of a 512-bit product mod
# 2^255 - 19: the high half times 38 (8 widening products), then the
# carry word times 38 again
RED_P25519 = 2 * 8 + 2
ED_LANE_BYTES = 6 * 16 * 4       # six (16, B) int32 arrays
ED_ENTRY_BYTES = 3 * 8 * 4       # a B-table entry: x, y, t


def _ed_digits(k: int) -> list[int]:
    """K8's 66 signed 4-bit digits of k, LSB first."""
    w = k + sum(8 << (4 * i) for i in range(64))
    ds = [((w >> (4 * i)) & 0xF) - 8 for i in range(64)]
    return ds + [w >> 256, 0]


def needed_muls_ed25519(rows) -> float:
    """32-bit multiplies that verifying ``rows`` (``ed25519_lane``
    tuples) in one launch needs, at the least work known for the
    function, not the kernel's choices:

    - extended twisted-Edwards formulas of the Explicit-Formulas
      Database with a = -1: dbl-2008-hwcd 4M + 4S; add-2008-hwcd-3 8M
      with the table entries kept as (Y - X, Y + X, 2Z, 2d·T); the
      positioned B entries affine with 2d·t stored, 7M;
    - special-form reduction mod 2^255 - 19;
    - [k](-A): the [2..8]·(-A) table (1 doubling, 6 additions), then
      4 doublings a signed digit below the top nonzero one and one
      addition per nonzero digit of k (the run's own digits);
    - [S]B: one addition per nonzero byte of S, no doubling;
    - the on-curve checks of A and R (2S + 3M each), the final sum of
      the two accumulators and the projective compare (2M);
    - a lane with S >= L or a coordinate >= p needs no work past its
      range check, a lane with a point off the curve none past the
      curve checks.
    """
    from bdls_tpu_torch.ops.ed25519 import L, P, on_curve as ed_on_curve

    mp, sp = MUL + RED_P25519, SQR + RED_P25519
    dbl, add, madd = 4 * mp + 4 * sp, 8 * mp, 7 * mp
    on_curve = 2 * sp + 3 * mp
    total = 0.0
    for ax, ay, rx, ry, s, k in rows:
        if s >= L or max(ax, ay, rx, ry) >= P:
            continue
        total += 2 * on_curve
        if not (ed_on_curve(ax, ay) and ed_on_curve(rx, ry)):
            continue
        ds = _ed_digits(k)
        top = max((i for i, d in enumerate(ds) if d), default=-1)
        nz = sum(1 for d in ds if d)
        nb = sum(1 for j in range(32) if (s >> (8 * j)) & 0xFF)
        total += (dbl + 6 * add + 4 * max(top, 0) * dbl + nz * add
                  + nb * madd + add + 2 * mp)
    return total


def ed25519_bound_ms(rows, sm_clock_hz: float) -> tuple[float, str]:
    """K8's bound: the multiplies of :func:`needed_muls_ed25519` over the
    card's multiply rate, against the bytes: each lane's six limb
    arrays and its verdict, and every B-table entry the batch needs,
    once."""
    t_ops = needed_muls_ed25519(rows) / (
        SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    entries = {(j, (s >> (8 * j)) & 0xFF) for _, _, _, _, s, _ in rows
               for j in range(32)}
    t_bytes = ((ED_LANE_BYTES + 1) * len(rows)
               + ED_ENTRY_BYTES * len(entries)) / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_ed25519_inputs(rng) -> dict:
    """The Ed25519 vote path's inputs: a 128-validator committee's
    85-vote quorum and a 1024-validator committee's 683-vote quorum
    (2t + 1, as ``tests/test_committee_growth.py`` sizes them), each
    vote an RFC 8032 signature over the round's 32-byte digest; every
    61st voter from the 8th signs another digest (forged)."""
    from bdls_tpu_torch.crypto.csp import VerifyRequest
    from bdls_tpu_torch.crypto.sw import SwCSP

    sw = SwCSP()
    rounds = {}
    for n, quorum in ((128, 85), (1024, 683)):
        digest = sw.hash(b"bdls height 42 round 7 committee %d" % n)
        reqs, oks = [], []
        for v in range(quorum):
            key = sw.key_gen("ed25519", rng)
            forged = v % 61 == 7
            r, s = sw.sign(key, sw.hash(b"other round") if forged
                           else digest)
            reqs.append(VerifyRequest(key.public_key(), digest, r, s))
            oks.append(not forged)
        rounds[n] = (reqs, oks)
    return rounds


def _ed_lane_of(q) -> tuple:
    return (q.key.x, q.key.y, q.r, q.s, q.digest, "main path")


def check_ed25519_kernel(ed_in, rng, dev) -> dict:
    """Phase 3c: K8 on the card against its plain twin, lane for lane,
    and both against the RFC 8032 oracle (``verify_affine``), at 128 and
    2048 lanes: the RFC 8032 §7.1 vectors, seeded valid lanes and every
    hostile lane of ``vectors.ed25519_mixed_lanes``, the rows with a
    chosen k of ``vectors.ed25519_k_rows`` (against the equation with k
    as it is), filled up with the main path's own votes."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import ED25519

    mixed = vectors.ed25519_mixed_lanes(rng)
    krows = vectors.ed25519_k_rows(rng)
    fill = [_ed_lane_of(q) for n in (128, 1024) for q in ed_in[n][0]]
    out = {}
    for b in (128, 2048):
        lanes = mixed + [fill[i % len(fill)]
                         for i in range(b - len(mixed) - len(krows))]
        want = np.array(vectors.ed25519_expected(lanes)
                        + vectors.ed25519_row_expected(krows))
        rows = vectors.ed25519_rows(lanes) + [r[:6] for r in krows]
        labels = [ln[5] for ln in lanes] + [r[6] for r in krows]
        args = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in ed.lanes_to_limbs(rows)]
        kern = ed.verify_ed25519_cuda(*args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ed.verify_ed25519(ED25519, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [labels[i] for i in np.flatnonzero(diff)]
        log(f"ed25519: K8 vs plain on {b} lanes ({len(mixed)} mixed, "
            f"{len(krows)} with a chosen k): "
            f"{int(diff.sum())} differ {bad}; valid {int(kern.sum())}; "
            f"plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit("ed25519: K8 disagrees with its plain twin")
        if not np.array_equal(kern, want):
            raise SystemExit("ed25519: K8 disagrees with the RFC 8032 "
                             "oracle")
        out[b] = {"rows": rows, "want": want,
                  "max_abs_err": int(diff.max()), "plain_ms": plain_ms}
    return out


def drive_ed25519_main_path(ed_in) -> dict:
    """Phase 5b: the Ed25519 vote path at full width through
    ``TorchCSP(device="cuda")`` (``submit`` + ``flush``): the 85-vote
    and the 683-vote quorum, each in exactly one K8 launch, no K1 or K2
    launch, no fallback, the verdicts of construction, which the plain
    twin gives on the round's marshaled lanes. Counts are set to
    0 just before each round and read just after."""
    from bdls_tpu_torch.crypto import marshal
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import ED25519

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0)
    csp.warmup([("ed25519", b) for b in BUCKETS])
    out = {}
    for n in (128, 1024):
        reqs, oks = ed_in[n]
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        futs = [csp.submit(q) for q in reqs]
        csp.flush()
        got = [f.result(60) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        seen = (dict(ed.LAUNCHES_ED25519), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED), dict(ecdsa.LAUNCHES_LATENCY))
        log(f"ed25519 vote round, {n} validators, {len(reqs)} votes "
            f"({len(reqs) - sum(oks)} forged): {ms:.2f} ms, K8 launches "
            f"{seen[0]}, K1 {seen[1]}, K2 {seen[2]}, K3 {seen[3]}")
        if got != oks:
            raise SystemExit(f"ed25519 round {n}: verdicts differ")
        if seen[0] != {"ed25519": 1} or any(
                v for d in seen[1:] for v in d.values()):
            raise SystemExit(f"ed25519 round {n}: launches {seen}")
        t0 = time.perf_counter()
        rows = marshal.marshal_requests(reqs)
        marshal_ms = (time.perf_counter() - t0) * 1e3
        plain = ed.verify_ed25519(ED25519, *(
            torch.from_numpy(a.view(np.int32)).cuda()
            for a in rows)).cpu().tolist()
        plain_ms = (time.perf_counter() - t0) * 1e3 - marshal_ms
        log(f"ed25519 round {n}: the plain twin on its {len(reqs)} marshaled "
            f"lanes {'equal' if plain == got else 'differs'} (marshal "
            f"{marshal_ms:.0f} ms, plain {plain_ms:.0f} ms)")
        if plain != got:
            raise SystemExit(f"ed25519 round {n}: K8 differs from its "
                             "plain twin")
        out[n] = {"ms": ms, "launches": 1, "votes": len(reqs),
                  "check_marshal_ms": marshal_ms, "check_plain_ms": plain_ms}
    if csp.stats["fallbacks"] != 0:
        raise SystemExit(f"ed25519 main path: {csp.stats}")
    return out, csp


def _identities(votes) -> list[bytes]:
    return [q.key.x.to_bytes(32, "big") + q.key.y.to_bytes(32, "big")
            for q in votes]


def drive_latency_main_path(votes, vote_ok) -> dict:
    """Phase 5c: K3 at full width. A 128-validator secp256k1 committee on
    ``TorchCSP(device="cuda", key_cache_size=0)`` (flush interval at the
    reference default), warmed so every latency-eligible bucket has its
    captured slots; ``CspBatchVerifier`` with the 128 identities sets the
    quorum hint to 85; 85 ``submit`` calls (2 forged) go out as one
    speculative flush through exactly one K3 replay, with no eager K1
    launch and no cold fallback. Once with the vote buckets off (bucket
    128), once with ``vote_buckets=VOTE_BUCKETS`` (bucket 85). Then the
    ring repro: 21 requests at ``buckets=(8,)``, three runs."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP, VOTE_BUCKETS
    from bdls_tpu_torch.ops import ecdsa

    os.environ.pop("BDLS_TPU_VOTE_BUCKETS", None)
    quorum, want = votes[:85], vote_ok[:85]
    out = {}
    for label, vb, bucket in (("vote buckets off", None, 128),
                              ("vote buckets on", VOTE_BUCKETS, 85)):
        csp = TorchCSP(device="cuda", key_cache_size=0,
                       use_cpu_fallback=False, vote_buckets=vb)
        csp.warmup([("secp256k1", b) for b in csp.buckets
                    if b <= 2048])
        CspBatchVerifier(csp, consenters=_identities(votes))
        if csp.quorum_lanes != 85:
            raise SystemExit(f"quorum hint {csp.quorum_lanes}, want 85")
        # one round first: the flusher and drainer threads exist
        [f.result(60) for f in [csp.submit(q) for q in quorum]]
        before = csp.stats
        qw = csp.metrics.find("tpu_verify_queue_wait_seconds")
        qw0 = qw.snapshot()
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        futs = [csp.submit(q) for q in quorum]
        t_sub = time.perf_counter() - t0
        got = [f.result(60) for f in futs]
        ms = (time.perf_counter() - t0) * 1e3
        st = csp.stats
        seen = (dict(ecdsa.LAUNCHES_LATENCY), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED))
        spec = st["speculative_flushes"] - before["speculative_flushes"]
        cold = st["latency_cold_fallbacks"] - before["latency_cold_fallbacks"]
        # the one flush's queue wait: first submit to the launch
        qw1 = qw.snapshot()
        wait_ms = (qw1["sum"] - qw0["sum"]) * 1e3
        log(f"K3 quorum round ({label}, bucket {bucket}): 85 submits in "
            f"{t_sub * 1e3:.2f} ms, flushed {wait_ms:.2f} ms after the "
            f"first (flush_interval {csp.flush_interval * 1e3:.0f} ms), "
            f"verdicts after {ms:.2f} ms; speculative flushes {spec}, cold "
            f"fallbacks {cold}, K3 replays {seen[0]}, eager K1 {seen[1]}, "
            f"K2 {seen[2]}")
        if got != want:
            raise SystemExit(f"K3 round ({label}): verdicts differ")
        if (qw1["count"] - qw0["count"] != 1
                or wait_ms >= csp.flush_interval * 1e3):
            raise SystemExit(f"K3 round ({label}): the flush waited "
                             f"{wait_ms:.2f} ms, not launched at quorum")
        if spec < 1 or cold != 0 or st["fallbacks"] != 0:
            raise SystemExit(f"K3 round ({label}): stats {st}")
        if seen != ({"P-256": 0, "secp256k1": 1},
                    {"P-256": 0, "secp256k1": 0},
                    {"P-256": 0, "secp256k1": 0}):
            raise SystemExit(f"K3 round ({label}): launches {seen}")
        out[bucket] = {"ms": ms, "submit_ms": t_sub * 1e3, "launches": 1,
                       "flush_wait_ms": wait_ms, "speculative_flushes": spec}
        if bucket == 128:
            live = csp
        else:
            csp.close()

    lanes = vectors.mixed_lanes("secp256k1", np.random.default_rng(SEED + 4),
                                n_valid=2)[:21]
    reqs = [VerifyRequest(PublicKey("secp256k1", qx, qy), d, r, s)
            for qx, qy, r, s, d, _ in lanes]
    want = SwCSP().verify_batch(reqs)
    ring = TorchCSP(device="cuda", key_cache_size=0, buckets=(8,),
                    use_cpu_fallback=False)
    ring.warmup([("secp256k1", 8)])
    ecdsa.reset_launches()
    runs = [ring.verify_batch(reqs) for _ in range(3)]
    replays = ecdsa.LAUNCHES_LATENCY["secp256k1"]
    eager = ecdsa.LAUNCHES["secp256k1"]
    ring.close()
    log(f"ring repro, 21 secp256k1 requests at buckets=(8,), 3 runs: "
        f"{'stable' if runs == [runs[0]] * 3 else 'UNSTABLE'}, "
        f"{'equal to' if runs[0] == want else 'DIFFERENT from'} SwCSP; "
        f"{replays} K3 replays, {eager} eager K1 launches (slots busy)")
    if runs != [want] * 3 or replays + eager != 9 or replays < 3:
        raise SystemExit("ring repro failed")
    out["ring_repro"] = {"runs": 3, "k3_replays": replays,
                         "eager_k1": eager}
    return out, live


def time_latency(lat_lanes, lat_want, live, quorum, want, sm_clock_hz,
                 dev) -> dict:
    """Phase 7c: a K3 replay (staging copy → K1 → verdict copy, captured)
    against an eager K1 launch (kernel alone, and with the same two
    copies launched one by one as the throughput tier does), at buckets
    85, 128 and 171 on secp256k1, with CUDA events and by the host clock
    from launch to event; then the quorum's submit-to-verdict median of
    9 rounds with the tier on against ``latency_max_lanes=0``, in
    turns."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import SECP256K1

    out = {}
    stream = torch.cuda.Stream(dev)
    for b in (85, 128, 171):
        idx = [i % len(lat_lanes) for i in range(b)]
        tiled = [lat_lanes[i] for i in idx]
        arrs = [ints_to_limbs(c) for c in vectors.columns(tiled)]
        slot = ecdsa.LatencySlot(SECP256K1, b, device=dev, stream=stream)
        slot.stage(arrs)
        slot.launch().synchronize()
        got = slot.verdict()
        host = torch.from_numpy(np.stack(arrs).view(np.int32)).pin_memory()
        limbs = host.to(dev)
        eager = ecdsa.verify_fold_cuda(SECP256K1, *limbs).cpu().numpy()
        if not (np.array_equal(got, eager)
                and np.array_equal(got, lat_want[idx])):
            raise SystemExit(f"K3 B={b}: replay differs from eager K1")
        res = {"max_abs_err": int(np.abs(got.astype(np.int64)
                                         - eager.astype(np.int64)).max())}
        outbuf = torch.empty(b, dtype=torch.bool, pin_memory=True)

        def replay():
            slot.graph.replay()

        def eager_copies():
            buf = host.to(dev, non_blocking=True)
            ok = ecdsa.verify_fold_cuda(SECP256K1, *buf)
            outbuf.copy_(ok, non_blocking=True)

        with torch.cuda.stream(stream):
            res["replay_ms"] = cuda_ms(replay, 20)
            res["eager_k1_ms"] = cuda_ms(
                lambda: ecdsa.verify_fold_cuda(SECP256K1, *limbs), 20)
            res["eager_copies_ms"] = cuda_ms(eager_copies, 20)
            # host clock from the launch call to the event, one at a time
            hr, he = [], []
            for _ in range(9):
                t = time.perf_counter()
                slot.launch().synchronize()
                hr.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                eager_copies()
                ev = torch.cuda.Event()
                ev.record(stream)
                ev.synchronize()
                he.append((time.perf_counter() - t) * 1e3)
        res["replay_host_ms"] = sorted(hr)[4]
        res["eager_host_ms"] = sorted(he)[4]
        bms, by = bound_ms(SECP256K1, tiled, sm_clock_hz)
        res.update({"bound_ms": bms, "bound_by": by})
        out[b] = res
        log(f"K3 B={b}: replay {res['replay_ms']:.3f} ms (host "
            f"{res['replay_host_ms']:.3f}), eager K1 {res['eager_k1_ms']:.3f}"
            f" ms, eager copies + K1 {res['eager_copies_ms']:.3f} ms (host "
            f"{res['eager_host_ms']:.3f}), bound {bms:.4f} ms ({by})")

    off = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   latency_max_lanes=0)
    off.warmup([("secp256k1", 128)])
    CspBatchVerifier(off, consenters=_identities(quorum))
    quorum = quorum[:85]

    def round_ms(csp):
        t = time.perf_counter()
        got = [f.result(60) for f in [csp.submit(q) for q in quorum]]
        ms = (time.perf_counter() - t) * 1e3
        if got != want:
            raise SystemExit("quorum round: verdicts differ")
        return ms

    round_ms(off)
    on_ms, off_ms = [], []
    ecdsa.reset_launches()
    for _ in range(9):
        on_ms.append(round_ms(live))
        off_ms.append(round_ms(off))
    seen = (dict(ecdsa.LAUNCHES_LATENCY), dict(ecdsa.LAUNCHES))
    live.close()
    off.close()
    if seen != ({"P-256": 0, "secp256k1": 9}, {"P-256": 0, "secp256k1": 9}):
        raise SystemExit(f"quorum timing: launches {seen}")
    on_ms.sort()
    off_ms.sort()
    out["quorum_on_ms"], out["quorum_off_ms"] = on_ms, off_ms
    log(f"quorum round, 85 secp256k1 votes, submit to verdict: tier on "
        f"median {on_ms[4]:.2f} ms (min {on_ms[0]:.2f}, max {on_ms[-1]:.2f}),"
        f" 9 K3 replays; latency_max_lanes=0 median {off_ms[4]:.2f} ms "
        f"(min {off_ms[0]:.2f}, max {off_ms[-1]:.2f}), 9 eager K1 launches")
    return out


def time_ed25519(checked, ed_csp, sm_clock_hz, dev) -> dict:
    """Phase 7d: K8 with CUDA events at 128, 2048 and 8192 lanes (phase
    3c's batches, tiled, verdicts checked; at 8192 also against the
    plain twin), its bound and its plain twin's time."""
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import ED25519

    ed_csp.close()
    base = checked[2048]
    out = {}
    for b in BUCKETS:
        idx = [i % len(base["rows"]) for i in range(b)]
        rows = [base["rows"][i] for i in idx]
        args = [torch.from_numpy(a.view(np.int32)).to(dev)
                for a in ed.lanes_to_limbs(rows)]
        ok = ed.verify_ed25519_cuda(*args).cpu().numpy()
        if not np.array_equal(ok, base["want"][idx]):
            raise SystemExit(f"K8 B={b}: verdicts differ")
        if b not in checked:
            t0 = time.perf_counter()
            plain = ed.verify_ed25519(ED25519, *args).cpu().numpy()
            diff = np.abs(plain.astype(np.int64) - ok.astype(np.int64))
            checked[b] = {"plain_ms": (time.perf_counter() - t0) * 1e3,
                          "max_abs_err": int(diff.max())}
            if diff.any():
                raise SystemExit(f"K8 B={b}: differs from its plain twin")
        ms = cuda_ms(lambda: ed.verify_ed25519_cuda(*args),
                     10 if b <= 2048 else 5)
        bms, by = ed25519_bound_ms(rows, sm_clock_hz)
        out[b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                  "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
        log(f"K8 B={b}: kernel {ms:.3f} ms ({b / ms * 1e3:,.0f} "
            f"verifies/s), bound {bms:.4f} ms ({by}, {bms / ms:.2%} of the "
            f"kernel time)"
            + f", plain {checked[b]['plain_ms']:.0f} ms")
    return out


# ------------------------------------------------------------ BLS12-381
# one 381-bit CIOS Montgomery product as 32-bit multiplies: 144 widening
# a·b products, 12 q = t0·n0 and 144 widening q·p products
MUL381 = 2 * 144 + 12 + 2 * 144
# The least work known for one certificate check, e(g1, sig)·e(-pk, H(m))
# == 1, in Fp products (m), with an Fp2 product 3m (Karatsuba) and an Fp2
# square 2m (complex squaring):
# - two optimal-ate Miller loops on the twist sharing f (a multi-pairing):
#   63 doubling steps, each one Fp12 square (2 Fp6 products, 12 Fp2
#   products) and per pairing a doubling with its line, 3 Fp2 products +
#   6 Fp2 squares + 4m, and a sparse product of f by the line, 13 Fp2
#   products; 5 addition steps, per pairing 11 Fp2 products + 2 Fp2
#   squares + 4m and the sparse product (Aranha, Karabina, Longa,
#   Gebotys, Lopez, "Faster explicit formulas for computing pairings over
#   ordinary curves", Eurocrypt 2011, sections 4-5);
# - one shared final exponentiation: the easy part, an Fp12 inverse (one
#   Fp inverse by Fermat, 608 products and squares, plus 100m through the
#   tower), 2 Fp12 products (18 Fp2 products each) and a p^2-Frobenius
#   (10m); the hard part, 5 exponentiations by x, each 63 cyclotomic
#   squares (6 Fp2 squares each, Karabina's compressed squaring) and 5
#   Fp12 products, then 10 Fp12 products and 3 Frobenius maps (15m each)
#   (the BLS12 chain of Hayashida, Hayasaka, Teruya, "Efficient final
#   exponentiation via cyclotomic structure for pairings over families of
#   elliptic curves", 2020).
M2, S2, F12_MUL = 3, 2, 18 * 3
MILLER_M = (63 * (12 * M2 + 2 * (3 * M2 + 6 * S2 + 4 + 13 * M2))
            + 5 * 2 * (11 * M2 + 2 * S2 + 4 + 13 * M2))
FINAL_M = (608 + 100 + 2 * F12_MUL + 10
           + 5 * (63 * 6 * S2 + 5 * F12_MUL) + 10 * F12_MUL + 3 * 15)
F12_BYTES = 12 * 12 * 4          # one FQ12 value, (12 words, 12 coefficients)
# the kernels' own work in 381-bit products (csrc/bls12.cuh), a warp's
# tower product 108 (36 Fp2 products of 3), a tower square 63, a
# cyclotomic square 18, a sparse frob1 19 and frob2 12:
# - a twisted Miller loop (a certificate's pairs): 63 doubling bits of
#   fn's square and 8 Fp2 products (87), 9 Fp2 products (27) and fn times
#   the line's 3 coefficients with fd's product (57); 5 chord bits of 6,
#   11 and 18 Fp2 products (18 + 33 + 54);
# - a dense Miller loop (a pair off the twist's image): the one-thread
#   formulas' 63 steps of 5 squares and 14 products and 5 chord-and-add
#   steps of 17 products, each a tower square or product;
# - a side of the x-chain: the input product; the easy part (8 products,
#   3 frob2 and one frob1, the Fermat inverse of 380 squares and 228
#   products on one lane, 12 Fp products); 5 powers by |x| (63 cyclotomic
#   squares and 5 products each); 2 products in the first two stages, a
#   frob1, a frob2 and 3 products after them, and m^3 (a cyclotomic
#   square, 2 products)
K9_MILLER_PRODUCTS = 63 * (87 + 27 + 57) + 5 * (18 + 33 + 54)
K9_DENSE_MILLER_PRODUCTS = 63 * (5 * 63 + 14 * 108) + 5 * 17 * 108
K9_FINAL_PRODUCTS = (108 + 8 * 108 + 3 * 12 + 19 + 380 + 228 + 12
                     + 5 * (63 * 18 + 5 * 108) + 2 * 108 + 19 + 12
                     + 3 * 108 + 18 + 2 * 108)
CERT_COMMITTEES = ((128, 85), (1024, 683))


# 32-bit multiplies of K8's product mod 2^255 - 19 (edwards_group.cuh:
# mul_25519): 64 widening a·b products, 8 high columns times 38 (64-bit
# products, two each), the carry times 38, bit 255 times 19, and the
# carry after that times 38
MUL32_PER_MUL25519 = 2 * 64 + 2 * 8 + 3


def ed25519_group_products() -> int:
    """Products mod p a lane of K8's group body
    (``csrc/edwards_group.cuh``), counted from its steps: A's and R's
    x^2, y^2, x^2·y^2 and d·x^2·y^2, -A's T (the coordinates are only
    reduced mod p); the table (2·1 with T and entry 1's 2d·T, three
    rounds of an addition and a doubling with T, 2d·T of entries 2-8);
    per digit of k three doublings without T, one with, an addition
    without (the last one with); 32 mixed additions with T (the constant
    2Z a product too) and the join's 2d·T; the join without T and the
    two products of the compare."""
    pre = 4 + 2 + 2 + 1
    table = (4 + 4) + 1 + 3 * 2 * (4 + 4) + 7
    ladder = 64 * (3 * (4 + 3) + (4 + 4) + (4 + 3)) + 1
    chain1 = 32 * (4 + 4) + 1
    return pre + table + ladder + chain1 + (4 + 3) + 2


def mont16_group_counts(curve) -> dict:
    """Montgomery products and steps a lane of K4's group body
    (``csrc/mont16_group.cuh``), counted from its steps, no exceptional
    double taken: the loads; Q, r and r + n into Montgomery form; s^-1·R,
    y^2, x^2; u1, u2, x^3; the curve check (no product); the table (a
    doubling, 13 mixed additions of 12 products); per window 4 doublings
    (9 products in 4 levels on P-256, 8 in 3 on secp256k1), chain 1's
    mixed addition and its doubling of the Q entry in their spare shares,
    one addition (17 products, 5 levels); Z^2 and the two products of
    the compare."""
    dbl, dbl_steps = (8, 3) if curve.a_kind == "zero" else (9, 4)
    products = (4 + 3 + 3 + dbl + 13 * 12
                + 64 * (4 * dbl + 12 + dbl + 17) + 3)
    steps = 5 + dbl_steps + 13 * 5 + 64 * (4 * dbl_steps + 5) + 3
    return {"kernel_products_per_verify": products,
            "kernel_muls_per_verify": products * MUL32_PER_MONT,
            "steps_per_verify": steps}


def static_counts() -> dict:
    """The hand counts of work behind the bounds and ``PERF.md``'s
    prose, counted from the code and not measured: for the report's
    ``static_counts``, never for the ``kernels`` line."""
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    for c, cv in CURVES.items():
        out[f"verify ({c})"] = {"kernel_muls_per_verify":
                                mont_muls_per_verify(cv) * MUL32_PER_MONT}
        out[f"verify [mxu] ({c})"] = {
            "kernel_products_per_verify": mont_muls_per_verify_thread(cv)}
        out[f"pinned ({c})"] = {"kernel_muls_per_verify":
                                pinned_kernel_muls(cv)}
        out[f"mont16 ({c})"] = mont16_group_counts(cv)
    out["sha256_kernel"] = {"least_ops_per_block": SHA_OPS_PER_BLOCK}
    out["ed25519_kernel"] = {
        "kernel_products_per_verify": ed25519_group_products(),
        "kernel_muls_per_verify":
            ed25519_group_products() * MUL32_PER_MUL25519}
    out["bls_miller_kernel"] = {
        "least_products_per_cert": MILLER_M,
        "kernel_products_per_cert": 2 * K9_MILLER_PRODUCTS,
        "kernel_products_per_dense_pair": K9_DENSE_MILLER_PRODUCTS}
    out["bls_final_kernel"] = {
        "least_products_per_cert": FINAL_M,
        "kernel_products_per_cert": 2 * K9_FINAL_PRODUCTS}
    return out


def k9_bound_ms(kernel: str, lanes: int,
                sm_clock_hz: float) -> tuple[float, str]:
    """K9's bound at ``lanes`` certificates: the least-work multiplies
    (:data:`MILLER_M` for the Miller launch, :data:`FINAL_M` for the
    final launch) over the card's 32-bit multiply rate, against the
    bytes each launch must move once: the Miller launch reads the eight
    FQ12 coordinates and writes (n, d) of both pairs; the final launch
    reads those and writes the verdict byte."""
    m = MILLER_M if kernel == "miller" else FINAL_M
    t_ops = m * MUL381 * lanes / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    nbytes = (8 + 4) * F12_BYTES if kernel == "miller" else 4 * F12_BYTES + 1
    t_bytes = nbytes * lanes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def make_cert_inputs() -> dict:
    """The certificate lane's inputs, as ``tools/tpu_ablate.py:
    cert_sweep`` makes them: validator i's key is (i + 1)·G1, so a
    quorum's aggregate signature over H(d) is (q(q + 1)/2)·H(d). For the
    committees of 128 (quorum 85) and 1024 (quorum 683): a call of 2
    certificates over two rounds' digests, signed by the first 2t + 1
    validators; and a cross-round batch of 64 certificates (32 rounds of
    each committee) of which 2 are forged (the aggregate of a quorum
    with one vote counted twice). H(d) is computed once, through each
    aggregator's own cache."""
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.ops import bls_host as B

    pks, pk = [], None
    for _ in range(max(n for n, _ in CERT_COMMITTEES)):
        pk = B.pt_add(pk, B.G1)
        pks.append(pk)
    out = {"batch": ([], [], [])}
    for n, q in CERT_COMMITTEES:
        agg = TH.ThresholdAggregator(pks[:n], q, max_pending=128)
        sk_sum = q * (q + 1) // 2 % B.R

        def cert(round_: int, forged: bool = False):
            d = hashlib.sha256(b"bdls committee %d round %d"
                               % (n, round_)).digest()
            k = sk_sum + 1 if forged else sk_sum
            return TH.QuorumCertificate(d, tuple(range(q)),
                                        B.pt_mul(k, agg._hm(d)))

        out[n] = {"agg": agg, "pair": [cert(0), cert(1)]}
        certs, aggs, want = out["batch"]
        for r in range(2, 34):
            forged = r == 9
            certs.append(cert(r, forged))
            aggs.append(agg)
            want.append(not forged)
    return out


def check_bls_kernel(cert_in, dev) -> dict:
    """Phase 3d: K9 on the card against its plain twin, stage for stage
    (the Miller launch's (n, d), the final launch's FE(n1·d2) and
    FE(n2·d1), the verdicts), and against the oracle's verdicts
    (``ThresholdAggregator.verify_certificate``) on 10 lanes: valid
    certificates of both committees, a wrong binding (another round's
    digest), the masked certificates (no signature, under quorum, a
    signer out of range) as ``certificate_lanes`` packs them, a byzantine
    signature ``pt_add(sig, G1)`` (it passes ``valid_point``: the Miller
    launch's dense path), and two lanes fed to the kernel directly: the
    degenerate y = 0 "signature" and an all-zero lane. Each lane's form
    is read from its words by the kernel's rule (:func:`pair_twisted`):
    the dense lanes must be the two built so, and every twisted pair's d
    one tower coefficient. Returns the lanes, with the indices of those
    whose pairs all have the twisted form (a certificate's) and of the
    two dense ones."""
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.ops import bls_host as B
    from bdls_tpu_torch.ops import bls_kernel as K

    a128, a1k = cert_in[128]["agg"], cert_in[1024]["agg"]
    c0, c1 = cert_in[128]["pair"]
    QC = TH.QuorumCertificate
    certs = [c0, c1, cert_in[1024]["pair"][0],
             QC(c1.digest, c0.signers, c0.agg_sig),
             QC(c0.digest, c0.signers, None),
             QC(c0.digest, c0.signers[:-1], c0.agg_sig),
             QC(c0.digest, c0.signers[:-1] + (200,), c0.agg_sig),
             QC(c0.digest, c0.signers, B.pt_add(c0.agg_sig, B.G1))]
    aggs = [a128, a128, a1k, a128, a128, a128, a128, a128]
    if not TH.valid_point(certs[-1].agg_sig):
        raise SystemExit("pt_add(sig, G1) is not on E(FQ12)")
    t0 = time.perf_counter()
    want = [agg.verify_certificate(c) for c, agg in zip(certs, aggs)]
    oracle_s = time.perf_counter() - t0
    lanes, mask = TH.certificate_lanes(certs, aggs)
    extra = [(B.FQ12.scalar(1), B.FQ12.zero()),
             (B.FQ12.zero(), B.FQ12.zero())]
    g1, pk, hm = (K.pt_batch([B.G1] * 2),
                  K.pt_batch([a128._agg_pubkey(c0.signers)] * 2),
                  K.pt_batch([a128._hm(c0.digest)] * 2))
    direct = (g1, K.pt_batch(extra), pk, hm)
    arrs = [torch.from_numpy(np.concatenate([a, b], -1).view(np.int32))
            .to(dev) for pl, pd in zip(lanes, direct)
            for a, b in zip(pl, pd)]
    want += [False, False]
    mask += [True, True]
    q = miller_args(arrs)
    n, d = K.miller_cuda(*q)
    ok, fe = K.final_cuda(n, d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pn, pd = K.miller_nd(*(K.f12_from_words(t) for t in q))
    torch.cuda.synchronize()
    plain_miller_ms = (time.perf_counter() - t0) * 1e3
    B_ = len(want)
    t0 = time.perf_counter()
    sides = K.f12_mul(pn, K.FP(torch.cat([pd.v[..., B_:], pd.v[..., :B_]],
                                         -1), pd.lb))
    pfe = K.final_exp_fast(sides)
    pok = K._compare_tail(K.FP(pfe.v[..., :B_], pfe.lb),
                          K.FP(pfe.v[..., B_:], pfe.lb))
    torch.cuda.synchronize()
    plain_final_ms = (time.perf_counter() - t0) * 1e3
    # the kernel interleaves lhs (2b) and rhs (2b + 1); the twin stacks
    order = [i // 2 + (B_ if i % 2 else 0) for i in range(2 * B_)]
    errs = {}
    for name, kern, plain in (("n", n, pn), ("d", d, pd),
                              ("fe", fe[..., np.argsort(order)], pfe)):
        kv = np.array(K.words_to_ints(kern), dtype=object)
        pv = np.array(K.f12_to_ints(plain), dtype=object)
        errs[name] = int(max(abs(int(x)) for x in (kv - pv).ravel()))
    raw, praw = ok.cpu().tolist(), pok.cpu().tolist()
    got = [bool(m) and r for m, r in zip(mask, raw)]
    log(f"K9 vs plain on {B_} lanes: raw verdicts {raw}, plain {praw}; "
        f"max |kernel - plain| of n, d, fe: {errs}; masked {got}; oracle "
        f"{want} ({oracle_s:.1f} s for {len(certs)} certificates); plain "
        f"Miller {plain_miller_ms:.0f} ms, plain final "
        f"{plain_final_ms:.0f} ms")
    if raw != praw or any(errs.values()):
        raise SystemExit("K9 disagrees with its plain twin")
    if got != want or want != [True, True, True] + [False] * 7:
        raise SystemExit("K9 disagrees with the oracle")
    # each lane's form by the kernel's rule (bls12.cuh:pair_twisted) on
    # the words it was given; a twisted pair's d is one tower coefficient
    twisted = pair_twisted(q)
    d_terms = [sum(1 for c in col if c % B.P) for col in
               zip(*K.words_to_ints(d))]
    lane_twisted = [twisted[i] and twisted[B_ + i] for i in range(B_)]
    dense = [i for i in range(B_) if not lane_twisted[i]]
    if dense != [len(certs) - 1, len(certs)]:     # pt_add(sig, G1), y = 0
        raise SystemExit(f"K9 lane forms: dense lanes {dense}")
    if any(t and n_ > 2 for t, n_ in zip(twisted, d_terms)):
        raise SystemExit(f"K9: a twisted pair's d has more than one tower "
                         f"coefficient: {d_terms}")
    log(f"K9 lane forms: dense lanes {dense}; nonzero coefficients of d "
        f"a pair {d_terms}")
    return {"lanes": B_, "args": arrs, "want_raw": raw,
            "twisted_lanes": [i for i in range(B_) if lane_twisted[i]],
            "dense_lanes": dense, "d_terms": d_terms,
            "max_abs_err": errs, "max_abs_err_verdict": 0,
            "plain_miller_ms": plain_miller_ms,
            "plain_final_ms": plain_final_ms,
            "oracle_s": oracle_s, "oracle_certs": len(certs)}


def drive_cert_main_path(cert_in) -> tuple[dict, object]:
    """Phase 6e: the certificate lane through ``TorchCSP(device="cuda")
    .verify_certificates``: per committee (128 and 1024 validators) a
    call of 2 certificates, warmed once as ``cert_sweep`` warms them (the
    aggregated key and H(m) cached), then counted: the verdicts of
    construction, one launch of each K9 kernel, no other kernel, no host
    backend; then the cross-round batch of 64 certificates (2 forged) in
    one launch pair. Counts are set to 0 just before each call and read
    just after. Then 9 calls a committee by the host clock, beside the
    oracle's time (backend ``"host"``) on the same certificates."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import bls_kernel as K
    from bdls_tpu_torch.ops import ecdsa

    os.environ.pop("BDLS_CERT_BACKEND", None)
    csp = TorchCSP(device="cuda", use_cpu_fallback=False)
    out = {}

    def counted(certs, aggs, want, label):
        ecdsa.reset_launches()
        K.reset_launches()
        t0 = time.perf_counter()
        got = csp.verify_certificates(certs, aggs)
        ms = (time.perf_counter() - t0) * 1e3
        seen = (dict(K.LAUNCHES_BLS), dict(ecdsa.LAUNCHES),
                dict(ecdsa.LAUNCHES_PINNED), dict(ecdsa.LAUNCHES_LATENCY))
        log(f"certificates, {label}: {ms:.1f} ms, K9 launches {seen[0]}, "
            f"K1 {seen[1]}, K2 {seen[2]}, K3 {seen[3]}; "
            f"{sum(got)} of {len(got)} valid")
        if got != want:
            raise SystemExit(f"certificates {label}: verdicts differ")
        if seen[0] != {"miller": 1, "final": 1, "final_full": 0} or any(
                v for d_ in seen[1:] for v in d_.values()):
            raise SystemExit(f"certificates {label}: launches {seen}")
        return ms

    for n, q in CERT_COMMITTEES:
        certs = cert_in[n]["pair"]
        aggs = [cert_in[n]["agg"]] * len(certs)
        csp.verify_certificates(certs, aggs)            # warm
        first = counted(certs, aggs, [True, True],
                        f"{n} validators, 2 a call")
        runs = []
        for _ in range(9):
            t0 = time.perf_counter()
            if csp.verify_certificates(certs, aggs) != [True, True]:
                raise SystemExit("certificates: verdicts differ")
            runs.append((time.perf_counter() - t0) * 1e3)
        runs.sort()
        t0 = time.perf_counter()
        host = csp.verify_certificates(certs, aggs, backend="host")
        host_ms = (time.perf_counter() - t0) * 1e3
        if host != [True, True]:
            raise SystemExit("certificates: the oracle disagrees")
        log(f"certificates, {n} validators (quorum {q}), 2 a call: median "
            f"{runs[4]:.2f} ms (min {runs[0]:.2f}, max {runs[-1]:.2f}) over "
            f"9 calls; the oracle (backend host) {host_ms:.0f} ms")
        out[n] = {"quorum": q, "first_ms": first, "ms_runs": runs,
                  "median_ms": runs[4], "host_ms": host_ms,
                  "launches": {"miller": 1, "final": 1}}
    certs, aggs, want = cert_in["batch"]
    ms = counted(certs, aggs, want, f"cross-round batch of {len(certs)}")
    out["batch"] = {"certs": len(certs), "forged": want.count(False),
                    "ms": ms, "launches": {"miller": 1, "final": 1}}
    if csp._c_cert_host.value() != 2 * len(CERT_COMMITTEES):
        raise SystemExit("certificates: the host backend ran unasked")
    csp.close()
    return out


def pair_twisted(q) -> list[bool]:
    """Each pair's form by ``csrc/bls12.cuh:pair_twisted``, from the
    Miller launch's (Qx, Qy, Px, Py) words: twisted when Qx is zero
    outside flat coefficients {4, 10}, Qy outside {3, 9} and Px, Py
    outside {0}."""
    from bdls_tpu_torch.ops import bls_host as B
    from bdls_tpu_torch.ops import bls_kernel as K

    keep = ((4, 10), (3, 9), (0,), (0,))
    coords = [K.words_to_ints(a) for a in q]
    return [all(c in kc or cv[c][i] % B.P == 0
                for cv, kc in zip(coords, keep) for c in range(12))
            for i in range(q[0].shape[-1])]


def tile_bls(checked, b: int, lanes, dev) -> tuple[list, list]:
    """Phase 3d's eight word arrays tiled to ``b`` certificates from
    ``lanes`` (indices), and the verdicts they must give."""
    want = checked["want_raw"]
    pick = [lanes[i % len(lanes)] for i in range(b)]
    idx = torch.tensor(pick, device=dev)
    return ([a.index_select(-1, idx).contiguous() for a in checked["args"]],
            [want[i] for i in pick])


def miller_args(args) -> list:
    """The Miller launch's (Qx, Qy, Px, Py) over the 2B pairs."""
    return [torch.cat([args[a], args[b]], -1)
            for a, b in ((2, 6), (3, 7), (0, 4), (1, 5))]


def time_bls(checked, sm_clock_hz, dev) -> dict:
    """Phase 7e: K9 with CUDA events, a warm launch and 5 timed, at 1, 2,
    16 and 128 certificates (phase 3d's twisted lanes, a certificate's
    traffic, tiled, verdicts checked): the Miller launch over the 2B
    pairs and the final launch, each with its bound; then the Miller
    launch over all-dense batches of 1 and 2 certificates (every
    signature off the twist's image: phase 3d's ``pt_add(sig, G1)`` and
    y = 0 lanes), a forged certificate's cost."""
    from bdls_tpu_torch.ops import bls_kernel as K

    out = {}
    for b in (1, 2, 16, 128):
        args, want = tile_bls(checked, b, checked["twisted_lanes"], dev)
        if K.verify_bls_cuda(*args).cpu().tolist() != want:
            raise SystemExit(f"K9 B={b}: verdicts differ")
        q = miller_args(args)
        n, d = K.miller_cuda(*q)
        row = {"miller_ms": cuda_ms(lambda: K.miller_cuda(*q), 5),
               "final_ms": cuda_ms(lambda: K.final_cuda(n, d), 5)}
        for k in ("miller", "final"):
            bms, by = k9_bound_ms(k, b, sm_clock_hz)
            row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = bms, by
        row["ms"] = row["miller_ms"] + row["final_ms"]
        row["certs_per_s"] = b / row["ms"] * 1e3
        out[b] = row
        log(f"K9 B={b}: Miller {row['miller_ms']:.3f} ms (bound "
            f"{row['miller_bound_ms']:.5f} ms, {row['miller_bound_by']}), "
            f"final {row['final_ms']:.3f} ms (bound "
            f"{row['final_bound_ms']:.5f} ms), {row['certs_per_s']:.1f} "
            f"certificates/s")
    for b in (1, 2):
        args, want = tile_bls(checked, b, checked["dense_lanes"], dev)
        if K.verify_bls_cuda(*args).cpu().tolist() != want:
            raise SystemExit(f"K9 all-dense B={b}: verdicts differ")
        q = miller_args(args)
        ms = cuda_ms(lambda: K.miller_cuda(*q), 3)
        out[f"dense {b}"] = {"miller_ms": ms}
        log(f"K9 all-dense B={b}: Miller {ms:.3f} ms")
    return out


# ------------------------------------------------- K4 and K5 (kernel fields)
# 32-bit multiplies of one modular product at the least work known, for
# K5's bound: a schoolbook 256 x 256-bit product and a Montgomery
# reduction (the moduli of the check include the orders n, which have no
# special form)
K5_PRODUCT_MULS = MUL + RED_N
K5_PRODUCTS = 65536
# phases 3e's and 3f's ragged batch: 512 one-warp blocks and one lane
# more, so the last warp carries one live group and three filler groups
MXU_RAGGED = 2049
# K5's call alone: one warp, this many dependent calls a thread
K5_CHAIN = 4096


# the kernels whose -Xptxas -v lines are kept, by the name in their
# mangled entry (a longer name first where one holds another)
PTXAS_KERNELS = ("verify_kernel_count", "pinned_kernel_count",
                 "mont16_kernel_count", "verify_kernel", "pinned_kernel",
                 "mont16_kernel", "block_lane_kernel", "block_tally_kernel",
                 "sha256_kernel", "ed25519_kernel", "bls_miller_kernel",
                 "bls_final_full_kernel", "bls_final_kernel")


def ptxas_lines(ptxas: dict) -> dict:
    """Each kernel's ``-Xptxas -v`` lines (registers, stack frame,
    spills) from :func:`bdls_tpu_torch.ops._build.build`'s reports, keyed
    ``name<Curve>`` (`` [mxu]`` for an mxu build); a called function's
    frame (K5's warp calls, K11's noinline steps) is not recorded here
    (:func:`ptxas_functions` has them)."""
    regs = {}
    for key, report in ptxas.items():
        cur = entry = None
        active = False
        build = " [mxu]" if key.endswith(":mxu") else ""
        for line in report.splitlines():
            if "Function properties for" in line:
                active = entry is not None and line.rstrip().endswith(entry)
            elif "Compiling entry" in line:
                entry = line.split("'")[1]
                active = True
                kern = next((k for k in PTXAS_KERNELS if k in entry), None)
                curve = ("<CurveP256>" if "CurveP256" in entry else
                         "<CurveK256>" if "CurveK256" in entry else "")
                cur = kern and kern + curve + build
            elif cur and active and re.search(r"Used \d+ registers|spill",
                                              line):
                regs.setdefault(cur, []).append(line.strip())
    return regs


def ptxas_functions(report: str) -> dict:
    """Every function's ``-Xptxas -v`` frame and spill line in one
    build's report, the called (noinline) functions' included, by
    mangled name."""
    out, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and "stack frame" in line:
            out[name] = line.strip()
            name = None
    return out


def lane_args(lanes, dev) -> list:
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs

    return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
            for c in vectors.columns(lanes)]


def launch_counts() -> dict:
    """Every kernel's launch count, keyed by kernel and build."""
    from bdls_tpu_torch.ops import block_verify, ecdsa
    from bdls_tpu_torch.ops import ed25519 as ed

    from bdls_tpu_torch.parallel import mesh as pmesh

    return {"K1": dict(ecdsa.LAUNCHES), "K1+K5": dict(ecdsa.LAUNCHES_MXU),
            "K2": dict(ecdsa.LAUNCHES_PINNED),
            "K2+K5": dict(ecdsa.LAUNCHES_PINNED_MXU),
            "K3": dict(ecdsa.LAUNCHES_LATENCY),
            "K3+K5": dict(ecdsa.LAUNCHES_LATENCY_MXU),
            "K4": dict(ecdsa.LAUNCHES_MONT16),
            "K7": dict(block_verify.LAUNCHES_BLOCK),
            "K7+K5": dict(block_verify.LAUNCHES_BLOCK_MXU),
            "K8": dict(ed.LAUNCHES_ED25519),
            "K8+K5": dict(ed.LAUNCHES_ED25519_MXU),
            "K10": dict(pmesh.LAUNCHES_MESH)}


def nonzero_counts() -> dict:
    return {k: {c: v for c, v in d.items() if v}
            for k, d in launch_counts().items() if any(d.values())}


def check_mont16_kernel(batch, truth, rng, dev) -> dict:
    """Phase 3e: K4 (a thread group a lane, ``csrc/mont16_group.cuh``)
    against its plain twin on the card and the integer ECDSA, lane for
    lane, at the main buckets (128 secp256k1 lanes, 32 one-warp blocks;
    2048 P-256 lanes, 512 blocks) and at a ragged MXU_RAGGED P-256 lanes
    (the last warp one live group and three fillers): phase 3's lanes,
    the hostile set (r or s of 0, n or 2^256 - 1, Q off the curve or (0,
    0), the forged r + n lane, tampered digests) and the lanes that take
    each of the ladder's exceptional selects (``vectors.select_lanes``),
    filled up with the main path's requests."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    per = ecdsa.lanes_per_block("vpu")
    cases = [(c, batch[c], truth[c]) for c in CURVES]
    idx = [i % len(batch["P-256"]) for i in range(MXU_RAGGED)]
    cases.append(("P-256", [batch["P-256"][i] for i in idx],
                  truth["P-256"][idx]))
    for curve_name, lanes, want in cases:
        cv = CURVES[curve_name]
        sel = vectors.select_lanes(curve_name, rng)
        lanes = sel + list(lanes[:len(lanes) - len(sel)])
        want = np.concatenate([vectors.expected(curve_name, sel),
                               want[:len(want) - len(sel)]])
        if not any(ln[5] == "s = n" for ln in lanes):
            raise SystemExit("phase 3e: the s = n lane is missing")
        args = lane_args(lanes, dev)
        kern = ecdsa.verify_mont16_cuda(cv, *args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ecdsa.verify_kernel(cv, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: K4 vs plain on {len(lanes)} lanes "
            f"({-(-len(lanes) // per)} blocks of {per} lanes, "
            f"{len(sel)} select lanes): {int(diff.sum())} differ {bad}; "
            f"valid {int(kern.sum())}; plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: K4 disagrees with its plain twin")
        if not np.array_equal(kern, want):
            raise SystemExit(f"{curve_name}: K4 disagrees with SwCSP")
        key = curve_name + (" ragged" if len(lanes) == MXU_RAGGED else "")
        out[key] = {"max_abs_err": int(diff.max()), "plain_ms": plain_ms,
                    "lanes": len(lanes)}
    return out


def _words(xs) -> np.ndarray:
    return np.array([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for x in xs], np.uint32)


def _field_mul(engine: str, mod: int, a, b):
    from bdls_tpu_torch.ops import _build

    out = torch.empty_like(a)
    _build.check(_build.lib(engine).bdls_field_mul(
        mod, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
        torch.cuda.current_stream().cuda_stream), "bdls_field_mul")
    return out


def check_mxu(batch, truth, pinned, checked, ed_checked, rng, dev) -> dict:
    """Phase 3f: K5's warp call (the mxu builds' product) against the
    CIOS mont_mul and Python integers, bit for bit, on the five moduli at
    edge values and 4096 seeded pairs each; then each mxu build against
    its vpu kernel and its plain twin under the "mxu" engine (timed for
    the record) on the inputs of phases 3 (K1), 4 (K2) and 3c (K8) at
    128, 2048 and 8192 lanes and at a ragged MXU_RAGGED (the counting
    builds of K1 and K2 there too), and of 4b (K7, lane for lane and tx
    for tx, at the main block shape)."""
    from bdls_tpu_torch.ops import block_verify as bv
    from bdls_tpu_torch.ops import ecdsa, fold
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import CURVES, ED25519, EDWARDS_CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold, \
        verify_fold_pinned

    out = {"product": {}}
    R = 1 << 256
    mods = [CURVES["P-256"].fp, CURVES["P-256"].fn, CURVES["secp256k1"].fp,
            CURVES["secp256k1"].fn, EDWARDS_CURVES["ed25519"].fp]
    names = ["P-256 p", "P-256 n", "secp256k1 p", "secp256k1 n",
             "2^255 - 19"]
    for i, (ctx, name) in enumerate(zip(mods, names)):
        m = ctx.modulus
        edge = [0, 1, 2, m - 1, m - 2, m, m + 1, R - 1, R - 2, 1 << 255,
                (1 << 224) - 1, R - m]
        xs = edge + [int.from_bytes(rng.bytes(32), "big")
                     for _ in range(4096)]
        ys = [v % m for v in edge[::-1]] + [
            int.from_bytes(rng.bytes(32), "big") % m for _ in range(4096)]
        a = torch.from_numpy(_words(xs).view(np.int32)).to(dev)
        b = torch.from_numpy(_words(ys).view(np.int32)).to(dev)
        cios = _field_mul("vpu", i, a, b).cpu().numpy().view(np.uint32)
        mma = _field_mul("mxu", i, a, b).cpu().numpy().view(np.uint32)
        got = [sum(int(r[k]) << (32 * k) for k in range(8)) for r in mma]
        want = [x * y * pow(R, -1, m) % m for x, y in zip(xs, ys)]
        ndiff = int((cios != mma).any(axis=1).sum())
        nbad = sum(g != w for g, w in zip(got, want))
        log(f"K5 product mod {name}: {len(xs)} pairs, {ndiff} differ from "
            f"the CIOS product, {nbad} from the integers")
        if ndiff or nbad:
            raise SystemExit(f"K5 product mod {name}: disagrees")
        out["product"][name] = {"pairs": len(xs), "max_abs_err": 0}

    def compare(what, kern, vpu, want=None):
        diff = np.abs(kern.astype(np.int64) - vpu.astype(np.int64))
        if diff.any() or (want is not None and not np.array_equal(kern,
                                                                  want)):
            raise SystemExit(f"{what}: the mxu build disagrees")
        return int(diff.max())

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fold.mul_backend("mxu"):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, res

    def np_of(t):
        return t.cpu().numpy()

    # each build at the buckets and at a ragged B (the last warp's last
    # group a part one): the lanes of phases 3, 4 and 3c tiled, against
    # the vpu kernel on the same lanes and the plain twin under "mxu" (run
    # once on the distinct lanes, its verdicts tiled like the lanes)
    sizes = BUCKETS + (MXU_RAGGED,)
    for curve_name, cv in CURVES.items():
        lanes, want = batch[curve_name], truth[curve_name]
        base = lane_args(lanes, dev)
        ms, plain = plain_ms(lambda: verify_fold(cv, *base))
        compare(f"{curve_name} K1 plain", np_of(plain), want)
        out[f"K1 {curve_name}"] = {"max_abs_err": 0, "plain_ms": ms,
                                   "lanes": len(lanes)}
        res = pinned[curve_name]
        pbase = _pinned_args(res["lanes"], res["slots"], dev)
        pms, pplain = plain_ms(lambda: verify_fold_pinned(cv, *pbase,
                                                          res["pools"]))
        compare(f"{curve_name} K2 plain", np_of(pplain), res["want"])
        out[f"K2 {curve_name}"] = {"max_abs_err": 0, "plain_ms": pms,
                                   "lanes": len(res["lanes"])}
        for b in sizes:
            idx = [i % len(lanes) for i in range(b)]
            args = lane_args([lanes[i] for i in idx], dev)
            kern = np_of(ecdsa.verify_fold_cuda(cv, *args, engine="mxu"))
            vpu = np_of(ecdsa.verify_fold_cuda(cv, *args))
            err = compare(f"{curve_name} K1 B={b}", kern, vpu, want[idx])
            compare(f"{curve_name} K1 B={b} plain", np_of(plain)[idx], kern)
            out[f"K1 {curve_name}"]["max_abs_err"] = max(
                err, out[f"K1 {curve_name}"]["max_abs_err"])
            pidx = [i % len(res["lanes"]) for i in range(b)]
            pargs = _pinned_args([res["lanes"][i] for i in pidx],
                                 [res["slots"][i] for i in pidx], dev)
            kern = np_of(ecdsa.verify_pinned_cuda(cv, *pargs, res["pools"],
                                                  engine="mxu"))
            vpu = np_of(ecdsa.verify_pinned_cuda(cv, *pargs, res["pools"]))
            err = compare(f"{curve_name} K2 B={b}", kern, vpu,
                          res["want"][pidx])
            compare(f"{curve_name} K2 B={b} plain", np_of(pplain)[pidx],
                    kern)
            out[f"K2 {curve_name}"]["max_abs_err"] = max(
                err, out[f"K2 {curve_name}"]["max_abs_err"])
            if b != MXU_RAGGED:
                continue
            # the counting builds (K10's shards) at the ragged B: the
            # verdicts and a partial a block of lanes_per_block lanes
            mask = torch.from_numpy(rng.integers(0, 2, b).astype(bool)) \
                .to(dev)
            per = ecdsa.lanes_per_block("mxu")
            for kname, run in (
                    ("K1", lambda **kw: ecdsa.verify_fold_cuda(cv, *args,
                                                               **kw)),
                    ("K2", lambda **kw: ecdsa.verify_pinned_cuda(
                        cv, *pargs, res["pools"], **kw))):
                ok_m, part_m = run(engine="mxu", mask=mask)
                ok_v, part_v = run(mask=mask)
                truth_b = (want[idx] if kname == "K1"
                           else res["want"][pidx])
                compare(f"{curve_name} {kname} count B={b}", np_of(ok_m),
                        np_of(ok_v), truth_b)
                count = int((torch.from_numpy(truth_b).to(dev) & mask)
                            .sum())
                got = int(part_m.to(torch.int64).sum())
                if (got != count or part_m.shape != (-(-b // per),)
                        or int(part_v.to(torch.int64).sum()) != count):
                    raise SystemExit(f"{curve_name} {kname} counting "
                                     f"build B={b}: {got} != {count}")
                out[f"{kname} count {curve_name}"] = {
                    "lanes": b, "count": got, "partials": len(part_m)}
        ts = checked[curve_name]["ts"]
        kf, kv = bv.verify_block_cuda(cv, *ts, engine="mxu")
        vf_, vv = bv.verify_block_cuda(cv, *ts)
        ms, (pf, pv) = plain_ms(lambda: bv.block_kernel(cv, *ts))
        err = max(compare(f"{curve_name} K7 lanes", np_of(kv), np_of(vv)),
                  compare(f"{curve_name} K7 txs", np_of(kf), np_of(vf_)))
        compare(f"{curve_name} K7 plain", np_of(pf), np_of(kf))
        compare(f"{curve_name} K7 plain lanes", np_of(pv), np_of(kv))
        out[f"K7 {curve_name}"] = {"max_abs_err": err, "plain_ms": ms,
                                   "shape": checked[curve_name]["shape"]}
        log(f"{curve_name}: K1 and K2 mxu builds equal their vpu kernels "
            f"and plain twins at {sizes} lanes, the counting builds at "
            f"{MXU_RAGGED}; K7's at the main block shape, lane for lane "
            f"and tx for tx (plain under mxu: K1 "
            f"{out[f'K1 {curve_name}']['plain_ms']:.0f} ms, K2 "
            f"{out[f'K2 {curve_name}']['plain_ms']:.0f} ms, K7 "
            f"{out[f'K7 {curve_name}']['plain_ms']:.0f} ms)")
    c = ed_checked[2048]
    eall = [torch.from_numpy(x.view(np.int32)).to(dev)
            for x in ed.lanes_to_limbs(c["rows"])]
    ms, eplain = plain_ms(lambda: ed.verify_ed25519(ED25519, *eall))
    compare("K8 plain", np_of(eplain), c["want"])
    out["K8 2048"] = {"max_abs_err": 0, "plain_ms": ms}
    for b in sizes:
        idx = [i % len(c["rows"]) for i in range(b)]
        eargs = [torch.from_numpy(x.view(np.int32)).to(dev)
                 for x in ed.lanes_to_limbs([c["rows"][i] for i in idx])]
        kern = np_of(ed.verify_ed25519_cuda(*eargs, engine="mxu"))
        vpu = np_of(ed.verify_ed25519_cuda(*eargs))
        err = compare(f"K8 B={b}", kern, vpu, c["want"][idx])
        compare(f"K8 B={b} plain", np_of(eplain)[idx], kern)
        out["K8 2048"]["max_abs_err"] = max(err,
                                            out["K8 2048"]["max_abs_err"])
    log(f"ed25519: K8 mxu build equals its vpu kernel and plain twin at "
        f"{sizes} lanes (plain under mxu {ms:.0f} ms on 2048)")
    return out


def drive_field_main_path(field, votes, vote_ok, block, block_ok, pin, blk,
                          ed_in) -> dict:
    """Phases 5b (``kernel_field="mont16"``) and 5c (``"mxu"``): the main
    path through ``TorchCSP(device="cuda", kernel_field=field)``. Each run
    sets every count to 0 just before and reads them just after, and must
    launch exactly the kernels the field names:

    - the 128-vote secp256k1 round (``submit`` + ``flush``, key cache
      off): mont16 counts a cold fallback and launches K4 once; mxu
      replays K3 over K1 + K5 once;
    - the 2000-lane P-256 batch: one K4, or one K1 + K5;
    - the vote round through ``CspBatchVerifier`` with 128 consenters
      pinned (one new key): K2 (mont16) or K2 + K5 (mxu) for 127 lanes,
      K4 or K1 + K5 for the new key; the pinned block batch, one K2 or
      K2 + K5 launch;
    - ``verify_block`` of the 1000-tx block: one K7 (mont16 runs the fold
      program's) or K7 + K5; mxu adds the secp256k1 block and the
      85-vote Ed25519 round (one K8 + K5 launch)."""
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        identity_keys
    from bdls_tpu_torch.crypto import blocklane
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES

    mx = field == "mxu"
    gen = "K1+K5" if mx else "K4"
    pin_k = "K2+K5" if mx else "K2"
    out = {}

    def run(what, fn, want, expect):
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = fn()
        ms = (time.perf_counter() - t) * 1e3
        seen = nonzero_counts()
        log(f"[{field}] {what}: {ms:.2f} ms, launches {seen}")
        if got != want:
            raise SystemExit(f"[{field}] {what}: verdicts differ")
        if seen != expect:
            raise SystemExit(f"[{field}] {what}: launches {seen}, want "
                             f"{expect}")
        out[what] = {"ms": ms, "launches": seen}
        return seen

    csp = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   flush_interval=1.0, kernel_field=field)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    cold = csp.stats["latency_cold_fallbacks"]

    def vote_round():
        futs = [csp.submit(v) for v in votes]
        csp.flush()
        return [f.result(60) for f in futs]

    run("vote round, 128 secp256k1 lanes", vote_round, vote_ok,
        {"K3+K5": {"secp256k1": 1}} if mx else {"K4": {"secp256k1": 1}})
    cold = csp.stats["latency_cold_fallbacks"] - cold
    if cold != (0 if mx else 1):
        raise SystemExit(f"[{field}] vote round: {cold} cold fallbacks")
    run("block batch, 2000 P-256 lanes", lambda: csp.verify_batch(block),
        block_ok, {gen: {"P-256": 1}})
    if csp.stats["fallbacks"]:
        raise SystemExit(f"[{field}] fallbacks {csp.stats}")
    csp.close()
    out["cold_fallbacks"] = cold

    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0,
                   kernel_field=field)
    csp.warmup([("secp256k1", 128), ("P-256", 2048)])
    verifier = CspBatchVerifier(csp, consenters=pin["idents"])
    csp.warm_keys(identity_keys(pin["idents"]), wait=True)
    csp.warm_keys(pin["endorsers"], wait=True)
    before = csp.stats["pinned_lanes"]
    run("vote round through the seam, 128 envelopes, one new key",
        lambda: verifier.verify_envelopes(pin["envs"]), pin["env_ok"],
        {pin_k: {"secp256k1": 1}, gen: {"secp256k1": 1}})
    if csp.stats["pinned_lanes"] - before != 127:
        raise SystemExit(f"[{field}] pinned lanes {csp.stats}")
    run("pinned block batch, 2000 lanes from 16 endorsers",
        lambda: csp.verify_batch(pin["block"]), pin["block_ok"],
        {pin_k: {"P-256": 1}})
    sw = SwCSP()
    host = blocklane.verify_block_host(sw.verify_batch, blk["main"]).tolist()
    run("verify_block, the 1000-tx block",
        lambda: csp.verify_block(blk["main"]).tolist(), host,
        {"K7+K5" if mx else "K7": {"P-256": 1}})
    if mx:
        host = blocklane.verify_block_host(sw.verify_batch,
                                           blk["secp256k1"]).tolist()
        run("verify_block, the 50-tx secp256k1 block",
            lambda: csp.verify_block(blk["secp256k1"]).tolist(), host,
            {"K7+K5": {"secp256k1": 1}})
        reqs, oks = ed_in[128]
        csp.warmup([("ed25519", 128)])

        def ed_round():
            futs = [csp.submit(q) for q in reqs]
            csp.flush()
            return [f.result(60) for f in futs]

        run("Ed25519 round, 85 votes of 128", ed_round, oks,
            {"K8+K5": {"ed25519": 1}})
    if csp.stats["fallbacks"] or csp.stats["kernel"] != field:
        raise SystemExit(f"[{field}] stats {csp.stats}")
    csp.close()
    return out


def time_k4k5(batch, truth, pinned, checked, ed_checked, blk_packed,
              sm_clock_hz, dev) -> dict:
    """Phase 7f: K4 and each mxu build with CUDA events at 128, 2048 and
    8192 lanes (phase 3's, 4's and 3c's batches tiled, verdicts checked),
    a K3 replay over K1 + K5 at 128 secp256k1 lanes, K7 + K5 at the main
    block shape, each beside its bound from
    :func:`needed_muls`, :func:`needed_muls_pinned`,
    :func:`needed_muls_ed25519` and :func:`block_bound_ms` (the least
    work of the function, whatever computes it); and K5's product alone:
    the mxu and CIOS ``bdls_field_mul`` over 65,536 products mod the
    P-256 order, its plain twin (``fold.mul`` under "mxu") and one
    ``torch.matmul`` in float64 of the plain twin's contraction (the
    0/1 selector by the outer products) on the same operands; and its
    latency, one warp's chain of K5_CHAIN dependent calls
    (``bdls_field_chain``) beside the vpu bodies' product on each thread,
    on the five moduli."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import _build, block_verify as bv
    from bdls_tpu_torch.ops import ecdsa, fold, mxu
    from bdls_tpu_torch.ops import ed25519 as ed
    from bdls_tpu_torch.ops.curves import CURVES

    out = {}
    for curve_name, cv in CURVES.items():
        lanes, want = batch[curve_name], truth[curve_name]
        res = pinned[curve_name]
        rse = [(ln[2], ln[3], int.from_bytes(ln[4], "big"))
               for ln in res["lanes"]]
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            tiled = [lanes[i] for i in idx]
            args = lane_args(tiled, dev)
            reps = 10 if b <= 2048 else 5
            bms, by = bound_ms(cv, tiled, sm_clock_hz)
            for kern, fn in (
                    ("K4", lambda: ecdsa.verify_mont16_cuda(cv, *args)),
                    ("K1+K5", lambda: ecdsa.verify_fold_cuda(
                        cv, *args, engine="mxu"))):
                if not np.array_equal(fn().cpu().numpy(), want[idx]):
                    raise SystemExit(f"{kern} {curve_name} B={b}: verdicts "
                                     f"differ")
                ms = cuda_ms(fn, reps)
                out.setdefault(f"{kern} {curve_name}", {})[b] = {
                    "ms": ms, "verifies_per_s": b / ms * 1e3,
                    "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}
                log(f"{kern} {curve_name} B={b}: kernel {ms:.3f} ms, bound "
                    f"{bms:.4f} ms ({by}, {bms / ms:.2%})")
            if curve_name == "secp256k1" and b == 128:
                # K3 over K1 + K5: a captured slot's replay (copies
                # included), as the vote round launches it
                slot = ecdsa.LatencySlot(cv, b, device=dev, field="mxu",
                                         stream=torch.cuda.current_stream())
                slot.stage([ints_to_limbs(c)
                            for c in vectors.columns(tiled)])
                slot.launch().synchronize()
                if not np.array_equal(slot.verdict(), want[idx]):
                    raise SystemExit("K3+K5: verdicts differ")
                ms = cuda_ms(slot.launch, reps)
                out["K3+K5 secp256k1"] = {b: {
                    "ms": ms, "verifies_per_s": b / ms * 1e3,
                    "bound_ms": bms, "bound_by": by, "bound_share": bms / ms}}
                log(f"K3+K5 secp256k1 B={b}: replay {ms:.3f} ms, bound "
                    f"{bms:.4f} ms ({by})")
            pidx = [i % len(res["lanes"]) for i in range(b)]
            pargs = _pinned_args([res["lanes"][i] for i in pidx],
                                 [res["slots"][i] for i in pidx], dev)

            def k2():
                return ecdsa.verify_pinned_cuda(cv, *pargs, res["pools"],
                                                engine="mxu")

            if not np.array_equal(k2().cpu().numpy(), res["want"][pidx]):
                raise SystemExit(f"K2+K5 {curve_name} B={b}: verdicts differ")
            ms = cuda_ms(k2, reps)
            bms, by = pinned_bound_ms(cv, [rse[i] for i in pidx],
                                      [res["slots"][i] for i in pidx],
                                      sm_clock_hz)
            out.setdefault(f"K2+K5 {curve_name}", {})[b] = {
                "ms": ms, "verifies_per_s": b / ms * 1e3, "bound_ms": bms,
                "bound_by": by, "bound_share": bms / ms}
            log(f"K2+K5 {curve_name} B={b}: kernel {ms:.3f} ms, bound "
                f"{bms:.4f} ms ({by}, {bms / ms:.2%})")
    cv = CURVES["P-256"]
    ts = packed_on(blk_packed, dev)
    ms = cuda_ms(lambda: bv.verify_block_cuda(cv, *ts, engine="mxu"), 5)
    bms, by = block_bound_ms(cv, blk_packed, sm_clock_hz)
    out["K7+K5 P-256"] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                          "shape": checked["P-256"]["shape"]}
    log(f"K7+K5 P-256 at the main block shape: kernel {ms:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    base = ed_checked[2048]
    for b in BUCKETS:
        idx = [i % len(base["rows"]) for i in range(b)]
        rows = [base["rows"][i] for i in idx]
        eargs = [torch.from_numpy(a.view(np.int32)).to(dev)
                 for a in ed.lanes_to_limbs(rows)]

        def k8():
            return ed.verify_ed25519_cuda(*eargs, engine="mxu")

        if not np.array_equal(k8().cpu().numpy(), base["want"][idx]):
            raise SystemExit(f"K8+K5 B={b}: verdicts differ")
        ms = cuda_ms(k8, 5 if b <= 2048 else 3)
        bms, by = ed25519_bound_ms(rows, sm_clock_hz)
        out.setdefault("K8+K5", {})[b] = {
            "ms": ms, "verifies_per_s": b / ms * 1e3, "bound_ms": bms,
            "bound_by": by, "bound_share": bms / ms}
        log(f"K8+K5 B={b}: kernel {ms:.3f} ms, bound {bms:.4f} ms ({by})")

    # K5's product alone, mod the P-256 order
    ctx = CURVES["P-256"].fn
    m, n = ctx.modulus, K5_PRODUCTS
    rng = np.random.default_rng(SEED + 6)
    xs = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "big") % m for _ in range(n)]
    a = torch.from_numpy(_words(xs).view(np.int32)).to(dev)
    b = torch.from_numpy(_words(ys).view(np.int32)).to(dev)
    mxu_ms = cuda_ms(lambda: _field_mul("mxu", 1, a, b), 10)
    cios_ms = cuda_ms(lambda: _field_mul("vpu", 1, a, b), 10)
    fa = fold.from_limbs16(lane_args([(x, 0, 0, 0, b"", "")
                                      for x in xs], dev)[0])
    fb = fold.from_limbs16(lane_args([(y, 0, 0, 0, b"", "")
                                      for y in ys], dev)[0])
    fctx = fold.fold_ctx(m)
    with fold.mul_backend("mxu"):
        fold.mul(fctx, fa, fb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold.mul(fctx, fa, fb)
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    diag, outer = mxu.digit_operands(fa, fb)
    lib_ms = cuda_ms(lambda: torch.matmul(diag, outer), 10)
    t_ops = n * K5_PRODUCT_MULS / (SMS * IMUL_PER_CLK_PER_SM * sm_clock_hz)
    t_bytes = 3 * 32 * n / PEAK_BYTES_PER_S
    bms = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    # K5's call alone: one warp, K5_CHAIN dependent calls a thread
    # (x <- x·y), beside the vpu bodies' product on each thread of a warp
    # (mont_mul_cs; mul_25519 mod 2^255 - 19), each chain's end checked
    # against Python integers on all 32 threads
    from bdls_tpu_torch.ops.curves import EDWARDS_CURVES

    calls = {}
    R = 1 << 256
    mods = [(CURVES["P-256"].fp, "P-256 p"), (CURVES["P-256"].fn, "P-256 n"),
            (CURVES["secp256k1"].fp, "secp256k1 p"),
            (CURVES["secp256k1"].fn, "secp256k1 n"),
            (EDWARDS_CURVES["ed25519"].fp, "2^255 - 19")]
    stream = torch.cuda.current_stream().cuda_stream
    for i, (mctx, name) in enumerate(mods):
        mm = mctx.modulus
        xs = [int.from_bytes(rng.bytes(32), "big") % mm for _ in range(32)]
        ys = [int.from_bytes(rng.bytes(32), "big") % mm for _ in range(32)]
        ca = torch.from_numpy(_words(xs).view(np.int32)).to(dev)
        cb = torch.from_numpy(_words(ys).view(np.int32)).to(dev)
        yy = ys if i == 4 else [y * pow(R, -1, mm) % mm for y in ys]
        want = [x * pow(y, K5_CHAIN, mm) % mm for x, y in zip(xs, yy)]
        for eng in ("mxu", "vpu"):
            co = torch.empty_like(ca)

            def run(eng=eng, co=co):
                _build.check(_build.lib(eng).bdls_field_chain(
                    i, ca.data_ptr(), cb.data_ptr(), co.data_ptr(),
                    K5_CHAIN, stream), "bdls_field_chain")

            run()
            torch.cuda.synchronize()
            got = [sum(int(r[k]) << (32 * k) for k in range(8))
                   for r in co.cpu().numpy().view(np.uint32)]
            if got != want:
                raise SystemExit(f"bdls_field_chain[{eng}] mod {name}: "
                                 f"wrong")
            calls.setdefault(name, {})[eng] = \
                cuda_ms(run, 3) * 1e6 / K5_CHAIN
        log(f"K5 call mod {name}: {calls[name]['mxu']:.1f} ns a call of "
            f"the warp (32 products), against "
            f"{'mul_25519' if i == 4 else 'mont_mul_cs'} on each thread "
            f"{calls[name]['vpu']:.1f} ns ({K5_CHAIN} dependent calls)")
    out["K5 product"] = {"ms": mxu_ms, "cios_ms": cios_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bms, "bound_by": by, "products": n,
                         "call_ns": calls}
    log(f"K5 product, {n} Montgomery products mod the P-256 order: mxu "
        f"{mxu_ms:.3f} ms, CIOS {cios_ms:.3f} ms, bound {bms:.5f} ms ({by}); "
        f"plain twin (fold.mul under mxu) {plain_ms:.1f} ms; torch.matmul "
        f"float64 of its contraction ({tuple(diag.shape)} x "
        f"{tuple(outer.shape)}) {lib_ms:.3f} ms")
    return out


# ------------------------------------------------ K10 (mesh) and K11 (full FE)
# bytes of K10's own work on one shard of L lanes: the verdict and mask
# bytes in, the uint32 count out
def count_bytes(lanes: int, shards: int = 1) -> int:
    return 2 * lanes + 4 * shards


def count_bound_ms(lanes: int) -> tuple[float, str]:
    """The masked count's bound: its bytes once at the memory rate (no
    multiply; its adds are far below the integer rate)."""
    return count_bytes(lanes) / PEAK_BYTES_PER_S * 1e3, "bytes"


def split_bound_ms(cv, lanes, shards: int,
                   sm_clock_hz: float) -> tuple[float, str]:
    """K10's bound: the per-shard program's (K1's, :func:`bound_ms`, on
    the same lanes) plus the count's bytes."""
    bms, by = bound_ms(cv, lanes, sm_clock_hz)
    return (bms + count_bytes(len(lanes), shards) / PEAK_BYTES_PER_S * 1e3,
            by)


def k11_bound_ms(lanes: int, sm_clock_hz: float) -> tuple[float, str]:
    """K11's bound at ``lanes`` certificates: the least known work of the
    exact exponent (p^12 - 1)/r, one shared final exponentiation a
    certificate. Since 3 | x - 1, the exponent after the easy part is
    (x - 1)^2/3 · (x + p) · (x^2 + p^2 - 1) + 1, the chain of
    :data:`FINAL_M` with the cube's 2 Fp12 products taken off; counted at
    :data:`FINAL_M`, as the final launch of K9. Bytes: both sides' (n, d)
    in, both sides' values and the verdict out."""
    t_ops = FINAL_M * MUL381 * lanes / (SMS * IMUL_PER_CLK_PER_SM
                                        * sm_clock_hz)
    t_bytes = (6 * F12_BYTES + 1) * lanes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _masks(rng, n, dev) -> dict:
    return {"all-on": torch.ones(n, dtype=torch.bool, device=dev),
            "all-off": torch.zeros(n, dtype=torch.bool, device=dev),
            "random": torch.from_numpy(rng.integers(0, 2, n).astype(bool))
            .to(dev)}


def check_mesh(batch, truth, pinned, rng, dev) -> dict:
    """Phase 3g: K10. The fused count: each counting build a shard runs
    (K1, K1 + K5, K4 and K2, ``mask=`` of the launch wrappers) against
    its plain build's verdicts and the plain twin's count
    (``masked_count_plain``) at 2048, 8192 and 2000 lanes (phase 3's and
    4's P-256 lanes, tiled), masks all-on, all-off and random; then the
    split, ``sharded_verify_masked`` and ``pjit_verify_masked`` over a
    two-shard mesh of the one card and a one-shard mesh, against one
    unsplit launch of the same program and the integer ECDSA, lane for
    lane with the same count, at 2048 and 8192 P-256 lanes (phase 3's
    batch, its hostile lanes included, tiled) and a padded 2000-of-2048
    batch (``pad_and_mask``), under ``fold``, ``mxu`` and ``mont16``; and
    ``sharded_verify_pinned``/``pjit_verify_pinned`` over phase 4's
    pools, both curves."""
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.parallel import mesh as pmesh

    out = {"count": {}, "split": {}, "pinned": {}}
    errs = []
    cv = CURVES["P-256"]
    base = lane_args(batch["P-256"], dev)
    pres = pinned["P-256"]
    pbase = _pinned_args(pres["lanes"], pres["slots"], dev)
    for n in (2048, 8192, 2000):
        idx = torch.tensor([i % base[0].shape[1] for i in range(n)],
                           device=dev)
        pidx = torch.tensor([i % len(pres["lanes"]) for i in range(n)],
                            device=dev)
        args = [a.index_select(1, idx).contiguous() for a in base]
        pargs = [a.index_select(-1, pidx).contiguous() for a in pbase]
        programs = {
            "fold": lambda **kw: ecdsa.verify_fold_cuda(cv, *args, **kw),
            "mxu": lambda **kw: ecdsa.verify_fold_cuda(cv, *args,
                                                       engine="mxu", **kw),
            "mont16": lambda **kw: ecdsa.verify_mont16_cuda(cv, *args, **kw),
            "pinned": lambda **kw: ecdsa.verify_pinned_cuda(
                cv, *pargs, pres["pools"], **kw)}
        for prog, run in programs.items():
            whole = run()
            # lanes a block: a thread group a lane, one warp a block, in
            # every build (K4 has the vpu build only)
            per = ecdsa.lanes_per_block("mxu" if prog == "mxu" else "vpu")
            for name, mask in _masks(rng, n, dev).items():
                ok, partial = run(mask=mask)
                got = int(partial.to(torch.int64).sum())
                want = int(pmesh.masked_count_plain(whole, mask))
                errs.append(abs(got - want))
                out["count"][f"{prog} {n} {name}"] = got
                if got != want or not torch.equal(ok, whole):
                    raise SystemExit(f"K10 fused count {prog} n={n} {name}: "
                                     f"{got} != {want}, or the verdicts "
                                     "differ from the plain build's")
                valid = (whole & mask).cpu().numpy()
                valid = np.concatenate([valid, np.zeros(-n % per, bool)])
                blocks = valid.reshape(-1, per).sum(axis=1)
                if partial.cpu().numpy().tolist() != blocks.tolist():
                    raise SystemExit(f"K10 fused count {prog} n={n} {name}: "
                                     f"a block's partial is not the count "
                                     f"of its {per} lanes")
    out["count_max_abs_err"] = max(errs)
    log(f"K10 fused count (K1, K1+K5, K4, K2 counting builds) vs the plain "
        f"twin at 2048/8192/2000 lanes, masks all-on/off/random: equal, "
        f"block by block, verdicts the plain builds' {out['count']}")
    lanes, want = batch["P-256"], truth["P-256"]
    meshes = {"2 shards": pmesh.make_mesh([dev, dev]),
              "1 shard": pmesh.make_mesh([dev])}
    makers = {"sharded": pmesh.sharded_verify_masked,
              "pjit": pmesh.pjit_verify_masked}
    for field in ("fold", "mxu", "mont16"):
        for n_real, total in ((2048, 2048), (8192, 8192), (2000, 2048)):
            idx = [i % len(lanes) for i in range(n_real)]
            arrs = [ints_to_limbs(c)
                    for c in vectors.columns([lanes[i] for i in idx])]
            padded, mask = pmesh.pad_and_mask(arrs, n_real, total)
            truth_ok = list(want[idx]) + [False] * (total - n_real)
            whole = ecdsa.launch_verify(cv, padded, device=dev,
                                        field=field).cpu().tolist()
            if whole != truth_ok:
                raise SystemExit(f"K10 {field} {n_real}/{total}: the "
                                 "unsplit program disagrees with SwCSP")
            for mname, mesh in meshes.items():
                for kname, make in makers.items():
                    ok, n_valid = make(cv, mesh, field=field)(mask, *padded)
                    ok = ok.cpu().tolist()
                    if ok != whole or int(n_valid) != sum(truth_ok):
                        raise SystemExit(
                            f"K10 {kname} {mname} {field} {n_real}/"
                            f"{total}: split != unsplit or count "
                            f"{int(n_valid)} != {int(sum(truth_ok))}")
            out["split"][f"{field} {n_real}/{total}"] = int(sum(truth_ok))
    log(f"K10 split (2 shards and 1 shard of {dev}; sharded and pjit) vs "
        f"the unsplit program and SwCSP, lane for lane, n_valid equal: "
        f"{out['split']}")
    for curve_name, cv in CURVES.items():
        res = pinned[curve_name]
        n = len(res["lanes"]) - len(res["lanes"]) % 2
        args = _pinned_args(res["lanes"][:n], res["slots"][:n], dev)
        whole = ecdsa.verify_pinned_cuda(cv, *args, res["pools"]
                                         ).cpu().tolist()
        if whole != res["want"][:n].tolist():
            raise SystemExit(f"K10 pinned {curve_name}: unsplit disagrees")
        mask = np.ones(n, dtype=bool)
        for mname, mesh in meshes.items():
            for make in (pmesh.sharded_verify_pinned,
                         pmesh.pjit_verify_pinned):
                ok, n_valid = make(cv, mesh)(res["pools"], mask,
                                             args[3].cpu().numpy(),
                                             *(a.cpu() for a in args[:3]))
                if ok.cpu().tolist() != whole or int(n_valid) != sum(whole):
                    raise SystemExit(f"K10 pinned {curve_name} {mname}: "
                                     "split != unsplit")
        out["pinned"][curve_name] = {"lanes": n, "valid": sum(whole)}
    log(f"K10 pinned split over phase 4's pools vs unsplit K2: equal "
        f"{out['pinned']}")
    out["max_abs_err"] = 0
    return out


def check_final_full(bls_checked, dev) -> dict:
    """Phase 3h: K11 on phase 3d's 10 lanes (the zero lane included)
    against its plain twin on the card and the oracle's
    ``v.pow((p^12 - 1)//r)``, value for value (20 sides), and the x-chain's
    values (K9's final launch) as their cubes, lane by lane; the verdicts
    equal K9's."""
    from bdls_tpu_torch.ops import bls_host as B
    from bdls_tpu_torch.ops import bls_kernel as K

    n, d = K.miller_cuda(*miller_args(bls_checked["args"]))
    ok, fe = K.final_full_cuda(n, d)
    _, fast = K.final_cuda(n, d)
    torch.cuda.synchronize()
    B_ = n.shape[-1] // 2
    # the kernel's column 2b is lane b's lhs n1·d2, 2b + 1 its rhs n2·d1
    order = torch.tensor(
        [i // 2 + (B_ if i % 2 else 0) for i in range(2 * B_)], device=dev)
    swap = torch.tensor([(i + B_) % (2 * B_) for i in range(2 * B_)],
                        device=dev)
    sides = K.f12_mul(K.f12_from_words(n.index_select(-1, order)),
                      K.f12_from_words(d.index_select(-1, swap)
                                       .index_select(-1, order)))
    t0 = time.perf_counter()
    plain = K.final_exp(sides)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kv = np.array(K.words_to_ints(fe), dtype=object)
    pv = np.array(K.f12_to_ints(plain), dtype=object)
    err = int(max(abs(int(x)) for x in (kv - pv).ravel()))
    e = (B.P ** 12 - 1) // B.R
    prod = K.f12_to_ints(sides)
    cube = K.words_to_ints(fast)
    t0 = time.perf_counter()
    for col in range(2 * B_):
        v = B.FQ12([kv[c][col] for c in range(12)])
        if v != B.FQ12([prod[c][col] for c in range(12)]).pow(e):
            raise SystemExit(f"K11 side {col}: not the oracle's pow")
        if B.FQ12([cube[c][col] for c in range(12)]) != v * v * v:
            raise SystemExit(f"K11 side {col}: the x-chain is not its cube")
    oracle_s = time.perf_counter() - t0
    raw = ok.cpu().tolist()
    log(f"K11 vs plain on {B_} lanes ({2 * B_} sides): max |kernel - plain| "
        f"{err}; every side the oracle's pow, the x-chain its cube "
        f"({oracle_s:.1f} s on the host); verdicts {raw}, K9's "
        f"{bls_checked['want_raw']}; plain {plain_ms:.0f} ms")
    if err or raw != bls_checked["want_raw"]:
        raise SystemExit("K11 disagrees with its plain twin or K9")
    return {"lanes": B_, "max_abs_err": err, "plain_ms": plain_ms,
            "oracle_s": oracle_s}


def drive_mesh_main_path(block, block_ok, pin, dev) -> dict:
    """Phase 5d: the mesh main path. ``TorchCSP(device="cuda",
    mesh_threshold=2048)`` on the real device list (one card) must not
    split the 2000-lane P-256 batch: one unsplit K1 launch, no K10. Then
    a two-shard mesh of the one card is stood in for the device list
    (``parallel.mesh.mesh_devices`` replaced for the phase, as the JAX
    package's tests stand in 8 virtual devices; the provider has no knob
    for it) and both dispatch points split, in both shard modes: the
    batch (K1's counting build a shard) and the 2000-lane block from 16
    pinned endorsers (K2's), two shard launches each and no count
    launch, no unsplit launch, the oracle's verdicts, no fallback.
    Counts are set to 0 just before each run and read just after."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.parallel import mesh as pmesh

    out = {}

    def run(csp, what, reqs, want, expect):
        ecdsa.reset_launches()
        t = time.perf_counter()
        got = csp.verify_batch(reqs)
        ms = (time.perf_counter() - t) * 1e3
        seen = nonzero_counts()
        log(f"[mesh, {csp.shard_mode}] {what}: {ms:.2f} ms, launches {seen}")
        if got != want:
            raise SystemExit(f"[mesh] {what}: verdicts differ")
        if seen != expect:
            raise SystemExit(f"[mesh] {what}: launches {seen}, want {expect}")
        if csp.stats["fallbacks"]:
            raise SystemExit(f"[mesh] {what}: fallbacks {csp.stats}")
        out[f"{csp.shard_mode}: {what}"] = {"ms": ms, "launches": seen}
        return seen

    csp = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   latency_max_lanes=0, mesh_threshold=2048)
    run(csp, "one card, 2000 P-256 lanes", block, block_ok,
        {"K1": {"P-256": 1}})
    csp.close()
    real = pmesh.mesh_devices
    pmesh.mesh_devices = lambda: [dev, dev]
    log(f"[mesh] standing in a two-shard mesh of {dev} for the device list "
        f"(parallel.mesh.mesh_devices -> [{dev}, {dev}])")
    try:
        for mode in ("pjit", "shard_map"):
            csp = TorchCSP(device="cuda", key_cache_size=0,
                           use_cpu_fallback=False, latency_max_lanes=0,
                           mesh_threshold=2048, shard_mode=mode)
            csp.verify_batch(block)                        # warm
            run(csp, "2 shards, 2000 P-256 lanes", block, block_ok,
                {"K1": {"P-256": 2}, "K10": {"shards": 2}})
            csp.close()
            csp = TorchCSP(device="cuda", use_cpu_fallback=False,
                           latency_max_lanes=0, mesh_threshold=2048,
                           shard_mode=mode)
            csp.warm_keys(pin["endorsers"], wait=True)
            run(csp, "2 shards, 2000 pinned lanes from 16 endorsers",
                pin["block"], pin["block_ok"],
                {"K2": {"P-256": 2}, "K10": {"shards": 2}})
            csp.close()
    finally:
        pmesh.mesh_devices = real
    return out


def drive_cert_kernel_path(cert_in) -> dict:
    """Phase 6f: the ``"kernel"`` certificate path,
    ``TorchCSP(device="cuda").verify_certificates(..., backend="kernel")``
    for the committees of 128 and 1024, 2 certificates a call, and the
    cross-round batch of 64: the verdicts of construction, exactly one
    Miller launch and one K11 launch, no K9 final launch, the host
    backend unused; then the default call still launches K9's two."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import bls_kernel as K
    from bdls_tpu_torch.ops import ecdsa

    os.environ.pop("BDLS_CERT_BACKEND", None)
    os.environ.pop("BDLS_BLS_FE", None)
    csp = TorchCSP(device="cuda", use_cpu_fallback=False)
    out = {}

    def counted(certs, aggs, want, label, backend, expect):
        ecdsa.reset_launches()
        K.reset_launches()
        t0 = time.perf_counter()
        got = csp.verify_certificates(certs, aggs, backend=backend)
        ms = (time.perf_counter() - t0) * 1e3
        seen = dict(K.LAUNCHES_BLS)
        log(f"certificates ({backend or 'default'}), {label}: {ms:.1f} ms, "
            f"launches {seen}, verify kernels {nonzero_counts()}")
        if got != want:
            raise SystemExit(f"certificates {label}: verdicts differ")
        if seen != expect or nonzero_counts():
            raise SystemExit(f"certificates {label}: launches {seen}")
        return ms

    full = {"miller": 1, "final": 0, "final_full": 1}
    for n, q in CERT_COMMITTEES:
        certs = cert_in[n]["pair"]
        aggs = [cert_in[n]["agg"]] * len(certs)
        csp.verify_certificates(certs, aggs, backend="kernel")     # warm
        runs = sorted(counted(certs, aggs, [True, True],
                              f"{n} validators, 2 a call", "kernel", full)
                      for _ in range(3))
        default = counted(certs, aggs, [True, True],
                          f"{n} validators, 2 a call", None,
                          {"miller": 1, "final": 1, "final_full": 0})
        out[n] = {"quorum": q, "ms_runs": runs, "median_ms": runs[1],
                  "default_ms": default, "launches": full}
        log(f"certificates, {n} validators, backend kernel: median "
            f"{runs[1]:.1f} ms of 3 calls (the default x-chain "
            f"{default:.1f} ms)")
    certs, aggs, want = cert_in["batch"]
    ms = counted(certs, aggs, want, f"cross-round batch of {len(certs)}",
                 "kernel", full)
    out["batch"] = {"certs": len(certs), "ms": ms, "launches": full}
    if csp._c_cert_host.value():
        raise SystemExit("certificates: the host backend ran unasked")
    csp.close()
    return out


def time_mesh(batch, truth, pinned, rng, sm_clock_hz, dev) -> dict:
    """Phase 7g, K10: the split (two shards of the one card, K1's
    counting build a shard, inputs already on their shards) against one
    unsplit K1 launch at 2048 and 8192 P-256 lanes, in turns (unsplit,
    split, split, unsplit), with the split's bound; the plain version of
    the split (each shard's plain K1 twin and plain count, on the card)
    at 2048; and the shard launch with its count against the same launch
    without it and against the launch followed by one PyTorch expression
    for the count, ``(ok & mask).sum()``, in turns (without, with, sum,
    sum, with, without), at 1024 lanes (a shard of the 2048 bucket), 2048
    and 8192 (K1) and 1024 (K2), with its bound, its plain twin at 1024
    and ``(ok & mask).sum()`` alone."""
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold, \
        verify_fold_pinned
    from bdls_tpu_torch.parallel import mesh as pmesh

    cv = CURVES["P-256"]
    lanes, want = batch["P-256"], truth["P-256"]
    mesh = pmesh.make_mesh([dev, dev])
    fn = pmesh.sharded_verify_masked(cv, mesh, field="fold")
    out = {"split": {}, "count": {}}
    for b in (2048, 8192):
        idx = [i % len(lanes) for i in range(b)]
        tiled = [lanes[i] for i in idx]
        args = lane_args(tiled, dev)
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        sh = [pmesh.shard_batch(mesh, a) for a in args]
        msh = pmesh.shard_batch(mesh, mask)
        ok, n_valid = fn(msh, *sh)
        if (ok.cpu().numpy().tolist() != want[idx].tolist()
                or int(n_valid) != int(want[idx].sum())):
            raise SystemExit(f"K10 split B={b}: verdicts differ")
        reps = 10

        def split():
            return fn(msh, *sh)

        def whole():
            return ecdsa.verify_fold_cuda(cv, *args)

        u1 = cuda_ms(whole, reps)
        s1 = cuda_ms(split, reps)
        s2 = cuda_ms(split, reps)
        u2 = cuda_ms(whole, reps)
        bms, by = split_bound_ms(cv, tiled, 2, sm_clock_hz)
        row = {"ms": (s1 + s2) / 2, "split_ms": [s1, s2],
               "unsplit_ms": [u1, u2], "bound_ms": bms, "bound_by": by}
        if b == 2048:
            t0 = time.perf_counter()
            for i in range(2):
                pok = verify_fold(cv, *(a[i] for a in sh))
                pmesh.masked_count_plain(pok, msh[i])
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["split"][b] = row
        log(f"K10 B={b}: split over 2 shards {s1:.3f} / {s2:.3f} ms, "
            f"unsplit K1 {u1:.3f} / {u2:.3f} ms (in turns), bound "
            f"{bms:.4f} ms ({by})"
            + (f", plain {row['plain_ms']:.0f} ms" if b == 2048 else ""))
    pres = pinned["P-256"]
    rse = [(ln[2], ln[3], int.from_bytes(ln[4], "big"))
           for ln in pres["lanes"]]
    for prog, n in (("K1", 1024), ("K1", 2048), ("K1", 8192), ("K2", 1024)):
        mask = _masks(rng, n, dev)["random"]
        if prog == "K1":
            idx = [i % len(lanes) for i in range(n)]
            tiled = [lanes[i] for i in idx]
            args = lane_args(tiled, dev)

            def run(**kw):
                return ecdsa.verify_fold_cuda(cv, *args, **kw)

            def plain():
                return verify_fold(cv, *args)

            bms, by = bound_ms(cv, tiled, sm_clock_hz)
        else:
            idx = [i % len(pres["lanes"]) for i in range(n)]
            args = _pinned_args([pres["lanes"][i] for i in idx],
                                [pres["slots"][i] for i in idx], dev)

            def run(**kw):
                return ecdsa.verify_pinned_cuda(cv, *args, pres["pools"],
                                                **kw)

            def plain():
                return verify_fold_pinned(cv, *args, pres["pools"])

            bms, by = pinned_bound_ms(cv, [rse[i] for i in idx],
                                      [pres["slots"][i] for i in idx],
                                      sm_clock_hz)
        bms += count_bytes(n) / PEAK_BYTES_PER_S * 1e3

        def with_sum():
            return (run() & mask).sum()

        reps = 10
        times = {"without": [], "with": [], "sum": []}
        for name, fn in (("without", run), ("with", lambda: run(mask=mask)),
                         ("sum", with_sum), ("sum", with_sum),
                         ("with", lambda: run(mask=mask)),
                         ("without", run)):
            times[name].append(cuda_ms(fn, reps))
        ok = run()
        sum_ms = cuda_ms(lambda: (ok & mask).sum(), 100)
        c_ms, u_ms = np.mean(times["with"]), np.mean(times["without"])
        row = {"ms": c_ms, "with_count_ms": times["with"],
               "without_count_ms": times["without"],
               "launch_and_sum_ms": times["sum"], "sum_ms": sum_ms,
               "epilogue_ms": c_ms - u_ms, "bound_ms": bms, "bound_by": by,
               "count_bound_ms": count_bound_ms(n)[0]}
        if n == 1024:
            t0 = time.perf_counter()
            pmesh.masked_count_plain(plain(), mask)
            torch.cuda.synchronize()
            row["plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["count"][f"{prog} {n}"] = row
        log(f"K10 count {prog} shard n={n}: with its count "
            f"{times['with'][0]:.4f} / {times['with'][1]:.4f} ms, without "
            f"{times['without'][0]:.4f} / {times['without'][1]:.4f} ms, "
            f"launch + (ok & mask).sum() {times['sum'][0]:.4f} / "
            f"{times['sum'][1]:.4f} ms (in turns); the sum alone "
            f"{sum_ms:.4f} ms; bound {bms:.4f} ms ({by})"
            + (f"; plain {row['plain_ms']:.0f} ms" if n == 1024 else ""))
    return out


def time_final_full(bls_checked, sm_clock_hz, dev) -> dict:
    """Phase 7g, K11: with CUDA events at 1, 2, 16 and 128 certificates
    (phase 3d's twisted lanes, tiled, verdicts checked), one warm launch
    and 10 timed a size, with its bound (:func:`k11_bound_ms`)."""
    from bdls_tpu_torch.ops import bls_kernel as K

    out = {}
    for b in (1, 2, 16, 128):
        args, want = tile_bls(bls_checked, b, bls_checked["twisted_lanes"],
                              dev)
        n, d = K.miller_cuda(*miller_args(args))
        ok, _ = K.final_full_cuda(n, d)
        if ok.cpu().tolist() != want:
            raise SystemExit(f"K11 B={b}: verdicts differ")
        ms = cuda_ms(lambda: K.final_full_cuda(n, d), 10)
        bms, by = k11_bound_ms(b, sm_clock_hz)
        out[b] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                  "certs_per_s": b / ms * 1e3}
        log(f"K11 B={b}: {ms:.2f} ms (bound {bms:.5f} ms, {by}), "
            f"{b / ms * 1e3:.2f} certificates/s")
    return out


# ------------------------------------------------- the provider plane (6g)

PLANE_DIR = os.path.join("build", "provider_plane")


def _plane_inputs(pin, block) -> dict:
    """What phase 6g's processes read: the 128 consenters' identities,
    the vote round's 127 envelopes from them, the 16 endorsers, the
    pinned 2000-lane block (the 16 endorsers') and the phase-5 block
    (64 endorsers, none pinned)."""
    def lanes(reqs):
        return [[hex(q.key.x), hex(q.key.y), hex(q.r), hex(q.s),
                 q.digest.hex()] for q in reqs]

    return {"idents": [i.hex() for i in pin["idents"]],
            "envs": [[e.version, e.payload.hex(), e.pub_x.hex(),
                      e.pub_y.hex(), e.sig_r.hex(), e.sig_s.hex()]
                     for e in pin["envs"][:127]],
            "endorsers": [[hex(k.x), hex(k.y)] for k in pin["endorsers"]],
            "pinned_block": lanes(pin["block"]), "block": lanes(block)}


def _plane_requests(spec: dict, name: str) -> list:
    from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest

    return [VerifyRequest(PublicKey("P-256", int(x, 16), int(y, 16)),
                          bytes.fromhex(d), int(r, 16), int(s, 16))
            for x, y, r, s, d in spec[name]]


def provider_child(role: str, work: str) -> int:
    """One process of phase 6g, started by :func:`start_child` with
    ``BDLS_TPU_AOT_CACHE`` set: ``build`` builds and stores the
    libraries, pins the consenters and endorsers, runs the vote round
    and writes the key snapshot; ``restore`` loads the libraries and
    restores the snapshot, then runs the vote round and both block
    batches; ``rebuild`` (a poisoned store) restores and runs the vote
    round. The results go to ``<work>/<role>.json``; the time of the
    first verdict is wall-clock, for the parent to subtract its start
    time."""
    from bdls_tpu_torch.consensus.identity import SignedEnvelope
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        identity_keys
    from bdls_tpu_torch.crypto.csp import PublicKey
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops import verify_fold as vf

    t_proc = time.time()
    with open(os.path.join(work, "inputs.json")) as f:
        spec = json.load(f)
    snap = os.path.join(work, "keys.npz")
    csp = TorchCSP(device="cuda", use_cpu_fallback=False, flush_interval=1.0)
    t_lib = time.time()
    idents = [bytes.fromhex(h) for h in spec["idents"]]
    envs = [SignedEnvelope(v, *(bytes.fromhex(h) for h in rest))
            for v, *rest in spec["envs"]]
    endorsers = [PublicKey("P-256", int(x, 16), int(y, 16))
                 for x, y in spec["endorsers"]]
    out = {"role": role, "t_proc": t_proc, "t_lib": t_lib}
    if role == "build":
        csp.warm_keys(identity_keys(idents) + endorsers, wait=True)
    else:
        out["restored"] = csp.key_cache.restore_from(
            snap, on_reject=csp._count_reject)
    built = csp.key_cache.stats["built"]
    verifier = CspBatchVerifier(csp, consenters=idents)

    def run(what, fn):
        before = csp.stats["pinned_lanes"]
        ecdsa.reset_launches()
        got = fn()
        out[what] = {"verdicts": got, "k1": dict(ecdsa.LAUNCHES),
                     "k2": dict(ecdsa.LAUNCHES_PINNED),
                     "pinned_lanes": csp.stats["pinned_lanes"] - before}

    run("vote_round", lambda: verifier.verify_envelopes(envs))
    out["t_first"] = time.time()
    out["built_during_round"] = csp.key_cache.stats["built"] - built
    if role == "build":
        out["snapshot_keys"] = csp.key_cache.snapshot_to(snap)
        for curve in ("P-256", "secp256k1"):     # into the table store
            vf.g_table_8bit(curve)
            vf.g32_tables(curve)
    if role == "restore":
        run("pinned_block", lambda: csp.verify_batch(
            _plane_requests(spec, "pinned_block")))
        run("block", lambda: csp.verify_batch(
            _plane_requests(spec, "block")))
    m = csp.metrics
    out["persistent"] = m.find("tpu_compile_cache_hits_total").value(
        ("persistent",))
    out["nvcc_builds"] = sorted(
        k[0] for k, v in m.find("tpu_compile_programs_total").values().items()
        if v and not k[1])
    out["rejects"] = {k[0]: v for k, v in
                      m.find("tpu_aot_cache_rejects_total").values().items()}
    out["fallbacks"] = csp.stats["fallbacks"]
    out["keys"] = csp.key_cache.stats["keys"]
    report = csp.build_report or {}
    out["build"] = {k: report.get(k) for k in (
        "paths", "seconds", "ptxas", "from_store", "nvcc_seconds")}
    csp.close()
    with open(os.path.join(work, f"{role}.json"), "w") as f:
        json.dump(out, f)
    print(f"provider plane: {role} done", flush=True)
    return 0


def _hidden_nvcc_env(work: str) -> dict:
    """The environment with nvcc out of reach: no directory holding it
    on PATH, ``CUDA_HOME`` an empty directory, no ``CUDA_PATH``."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    empty = os.path.join(work, "no-cuda")
    os.makedirs(empty, exist_ok=True)
    env["CUDA_HOME"] = empty
    env.pop("CUDA_PATH", None)
    return env


def start_child(role: str, work: str, store: str, nvcc: bool = True):
    """Start one phase-6g process on ``store``; returns (process, wall
    time of its start, its output files)."""
    env = dict(os.environ) if nvcc else _hidden_nvcc_env(work)
    env["BDLS_TPU_AOT_CACHE"] = os.path.abspath(store)
    env.pop("BDLS_TPU_PROFILE_DIR", None)
    logs = [open(os.path.join(work, f"{role}.{s}"), "w")
            for s in ("out", "err")]
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--provider-child", role,
         os.path.abspath(work)], env=env, stdout=logs[0], stderr=logs[1])
    return proc, t0, logs


def finish_child(child, role: str, work: str, timeout: float,
                 want_rc: int = 0) -> dict:
    """Wait for a child (killed past ``timeout``); return its results,
    or with ``want_rc`` nonzero its output, which must not hold a
    result."""
    proc, t0, logs = child
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SystemExit(f"phase 6g: the {role} process ran past {timeout} s")
    finally:
        for f in logs:
            f.close()
    err = open(os.path.join(work, f"{role}.err")).read()
    path = os.path.join(work, f"{role}.json")
    if want_rc:
        if rc == 0 or os.path.exists(path):
            raise SystemExit(f"phase 6g: the {role} process exited {rc} "
                             f"with a result; it had to raise")
        return {"rc": rc, "stderr": err}
    if rc != 0:
        raise SystemExit(f"phase 6g: the {role} process exited {rc}:\n"
                         f"{err[-4000:]}")
    with open(path) as f:
        out = json.load(f)
    out["ttfv_s"] = out["t_first"] - t0
    out["lib_s"] = out["t_lib"] - t0
    out["proc_s"] = out["t_proc"] - t0
    return out


def plane_truth(pin, block) -> dict:
    """The integer ECDSA's verdicts (``crypto/sw.py``) on every lane
    phase 6g's processes verify."""
    from bdls_tpu_torch.crypto.csp import VerifyRequest, PublicKey
    from bdls_tpu_torch.crypto.sw import SwCSP

    sw = SwCSP()
    votes = [sw.verify(VerifyRequest(PublicKey("secp256k1", x, y), d, r, s))
             for x, y, r, s, d, _ in map(_envelope_lane, pin["envs"][:127])]
    return {"vote_round": votes,
            "pinned_block": sw.verify_batch(pin["block"]),
            "block": sw.verify_batch(block)}


def _check_round(out: dict, what: str, truth: dict, k1: dict, k2: dict,
                 pinned: int) -> None:
    run = out[what]
    if run["verdicts"] != truth[what]:
        raise SystemExit(f"phase 6g {out['role']}: {what} verdicts differ "
                         f"from the integer ECDSA")
    if (run["k1"], run["k2"], run["pinned_lanes"]) != (k1, k2, pinned):
        raise SystemExit(f"phase 6g {out['role']}: {what} launches "
                         f"{run['k1']} / {run['k2']}, {run['pinned_lanes']} "
                         f"pinned lanes; want {k1} / {k2}, {pinned}")


def check_build_child(out: dict, truth: dict, card: str) -> None:
    """Phase 6g, the first process (run as phase 2's build)."""
    zero = {"P-256": 0, "secp256k1": 0}
    k1_only = {"P-256": 0, "secp256k1": 1}
    _check_round(out, "vote_round", truth, zero, k1_only, 127)
    if (out["persistent"] != 0 or len(out["nvcc_builds"]) != 11
            or out["rejects"] or out["fallbacks"]
            or out["snapshot_keys"] != 144):
        raise SystemExit(f"phase 6g build process: {out['persistent']} "
                         f"loaded, nvcc builds {out['nvcc_builds']}, rejects "
                         f"{out['rejects']}, {out['snapshot_keys']} keys in "
                         f"the snapshot")
    log(f"6g first process (nvcc, an empty store): {len(out['nvcc_builds'])} "
        f"libraries built by nvcc in {out['build']['seconds']:.1f} s and "
        f"stored; 144 keys pinned; the 127-vote round all K2 hits, the "
        f"integer ECDSA's verdicts; snapshot of {out['snapshot_keys']} keys; "
        f"time to first verdict {out['ttfv_s']:.2f} s ({card})")


def poison(store: str, keys: list[str]) -> list[str]:
    """Truncate the first of ``keys``' stored libraries and flip a byte
    in the second's payload; returns the two entries' paths."""
    from bdls_tpu_torch.ops import _build, aot_cache

    root = aot_cache.AotStore(store)
    paths = []
    for key, hurt in zip(keys, ("truncate", "flip")):
        src, _, eng = key.partition(":")
        path = root.path_for(aot_cache.cache_key(
            key, _build._digest(src, eng or "vpu")))
        raw = bytearray(open(path, "rb").read())
        if hurt == "truncate":
            raw = raw[:len(raw) // 2]
        else:
            raw[-100] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(raw))
        paths.append(path)
    return paths


def check_restore_child(out: dict, truth: dict, card: str) -> None:
    zero = {"P-256": 0, "secp256k1": 0}
    _check_round(out, "vote_round", truth, zero,
                 {"P-256": 0, "secp256k1": 1}, 127)
    _check_round(out, "pinned_block", truth, zero,
                 {"P-256": 1, "secp256k1": 0}, 2000)
    _check_round(out, "block", truth, {"P-256": 1, "secp256k1": 0}, zero, 0)
    build = out["build"]
    if (out["persistent"] != 11 or out["nvcc_builds"] or out["rejects"]
            or build["nvcc_seconds"] or len(build["from_store"]) != 11
            or out["restored"] != 144 or out["built_during_round"]
            or out["fallbacks"]):
        raise SystemExit(f"phase 6g restore process: {out['persistent']} "
                         f"loaded from the store, nvcc builds "
                         f"{out['nvcc_builds']}, rejects {out['rejects']}, "
                         f"{out['restored']} keys restored, "
                         f"{out['built_during_round']} built in the round")
    log(f"6g second process (nvcc hidden): all 11 libraries from the store "
        f"(tpu_compile_cache_hits_total{{kind=\"persistent\"}} = "
        f"{out['persistent']:.0f}, no nvcc build), 144 keys restored; the "
        f"vote round all K2 hits, the pinned block one K2 launch, the "
        f"phase-5 block one K1 launch, all the integer ECDSA's verdicts; "
        f"python and torch up {out['proc_s']:.2f} s after start, libraries "
        f"bound {out['lib_s']:.2f} s, time to first verdict "
        f"{out['ttfv_s']:.2f} s ({card})")


def profile_capture(block, block_ok, blk, block_csp, work: str) -> dict:
    """Phase 6g.4: one block batch (K1) and one ``verify_block`` (K7)
    under ``BDLS_TPU_PROFILE_DIR``: verdicts unchanged, two captures,
    the traces name the kernels; the five device operations that took
    the most time."""
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    prof_dir = os.path.join(work, "profile")
    os.environ["BDLS_TPU_PROFILE_DIR"] = prof_dir
    try:
        csp = TorchCSP(device="cuda", key_cache_size=0,
                       use_cpu_fallback=False)
    finally:
        del os.environ["BDLS_TPU_PROFILE_DIR"]
    got = csp.verify_batch(block)
    flags = csp.verify_block(blk["main"])
    captures = csp.metrics.find("tpu_profile_captures_total").value()
    csp.close()
    if got != block_ok:
        raise SystemExit("6g profile: block batch verdicts differ")
    if flags.tolist() != block_csp.verify_block(blk["main"]).tolist():
        raise SystemExit("6g profile: verify_block flags differ")
    traces = sorted(os.listdir(prof_dir))
    if captures != 2 or len(traces) != 2:
        raise SystemExit(f"6g profile: {captures} captures, traces {traces}")
    device_ms: dict[str, float] = {}
    names = []
    for name in traces:
        with open(os.path.join(prof_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        # demangled names, namespaces dropped: verify_kernel<CurveP256>
        kernels = {e["name"].replace("bdls::", "") for e in events
                   if e.get("cat") == "kernel"}
        names.append(sorted(kernels))
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                name = e["name"].replace("bdls::", "")
                device_ms[name] = (device_ms.get(name, 0.0)
                                   + e.get("dur", 0.0) / 1e3)
    if not any("verify_kernel<CurveP256>" in k for k in names[0] + names[1]):
        raise SystemExit(f"6g profile: no K1 kernel in the traces {names}")
    if not any("block_lane_kernel<CurveP256>" in k
               for k in names[0] + names[1]):
        raise SystemExit(f"6g profile: no K7 kernel in the traces {names}")
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:5]
    log("6g profile: 2 captures (block batch, verify_block); the five "
        "device operations that took the most time: " + "; ".join(
            f"{n[:90]} {ms:.4f} ms" for n, ms in top))
    return {"captures": captures, "kernels": names,
            "top_device_ms": [[n, ms] for n, ms in top]}


def accumulator_and_stall(votes, vote_ok) -> dict:
    """Phase 6g.5: ``pending_cap`` around real K1 launches, both
    policies; then ``chaos_stall_s`` on a K3 quorum round."""
    from bdls_tpu_torch.crypto.torch_provider import AccumulatorSaturated, \
        TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    import threading

    def capped(policy, timeout=5.0):
        return TorchCSP(device="cuda", key_cache_size=0,
                        use_cpu_fallback=False, buckets=(8,),
                        flush_interval=5.0, latency_max_lanes=0,
                        pending_cap=2, pending_policy=policy,
                        dispatch_timeout=timeout)

    ecdsa.reset_launches()
    acc = capped("reject")
    futs = [acc.submit(v) for v in votes[:2]]
    try:
        acc.submit(votes[2])
        raise SystemExit("6g accumulator: a third submit was admitted")
    except AccumulatorSaturated:
        pass
    acc.flush()
    third = acc.submit(votes[2])
    acc.flush()
    if [f.result(60) for f in futs + [third]] != vote_ok[:3]:
        raise SystemExit("6g accumulator (reject): verdicts differ")
    acc.close()
    blk = capped("block", timeout=0.2)
    for v in votes[:2]:
        blk.submit(v)
    t0 = time.perf_counter()
    try:
        blk.submit(votes[2])
        raise SystemExit("6g accumulator: a blocked submit was admitted")
    except AccumulatorSaturated:
        waited = time.perf_counter() - t0
    blk.close()
    park = capped("block", timeout=10.0)
    futs = [park.submit(v) for v in votes[:2]]
    late = {}
    t = threading.Thread(target=lambda: late.update(f=park.submit(votes[2])))
    t.start()
    time.sleep(0.1)
    parked = t.is_alive()
    park.flush()
    t.join(10.0)
    park.flush()
    if (not parked or t.is_alive() or waited < 0.2
            or [f.result(60) for f in futs + [late["f"]]] != vote_ok[:3]):
        raise SystemExit(f"6g accumulator (block): parked {parked}, waited "
                         f"{waited:.3f} s")
    park.close()
    k1 = ecdsa.LAUNCHES["secp256k1"]
    if k1 != 5:
        raise SystemExit(f"6g accumulator: {k1} K1 launches, want 5")
    log(f"6g accumulator: pending_cap 2 around {k1} K1 launches: reject "
        f"raised at once, block raised after {waited:.3f} s (timeout 0.2) "
        f"and unparked on a flush; the integer ECDSA's verdicts")

    st = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                  flush_interval=1.0)
    st.warmup([("secp256k1", 128)])
    quorum, want = votes[:85], vote_ok[:85]

    def rnd():
        futs = [st.submit(v) for v in quorum]
        t = time.perf_counter()
        st.flush()
        return futs, t, time.perf_counter() - t

    def verdicts(r):
        got = [f.result(60) for f in r[0]]
        return got, time.perf_counter() - r[1]

    base, base_s = verdicts(rnd())
    st.chaos_stall_s = 0.05
    ecdsa.reset_launches()
    rounds = [rnd(), rnd()]
    late_s = [verdicts(r) for r in rounds]
    st.chaos_stall_s = 0.0
    after, _ = verdicts(rnd())
    k3 = ecdsa.LAUNCHES_LATENCY["secp256k1"]
    stats = st.stats
    st.close()
    if (base != want or after != want
            or any(g != want for g, _ in late_s)
            or any(s < 0.05 for _, s in late_s)
            or max(r[2] for r in rounds) >= 0.05
            or stats["max_inflight"] < 2 or stats["fallbacks"]):
        raise SystemExit(f"6g stall: verdicts {[g == want for g, _ in late_s]}"
                         f", late {[s for _, s in late_s]}, stats {stats}")
    log(f"6g stall: chaos_stall_s 0.05 on two K3 quorum rounds (85 votes): "
        f"the same verdicts, flushes back in "
        f"{max(r[2] for r in rounds) * 1e3:.2f} ms, verdicts after "
        + ", ".join(f"{s * 1e3:.1f}" for _, s in late_s)
        + f" ms (unstalled {base_s * 1e3:.1f} ms), max_inflight "
        f"{stats['max_inflight']}, {k3} K3 replays")
    return {"accumulator": {"k1_launches": k1, "block_waited_s": waited},
            "stall": {"verdict_s": [s for _, s in late_s],
                      "unstalled_s": base_s,
                      "max_inflight": stats["max_inflight"],
                      "k3_replays": k3}}


# ------------------------------------------------------ the sidecar (6h)
SIDECAR_DIR = os.path.join("build", "sidecar")
# the coalescing window of the firehose daemon: wide enough for the two
# tenants' 1000-lane frames, each decoded in Python on the daemon's loop,
# to meet in one flush; every other daemon of the phase keeps the
# default window (0.002 s)
FIREHOSE_WINDOW_S = 0.1
DEFAULT_WINDOW_S = 0.002


class _OverlongR:
    """A lane whose sig_r travels as 33 bytes: invalid at ingress (the
    daemon's wire screen), so it reads False and reaches no kernel."""

    curve = "P-256"

    def __init__(self, req):
        self._w = (req.key.x.to_bytes(32, "big"),
                   req.key.y.to_bytes(32, "big"),
                   b"\x01" + req.r.to_bytes(32, "big"),
                   req.s.to_bytes(32, "big"), req.digest)

    def wire32(self):
        return self._w


def _launches() -> dict:
    """Every launch count phase 6h reads, without the zero entries."""
    from bdls_tpu_torch.ops import block_verify, ecdsa
    from bdls_tpu_torch.ops import bls_kernel as K

    seen = {"K1": ecdsa.LAUNCHES, "K2": ecdsa.LAUNCHES_PINNED,
            "K3": ecdsa.LAUNCHES_LATENCY, "K7": block_verify.LAUNCHES_BLOCK,
            "K9": K.LAUNCHES_BLS}
    return {k: {c: n for c, n in v.items() if n}
            for k, v in seen.items() if any(v.values())}


def _reset_launches() -> None:
    from bdls_tpu_torch.ops import bls_kernel as K
    from bdls_tpu_torch.ops import ecdsa

    ecdsa.reset_launches()
    K.reset_launches()


def _expect(what: str, seen: dict, want: dict) -> None:
    if seen != want:
        raise SystemExit(f"phase 6h {what}: launches {seen}, want {want}")


def _median(runs) -> dict:
    runs = sorted(runs)
    return {"median": runs[len(runs) // 2], "min": runs[0], "max": runs[-1]}


def _fmt(t: dict) -> str:
    return f"{t['median']:.2f} ({t['min']:.2f}, {t['max']:.2f})"


def _wait_for(cond, timeout: float, what: str) -> None:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise SystemExit(f"phase 6h: {what} within {timeout} s")
        time.sleep(0.02)


class _CertSession:
    """The certificate lane over raw frames, through the port's ``wire``
    on a socket: the committee (its G1 keys and quorum) registered once,
    then batches of certificates against it."""

    def __init__(self, port: int, agg):
        from bdls_tpu_torch.consensus import threshold as TH
        from bdls_tpu_torch.sidecar import verifyd_codec as codec
        from bdls_tpu_torch.sidecar import wire

        self.codec, self.wire, self.th = codec, wire, TH
        self.sock = socket.create_connection(("127.0.0.1", port), 120)
        self.seq = 0
        self.sock.sendall(wire.encode_frame(codec.Frame(
            cert_committee=codec.CertCommitteeRequest(
                tenant="certs", committee="c128", quorum=agg.quorum,
                pks=[TH.serialize_point(pk) for pk in agg.pks]))))
        resp = wire.recv_frame(self.sock).cert_committee_resp
        if resp.error or resp.registered != len(agg.pks):
            raise SystemExit(f"phase 6h: committee refused: {resp}")

    def verify(self, certs) -> list[bool]:
        self.seq += 1
        self.sock.sendall(self.wire.encode_frame(self.codec.Frame(
            cert=self.codec.CertBatchRequest(
                seq=self.seq, tenant="certs", committee="c128",
                certs=[self.th.serialize_certificate(c) for c in certs]))))
        v = self.wire.recv_frame(self.sock).verdict
        if v.error or v.seq != self.seq or v.n != len(certs):
            raise SystemExit(f"phase 6h: certificate verdict {v}")
        return [bool(v.verdicts[i >> 3] >> (i & 7) & 1) for i in range(v.n)]

    def close(self) -> None:
        self.sock.close()


def _http_json(port: int, path: str) -> tuple[int, object]:
    """GET one operations route of a daemon on this host: (status, JSON
    body or text)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            status, body = resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        status, body = exc.code, exc.read().decode()
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body


def _ops_checks(daemon, tenant: str) -> dict:
    """The daemon's operations endpoint after phase 6h's traffic:
    ``/healthz`` 200; ``/metrics`` with ``verifyd_requests_total`` for
    ``tenant`` and the card provider's ``tpu_verify_*``; ``/debug/slo``
    with the sidecar objectives bound (pass or fail, not skipped);
    ``/debug/tsdb`` with a sample of ``verifyd_requests_total``."""
    port = daemon.ops_port
    if not port:
        raise SystemExit("phase 6h operations: the daemon has no ops port")
    status, health = _http_json(port, "/healthz")
    if status != 200 or health.get("status") != "OK":
        raise SystemExit(f"phase 6h operations: /healthz {status} {health}")
    status, text = _http_json(port, "/metrics")
    if (status != 200 or "verifyd_requests_total" not in text
            or f'tenant="{tenant}"' not in text
            or "tpu_verify_requests_total" not in text):
        raise SystemExit(f"phase 6h operations: /metrics {status}")
    status, verdict = _http_json(port, "/debug/slo")
    rows = {o["name"]: o for o in verdict.get("objectives", ())} \
        if status == 200 else {}
    bound = {n: rows.get(n, {}).get("status") for n in (
        "coalesced_bucket_floor", "sidecar_queue_wait_p99")}
    if any(v not in ("pass", "fail") for v in bound.values()):
        raise SystemExit(f"phase 6h operations: /debug/slo {status} {bound}")
    status, tsdb = _http_json(port, "/debug/tsdb")
    fqs = {x["fq"] for x in tsdb.get("series", ())} if status == 200 \
        else set()
    if "verifyd_requests_total" not in fqs:
        raise SystemExit(f"phase 6h operations: /debug/tsdb {status}")
    slo_rows = {n: {k: rows[n].get(k) for k in (
        "status", "value", "threshold", "count")} for n in bound}
    log(f"6h operations endpoint (port {port}): /healthz 200; /metrics "
        f"{len(text.splitlines())} lines with verifyd_requests_total "
        f"{{tenant=\"{tenant}\"}} and tpu_verify_requests_total; /debug/slo "
        f"{json.dumps(slo_rows)}; /debug/tsdb {len(fqs)} series, "
        f"{tsdb.get('samples_taken')} samples")
    return {"port": port, "slo": slo_rows, "tsdb_series": len(fqs),
            "tsdb_samples": tsdb.get("samples_taken")}


def _cli_daemon(store: str, votes, vote_ok, block, block_ok) -> dict:
    """The deployment shape: the daemon in a process of its own through
    the command line, its libraries from phase 2's store. One tenant
    sends the vote round and the 2000-lane batch; then SIGINT."""
    import signal
    import threading

    from bdls_tpu_torch.crypto.torch_provider import default_kernel_field
    from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP

    env = dict(os.environ)
    env["BDLS_TPU_AOT_CACHE"] = os.path.abspath(store)
    env.pop("BDLS_TPU_PROFILE_DIR", None)
    err = open(os.path.join(SIDECAR_DIR, "cli.err"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "bdls_tpu_torch.cli.main", "verifyd",
         "--port", "0", "--ops-port", "0"], env=env,
        stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        first = {}
        reader = threading.Thread(
            target=lambda: first.update(line=proc.stdout.readline()))
        reader.start()
        reader.join(300)
        up_s = time.perf_counter() - t0
        try:
            info = json.loads(first.get("line") or "")
        except ValueError:
            raise SystemExit(f"phase 6h: the CLI daemon printed "
                             f"{first.get('line')!r} (exit {proc.poll()})")
        ops = info.get("operations")
        if (info.get("transport") != "socket" or not isinstance(ops, int)
                or ops <= 0 or info.get("kernel") != default_kernel_field()):
            raise SystemExit(f"phase 6h: the CLI daemon's line {info}")
        health = _http_json(ops, "/healthz")
        if health != (200, {"status": "OK", "failed_checks": []}):
            raise SystemExit(f"phase 6h: the CLI daemon's /healthz {health}")
        host, port = info["listen"]
        client = RemoteCSP(f"{host}:{port}", transport="socket",
                           tenant="deployed", request_timeout=60.0)
        try:
            t = time.perf_counter()
            got_votes = client.verify_batch(votes)
            vote_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            got_block = client.verify_batch(block)
            block_ms = (time.perf_counter() - t) * 1e3
            fallbacks = client._c_fallbacks.value()
            remote = client._c_remote.value()
        finally:
            client.close()
        if got_votes != vote_ok or got_block != block_ok:
            raise SystemExit("phase 6h: the CLI daemon's verdicts differ")
        if fallbacks or remote != 2:
            raise SystemExit(f"phase 6h: the CLI daemon's client: "
                             f"{fallbacks} fallbacks, {remote} remote")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(60)
        if rc != 0:
            raise SystemExit(f"phase 6h: the CLI daemon exited {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.close()
    log(f"6h deployment: `python3 -m bdls_tpu_torch.cli.main verifyd --ops-port "
        f"0` with BDLS_TPU_AOT_CACHE, its line {json.dumps(info)} after "
        f"{up_s:.2f} s, /healthz 200 on its operations port; 128-vote round "
        f"{vote_ms:.2f} ms and 2000-lane batch {block_ms:.2f} ms (first "
        f"calls), the integer ECDSA's verdicts; SIGINT, exit 0")
    return {"line": info, "up_s": up_s, "vote_round_ms": vote_ms,
            "batch_ms": block_ms, "rc": rc}


def _codec_times(block, req) -> dict:
    """The codec's encode and decode ms for the 2000-lane verify frame
    and the block frame, median of 9 (min, max), on this host."""
    from bdls_tpu_torch.sidecar import verifyd_codec as codec

    verify = codec.Frame(verify=codec.VerifyBatchRequest(
        seq=1, tenant="firehose", deadline_ms=5000.0, lanes=[
            codec.VerifyLane(curve="P-256", pub_x=q.key.x.to_bytes(32, "big"),
                             pub_y=q.key.y.to_bytes(32, "big"),
                             digest=q.digest, sig_r=q.r.to_bytes(32, "big"),
                             sig_s=q.s.to_bytes(32, "big")) for q in block]))
    blockf = codec.Frame(verify_block=codec.VerifyBlockRequest(
        seq=2, tenant="committer", deadline_ms=5000.0, curve=req.curve,
        norgs=req.norgs, lanes=[codec.BlockLaneMsg(
            msg=ln.msg, pub_x=ln.qx, pub_y=ln.qy, sig_r=ln.r, sig_s=ln.s,
            tx=ln.tx, org=ln.org) for ln in req.lanes],
        policies=[codec.BlockPolicyMsg(required=p.required,
                                       orgs=list(p.orgs))
                  for p in req.policies]))
    out = {}
    for name, frame in (("verify_2000", verify), ("block_1000tx", blockf)):
        raw = codec.encode(frame)
        if codec.decode(raw) != frame:
            raise SystemExit(f"phase 6h: the codec does not round-trip "
                             f"the {name} frame")
        enc, dec = [], []
        for _ in range(9):
            t = time.perf_counter()
            codec.encode(frame)
            enc.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            codec.decode(raw)
            dec.append((time.perf_counter() - t) * 1e3)
        out[name] = {"bytes": len(raw), "encode_ms": _median(enc),
                     "decode_ms": _median(dec)}
    return out


def drive_sidecar(votes, vote_ok, block, block_ok, pin, blk, block_flags,
                  cert_in, store, card) -> dict:
    """Phase 6h: the verification daemon and its clients on the card
    (module docstring). Launch counts are set to 0 just before each
    check and read just after; outside the overload and death checks
    every client's fallbacks and every daemon's flush errors must be
    0."""
    import threading

    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier, \
        identity_keys
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import bls_host as B
    from bdls_tpu_torch.consensus import threshold as TH
    from bdls_tpu_torch.sidecar import verifyd_codec as codec
    from bdls_tpu_torch.sidecar import wire
    from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP
    from bdls_tpu_torch.sidecar.verifyd import VerifydServer

    shutil.rmtree(SIDECAR_DIR, ignore_errors=True)
    os.makedirs(SIDECAR_DIR)
    snap = os.path.join(SIDECAR_DIR, "warm.snapshot")
    os.environ.pop("BDLS_CERT_BACKEND", None)
    out = {"windows_s": {"firehose": FIREHOSE_WINDOW_S,
                         "others": DEFAULT_WINDOW_S}}
    clients, daemons = [], []

    def client(port, tenant, **kw):
        kw.setdefault("request_timeout", 60.0)
        c = RemoteCSP(f"127.0.0.1:{port}", transport="socket", tenant=tenant,
                      **kw)
        clients.append(c)
        return c

    def clean(*cs):
        for c in cs:
            if c._c_fallbacks.value():
                raise SystemExit(f"phase 6h: client {c.tenant} fell back "
                                 f"{c._c_fallbacks.values()}")
        for d in daemons:
            if d.coalescer.counts["verify_errors"]:
                raise SystemExit(f"phase 6h: flush errors "
                                 f"{d.coalescer.counts}")

    # ---- the daemon: TorchCSP on the card from the factory, warmed ----
    t0 = time.perf_counter()
    a = VerifydServer(transport="socket", flush_interval=FIREHOSE_WINDOW_S,
                      ops_port=0, warmup=True, warm_snapshot=snap).start()
    daemons.append(a)
    boot_s = time.perf_counter() - t0
    if (not isinstance(a.csp, TorchCSP) or a.csp.key_cache is None
            or a.csp.device.type != "cuda"):
        raise SystemExit(f"phase 6h: the daemon's provider {a.csp}")

    # ---- firehose: two tenants, one joint flush ------------------------
    halves = [(list(block[:1000]), list(block_ok[:1000])),
              (list(block[1000:]), list(block_ok[1000:]))]
    for i, (reqs, want) in enumerate(halves):
        at = 17 + 400 * i
        reqs.insert(at, _OverlongR(block[at]))
        want.insert(at, False)
    tenants = [client(a.port, f"firehose-{i}") for i in range(2)]
    results = {}
    barrier = threading.Barrier(2)

    def send(i):
        barrier.wait(30)
        t = time.perf_counter()
        results[i] = (tenants[i].verify_batch(halves[i][0]),
                      (time.perf_counter() - t) * 1e3)

    _reset_launches()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    seen = _launches()
    st = a.coalescer.stats
    for i in range(2):
        if results.get(i, (None,))[0] != halves[i][1]:
            raise SystemExit(f"phase 6h firehose: tenant {i}'s verdicts")
    if st["multi_tenant_buckets"] < 1 or st["invalid_lanes"] != 2:
        raise SystemExit(f"phase 6h firehose: coalescer {st}")
    _expect("firehose", seen, {"K1": {"P-256": 1}})
    clean(*tenants)
    out["firehose"] = {"ms": [results[i][1] for i in range(2)],
                       "launches": seen, "buckets": st["recent_buckets"]}
    log(f"6h firehose: 2 tenants x 1001 lanes (1 overlong sig_r each) "
        f"through one daemon ({FIREHOSE_WINDOW_S * 1e3:.0f} ms window): "
        f"{results[0][1]:.1f} / {results[1][1]:.1f} ms, the integer ECDSA's "
        f"verdicts per tenant, multi_tenant_buckets "
        f"{st['multi_tenant_buckets']}, launches {seen}; daemon up in "
        f"{boot_s:.2f} s (factory TorchCSP, warm-up of every pair)")

    # ---- the consensus seam over the wire -----------------------------
    seam = client(a.port, "seam")
    verifier = CspBatchVerifier(seam, consenters=pin["idents"])
    if seam.quorum_lanes != 85:
        raise SystemExit(f"phase 6h seam: quorum hint {seam.quorum_lanes}")
    consenters = {k.ski().hex() for k in identity_keys(pin["idents"])}

    def listed():
        blob = seam.stats() or {}
        return consenters <= set(blob.get("key_cache", {}).get(
            "skis", {}).get("secp256k1", ()))

    _wait_for(listed, 120, "the 128 consenters pinned")
    before = a.coalescer.counts["quorum_flushes"]
    _reset_launches()
    t = time.perf_counter()
    got = verifier.verify_envelopes(pin["envs"])
    seam_ms = (time.perf_counter() - t) * 1e3
    seen = _launches()
    if got != pin["env_ok"]:
        raise SystemExit("phase 6h seam: verdicts differ")
    if a.coalescer.counts["quorum_flushes"] - before < 1:
        raise SystemExit("phase 6h seam: no quorum flush")
    # the outsider's lane: a K3 replay of its warmed bucket of 8
    _expect("seam", seen, {"K2": {"secp256k1": 1},
                           "K3": {"secp256k1": 1}})
    clean(seam)
    out["seam"] = {"ms": seam_ms, "launches": seen}
    log(f"6h seam: CspBatchVerifier(RemoteCSP), 128 envelopes (2 forged, 1 "
        f"outsider), lane_hint 85: {seam_ms:.2f} ms, quorum flush, launches "
        f"{seen}")

    # ---- K3 through the daemon ----------------------------------------
    k3csp = TorchCSP(device="cuda", key_cache_size=0)
    k3csp.warmup([("secp256k1", 128)])
    d2 = VerifydServer(csp=k3csp, transport="socket").start()
    daemons.append(d2)
    voter = client(d2.port, "voter")
    voter.set_quorum_hint(85)
    _reset_launches()
    t = time.perf_counter()
    got = voter.verify_batch(votes[:85])
    k3_ms = (time.perf_counter() - t) * 1e3
    seen = _launches()
    if got != vote_ok[:85]:
        raise SystemExit("phase 6h K3: verdicts differ")
    _expect("K3", seen, {"K3": {"secp256k1": 1}})
    clean(voter)
    out["k3"] = {"ms": k3_ms, "launches": seen}
    log(f"6h K3: 85 votes, lane_hint 85, a daemon over TorchCSP(key_cache_"
        f"size=0): {k3_ms:.2f} ms, launches {seen}")

    # ---- the block lane -------------------------------------------------
    req = blk["main"]
    before = a.coalescer.counts["block_flushes"]
    _reset_launches()
    t = time.perf_counter()
    flags = tenants[0].verify_block(req)
    block_ms = (time.perf_counter() - t) * 1e3
    seen = _launches()
    if [int(f) for f in flags] != block_flags:
        raise SystemExit("phase 6h block: flags differ from the host oracle")
    _expect("block", seen, {"K7": {"P-256": 1}})
    if a.coalescer.counts["block_flushes"] - before != 1:
        raise SystemExit(f"phase 6h block: {a.coalescer.counts}")
    clean(tenants[0])
    out["block"] = {"ms": block_ms, "launches": seen}
    log(f"6h block lane: RemoteCSP.verify_block, {req.ntx} txs, "
        f"{len(req.lanes)} lanes: {block_ms:.2f} ms, launches {seen}, the "
        f"host oracle's flags")

    # ---- the certificate lane ------------------------------------------
    agg = cert_in[128]["agg"]
    good = cert_in[128]["pair"][0]
    forged = TH.QuorumCertificate(good.digest, good.signers, B.pt_add(
        good.agg_sig, agg._hm(good.digest)))
    t = time.perf_counter()
    certs = _CertSession(a.port, agg)
    reg_ms = (time.perf_counter() - t) * 1e3
    _reset_launches()
    t = time.perf_counter()
    got = certs.verify([good, forged])
    cert_ms = (time.perf_counter() - t) * 1e3
    certs.close()
    seen = _launches()
    if got != [True, False]:
        raise SystemExit(f"phase 6h certificates: bitmap {got}")
    _expect("certificates", seen, {"K9": {"miller": 1, "final": 1}})
    out["certificates"] = {"ms": cert_ms, "register_ms": reg_ms,
                           "launches": seen}
    log(f"6h certificate lane, raw frames: the committee of 128 (quorum 85) "
        f"registered in {reg_ms:.1f} ms; 2 certificates, one forged, "
        f"{cert_ms:.1f} ms (the first: H(m) and the aggregated key made), "
        f"bitmap {got}, launches {seen}")

    # ---- overload -------------------------------------------------------
    over = VerifydServer(csp=k3csp, transport="socket",
                         watermarks=(0, 0, 0)).start()
    daemons.append(over)
    over.coalescer.vote_lane_max = 0  # unhinted batches are firehose
    storm = block[:20]
    with socket.create_connection(("127.0.0.1", over.port), 30) as s:
        s.sendall(wire.encode_frame(codec.Frame(
            verify=codec.VerifyBatchRequest(seq=5, tenant="raw", lanes=[
                codec.VerifyLane("P-256", q.key.x.to_bytes(32, "big"),
                                 q.key.y.to_bytes(32, "big"), q.digest,
                                 q.r.to_bytes(32, "big"),
                                 q.s.to_bytes(32, "big"))
                for q in storm]))))
        shed = wire.recv_frame(s).verdict
    if not shed.shed or shed.retry_after_ms <= 0 or shed.seq != 5 \
            or "hard_watermark" not in shed.error:
        raise SystemExit(f"phase 6h overload: shed frame {shed}")
    stormy = client(over.port, "storm")
    if stormy.verify_batch(storm) != block_ok[:20]:
        raise SystemExit("phase 6h overload: verdicts differ")
    if stormy._c_fallbacks.values() != {("shed",): 1.0}:
        raise SystemExit(f"phase 6h overload: fallbacks "
                         f"{stormy._c_fallbacks.values()}")
    stormy.set_quorum_hint(85)
    _reset_launches()
    if stormy.verify_batch(votes[:85]) != vote_ok[:85]:
        raise SystemExit("phase 6h overload: the vote lane's verdicts")
    seen = _launches()
    if stormy._c_remote.value() != 1 or stormy._c_fallbacks.value() != 1:
        raise SystemExit("phase 6h overload: the vote lane was shed")
    _expect("overload vote lane", seen, {"K3": {"secp256k1": 1}})
    with socket.create_connection(("127.0.0.1", over.port), 60) as s:
        length = wire.MAX_FRAME + 1
        s.sendall(struct.pack("<I", length) + bytes(length))
        err = wire.recv_frame(s).verdict.error
        s.settimeout(10)
        closed = s.recv(1) == b""
    if "oversized" not in err or not closed:
        raise SystemExit(f"phase 6h overload: oversized frame: {err!r}, "
                         f"closed {closed}")
    out["overload"] = {"retry_after_ms": shed.retry_after_ms,
                       "counts": dict(over.coalescer.counts)}
    log(f"6h overload: watermarks (0, 0, 0): a 20-lane firehose batch shed "
        f"({shed.error}; retry_after_ms {shed.retry_after_ms:.3f}), the "
        f"client's fallback counted as shed; an 85-vote batch not shed "
        f"(launches {seen}); an oversized frame answered ({err[:60]}...) "
        f"and the connection closed")

    # ---- death, return and the warm handoff ----------------------------
    port = a.port
    a.stop()
    a.close_csp()
    daemons.remove(a)
    if not os.path.exists(snap):
        raise SystemExit("phase 6h: the daemon wrote no warm snapshot")
    probe = block[:16]
    t = time.perf_counter()
    got = tenants[1].verify_batch(probe)
    dead_s = time.perf_counter() - t
    if got != block_ok[:16] or dead_s > tenants[1].request_timeout:
        raise SystemExit(f"phase 6h death: verdicts or {dead_s:.2f} s")
    if tenants[1]._c_fallbacks.values() != {("disconnected",): 1.0}:
        raise SystemExit(f"phase 6h death: fallbacks "
                         f"{tenants[1]._c_fallbacks.values()}")
    t = time.perf_counter()
    b = VerifydServer(transport="socket", port=port, ops_port=0,
                      warmup=True, warm_snapshot=snap).start()
    daemons.append(b)
    succ_s = time.perf_counter() - t
    keys = identity_keys(pin["idents"])
    if b.restored_keys < 128 or not all(b.csp.key_cache.contains(k)
                                        for k in keys):
        raise SystemExit(f"phase 6h handoff: {b.restored_keys} keys "
                         f"restored")
    for c in (tenants[0], tenants[1], seam):
        _wait_for(lambda: c.connected, 30, f"{c.tenant} reconnected")
    remote = tenants[1]._c_remote.value()
    if (tenants[1].verify_batch(probe) != block_ok[:16]
            or tenants[1]._c_remote.value() != remote + 1
            or tenants[1]._c_reconnects.value() < 1
            or tenants[1]._c_fallbacks.value() != 1):
        raise SystemExit("phase 6h return: no remote verdicts again")
    sent = seam._c_rewarm_sent.value()
    skipped = seam._c_rewarm_skipped.value()
    if sent != 0 or skipped != 128:
        raise SystemExit(f"phase 6h handoff: rewarm sent {sent}, skipped "
                         f"{skipped}")
    out["death"] = {"fallback_s": dead_s, "successor_up_s": succ_s,
                    "restored_keys": b.restored_keys,
                    "reconnects": tenants[1]._c_reconnects.value(),
                    "rewarm_sent": sent, "rewarm_skipped": skipped}
    log(f"6h death and return: stop(); the next batch fell back "
        f"(disconnected) in {dead_s * 1e3:.1f} ms; the successor on the same "
        f"port up in {succ_s:.2f} s with {b.restored_keys} keys restored "
        f"from the warm snapshot; reconnected, remote verdicts again; the "
        f"seam client's rewarm sent {sent:.0f} keys, skipped {skipped:.0f}")

    # ---- the deployment shape -------------------------------------------
    out["cli"] = _cli_daemon(store, votes, vote_ok, block, block_ok)

    # ---- times: through the daemon, in turns with the same call in process
    local = CspBatchVerifier(b.csp, consenters=pin["idents"])
    fire = tenants[0]
    certs = _CertSession(b.port, agg)
    for warm in (certs.verify, lambda cs: b.csp.verify_certificates(
            cs, [agg] * len(cs))):
        warm([good, forged])
    cases = {
        "vote_round_128": (
            lambda: verifier.verify_envelopes(pin["envs"]),
            lambda: local.verify_envelopes(pin["envs"]), pin["env_ok"]),
        "batch_2000": (lambda: fire.verify_batch(block),
                       lambda: b.csp.verify_batch(block), block_ok),
        "verify_block": (
            lambda: [int(f) for f in fire.verify_block(req)],
            lambda: [int(f) for f in b.csp.verify_block(req)], block_flags),
        "certificates_2": (
            lambda: certs.verify([good, forged]),
            lambda: b.csp.verify_certificates([good, forged], [agg, agg]),
            [True, False]),
    }
    times = {}
    for name, (remote_fn, local_fn, want) in cases.items():
        runs = {"daemon": [], "in_process": []}
        for _ in range(9):
            for side, fn in (("daemon", remote_fn), ("in_process",
                                                      local_fn)):
                t = time.perf_counter()
                if fn() != want:
                    raise SystemExit(f"phase 6h times: {name} {side} "
                                     f"verdicts differ")
                runs[side].append((time.perf_counter() - t) * 1e3)
        times[name] = {side: _median(r) for side, r in runs.items()}
    clean(fire, seam)
    out["operations"] = _ops_checks(b, fire.tenant)
    codec_t = _codec_times(block, req)
    out["times_ms"] = times
    out["codec"] = codec_t
    log(f"6h times ({card}; host clock, median of 9 (min, max), daemon / in "
        f"process in turns, windows {DEFAULT_WINDOW_S * 1e3:.0f} ms): "
        + "; ".join(f"{n} {_fmt(t['daemon'])} / {_fmt(t['in_process'])} ms"
                    for n, t in times.items())
        + "; codec encode / decode: "
        + "; ".join(f"{n} ({c['bytes']} bytes) {_fmt(c['encode_ms'])} / "
                    f"{_fmt(c['decode_ms'])} ms" for n, c in codec_t.items()))

    certs.close()
    for c in clients:
        c.close()
    for d in daemons:
        d.stop()
    for d in (b, d2):
        d.close_csp()
    return out


# ------------------------------------------------ the consensus engine (6i)
# (validators, heights to decide): BASELINE.json config 4's 128 validators
# a signature, and config 2's shape. 2 heights at 128, not 3: with phase
# 6j the whole run at 3 took 899 s on an H100 (6i 92 s), against 730-837 s
# at 2
CONSENSUS_RUNS = ((128, 2), (4, 10))
CONSENSUS_MAX_VIRTUAL_S = 60.0
CONSENSUS_MAX_WALL_S = 240.0


class _FirstBatch:
    """The sidecar of a round run: the card verifier, its first batch
    and verdicts kept for the check against the host."""

    def __init__(self, inner):
        self.inner = inner
        self.first = None

    def verify_envelopes(self, envs):
        oks = self.inner.verify_envelopes(envs)
        if self.first is None:
            self.first = (list(envs), list(oks))
        return oks


class _MissLog:
    """One node's CacheVerifier fallback: the card verifier, with the
    envelopes it was handed logged."""

    def __init__(self, inner):
        self.inner = inner
        self.envs = []

    def verify_envelopes(self, envs):
        self.envs.extend(envs)
        return self.inner.verify_envelopes(envs)


def _round_launches() -> dict:
    from bdls_tpu_torch.ops import ecdsa

    seen = {"K1": ecdsa.LAUNCHES, "K2": ecdsa.LAUNCHES_PINNED,
            "K3": ecdsa.LAUNCHES_LATENCY, "K1+K5": ecdsa.LAUNCHES_MXU,
            "K2+K5": ecdsa.LAUNCHES_PINNED_MXU,
            "K3+K5": ecdsa.LAUNCHES_LATENCY_MXU,
            "K4": ecdsa.LAUNCHES_MONT16}
    return {k: {c: n for c, n in v.items() if n}
            for k, v in seen.items() if any(v.values())}


def drive_consensus(card: str) -> dict:
    """Phase 6i: the BDLS engine deciding heights through the card
    (module docstring). Each run: ``rounds.build_net`` with one
    ``CacheVerifier`` a node over one shared cache, each node's misses
    sent to the card verifier ``CspBatchVerifier(TorchCSP(),
    consenters=...)``, which is also the pre-pass sidecar; launch counts
    set to 0 just before ``rounds.run_rounds`` and read just after."""
    import functools

    from bdls_tpu_torch.consensus import errors as E
    from bdls_tpu_torch.consensus import rounds as R
    from bdls_tpu_torch.consensus import wire_codec as W
    from bdls_tpu_torch.consensus.identity import (Signer,
                                                   cpu_verify_envelope,
                                                   identity_of)
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.utils import slo, tracing

    out = {}
    for n, heights in CONSENSUS_RUNS:
        what = f"phase 6i, {n} validators"
        csp = TorchCSP()
        participants = [Signer.from_scalar(R.SIGNER_BASE + i).identity
                        for i in range(n)]
        card_v = CspBatchVerifier(csp, consenters=participants)
        sidecar = _FirstBatch(card_v)
        cache, cvs, misses = {}, [], []

        def factory():
            fb = _MissLog(card_v)
            misses.append(fb)
            cv = R.CacheVerifier(cache, fb)
            cvs.append(cv)
            return cv

        # the run's spans in a tracer of their own (the engines and the
        # network bind tracing.GLOBAL when they are made)
        global_tracer, tracing.GLOBAL = tracing.GLOBAL, tracing.Tracer()
        try:
            run_tracer = tracing.GLOBAL
            net = R.build_net(n, factory)
        finally:
            tracing.GLOBAL = global_tracer
        decided = [dict() for _ in range(n)]

        def record(i, sync, height, rnd, state):
            decided[i][height] = bytes(state or b"")
            sync(height, rnd, state)

        for i, node in enumerate(net.nodes):
            node._height_sync = functools.partial(record, i,
                                                  node._height_sync)
        ecdsa.reset_launches()
        stats = R.run_rounds(net, heights, sidecar=sidecar, cache=cache,
                             max_virtual_s=CONSENSUS_MAX_VIRTUAL_S,
                             max_wall_s=CONSENSUS_MAX_WALL_S)
        launches = _round_launches()
        stats["cache_hits"] = sum(c.hits for c in cvs)
        stats["cache_misses"] = sum(c.misses for c in cvs)
        if stats["heights"] < heights:
            raise SystemExit(
                f"{what}: {stats['heights']} heights decided within "
                f"{stats['virtual_s']:.2f} virtual s and {stats['wall_s']:.1f} "
                f"wall s (want {heights} within {CONSENSUS_MAX_VIRTUAL_S} and "
                f"{CONSENSUS_MAX_WALL_S})")
        # every node reached the height, one state a height
        states: dict = {}
        for d in decided:
            for h, st in d.items():
                states.setdefault(h, set()).add(st)
        forks = {h: v for h, v in states.items() if len(v) != 1}
        short = [i for i, d in enumerate(decided)
                 if not set(range(1, heights + 1)) <= set(d)]
        if forks or short:
            raise SystemExit(f"{what}: forks {forks}, nodes short of height "
                             f"{heights}: {short}")
        # the first batch, lane for lane against the host verify
        envs, oks = sidecar.first
        host = [cpu_verify_envelope(e) for e in envs]
        if oks != host or not all(oks):
            raise SystemExit(f"{what}: the first batch ({len(envs)} lanes) "
                             f"differs from the host verify")
        # misses: verified on the card, each a node's own message
        missed = sum(len(m.envs) for m in misses)
        own = all(identity_of(e.pub_x, e.pub_y) == node.identity
                  for m, node in zip(misses, net.nodes) for e in m.envs)
        if missed != stats["cache_misses"]:
            raise SystemExit(f"{what}: {missed} envelopes reached the card "
                             f"verifier for {stats['cache_misses']} misses")
        if not own:
            raise SystemExit(f"{what}: a cache miss was another node's "
                             f"message, not the node's own loopback")
        if not launches.get("K2", {}).get("secp256k1"):
            raise SystemExit(f"{what}: K2 never launched: {launches}")
        # a tampered envelope: False in a card batch, and the engine
        # refuses it (called directly: the network swallows errors)
        good = envs[0]
        bad = W.copy_envelope(good)
        bad.sig_s = bytes(a ^ (i == 31) for i, a in enumerate(good.sig_s))
        if card_v.verify_envelopes([good, bad]) != [True, False]:
            raise SystemExit(f"{what}: the tampered envelope verified")
        try:
            net.nodes[1].receive_message(W.encode(bad), net.now)
        except E.ErrMessageSignature:
            pass
        else:
            raise SystemExit(f"{what}: the engine took the tampered "
                             f"envelope")
        verdict = slo.evaluate(tracer=run_tracer, metrics=csp.metrics)
        p99 = next(r for r in verdict["objectives"]
                   if r["name"] == "round_latency_p99")
        csp.close()
        h = stats["heights"]
        row = {
            "validators": n, "heights": h,
            "virtual_s_per_height": stats["virtual_s"] / h,
            "wall_s": stats["wall_s"],
            "wall_verify_s_per_height": stats["wall_verify_s"] / h,
            "batch_calls": stats["batch_calls"],
            "batched_sigs": stats["batched_sigs"],
            "max_batch": stats["max_batch"],
            "cache_hits": stats["cache_hits"],
            "cache_misses": stats["cache_misses"],
            "launches": launches,
            "first_batch_lanes": len(envs),
            # engine.height spans time the host wall clock of the whole
            # single-process simulation of n nodes, not a round's latency
            # (that is virtual_s_per_height): the SLO's evaluation of them
            # is kept under this name so that it is not read as one
            "sim_host_s_per_height_p99": {k: p99.get(k) for k in (
                "status", "value", "threshold", "count", "reason")},
        }
        row["verify_fits_round"] = (row["wall_verify_s_per_height"]
                                    <= row["virtual_s_per_height"])
        out[n] = row
        log(f"6i consensus ({card}): {n} validators, {h} heights decided "
            f"through CspBatchVerifier(TorchCSP()): " + json.dumps(
                {k: v for k, v in row.items()
                 if k not in ("validators", "heights")}))
        log(f"6i checks, {n} validators: every node at height >= {heights}, "
            f"one state a height; the first batch ({len(envs)} lanes) equal "
            f"to cpu_verify_envelope; {missed} misses verified on the card, "
            f"each a node's own loopback message; a sig_s-flipped envelope "
            f"False on the card and ErrMessageSignature from "
            f"receive_message; launches {launches}")
    return out


# ------------------------------------------------ the transaction flow (6j)
# BASELINE.json config 3: 32 validators, 1000-tx blocks, 2 endorsements;
# one block, not two: two took 183 s of host time to order (a 1000-tx
# block's 32-validator height some 90 s)
TXFLOW_VALIDATORS = 32
TXFLOW_BLOCK_TXS = 1000
TXFLOW_BLOCKS = 1
TXFLOW_HOSTILE_EVERY = 100
TXFLOW_MAX_VIRTUAL_S = 60.0
TXFLOW_MAX_WALL_S = 400.0


def _flow_launches() -> dict:
    from bdls_tpu_torch.ops import block_verify

    seen = _round_launches()
    k7 = {c: n for c, n in block_verify.LAUNCHES_BLOCK.items() if n}
    if k7:
        seen["K7"] = k7
    return seen


def drive_txflow(card: str) -> dict:
    """Phase 6j: endorse → order → commit at config 3 (module
    docstring)."""
    import hashlib as _hashlib

    from bdls_tpu_torch.consensus.identity import Signer
    from bdls_tpu_torch.consensus.verifier import CspBatchVerifier
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.models import txflow as F
    from bdls_tpu_torch.ops import block_verify, ecdsa
    from bdls_tpu_torch.peer.committer import KVState
    from bdls_tpu_torch.peer.validator import EndorsementPolicy, TxValidator

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import _txflow_workload as W

    n, bsz, nblocks = TXFLOW_VALIDATORS, TXFLOW_BLOCK_TXS, TXFLOW_BLOCKS
    what = f"phase 6j, {n} validators, {bsz}-tx blocks"
    t_build = time.perf_counter()
    csp = TorchCSP()
    participants = [Signer.from_scalar(F.SIGNER_BASE + i).identity
                    for i in range(n)]
    card_v = CspBatchVerifier(csp, consenters=participants)
    stack = F.build_stack(csp, card_v, validators=n,
                          max_message_count=bsz, batch_timeout=2.0)
    txs = W.plan(nblocks * bsz, bsz, hostile_every=TXFLOW_HOSTILE_EVERY)
    build_s = time.perf_counter() - t_build

    # per height: the virtual time of its first commit on an orderer
    first_commit = {}
    for chain in stack.chains:
        def on_commit(blk, _net=stack.net):
            first_commit.setdefault(blk.header.number, _net.now)
        chain.on_commit = on_commit
    commits, k7_events = [], []
    for peer in stack.peers:
        def timed(blk, _peer=peer, _inner=peer.deliverer.on_block):
            t = time.perf_counter()
            flags = _inner(blk)
            commits.append({"peer": _peer.org, "block": blk.header.number,
                            "txs": len(blk.data.transactions),
                            "wall_ms": (time.perf_counter() - t) * 1e3,
                            "done": time.perf_counter()})
            return flags
        peer.deliverer.on_block = timed
    real_k7 = block_verify.verify_block_cuda

    def k7_timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_k7(*a, **kw)
        end.record()
        k7_events.append((start, end))
        return out

    blocks0 = csp._c_block_blocks.value()
    block_fb0 = csp._c_block_fallbacks.value()
    block_verify.verify_block_cuda = k7_timed
    try:
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        sub = W.submit_plan(stack, txs)
        log(f"6j ({card}): {len(txs)} transactions submitted in "
            f"{sub.seconds:.1f} s, launches {_flow_launches()}")
        v0, t_drive = stack.net.now, time.perf_counter()
        done = F.drive_until(stack, nblocks + 1, TXFLOW_MAX_VIRTUAL_S,
                             max_wall_s=TXFLOW_MAX_WALL_S)
        drive_s = time.perf_counter() - t_drive
        launches = _flow_launches()
    finally:
        block_verify.verify_block_cuda = real_k7
    torch.cuda.synchronize()
    if not done:
        raise SystemExit(
            f"{what}: peers at heights {[p.height() for p in stack.peers]}, "
            f"orderers at {sorted({c.height() for c in stack.chains})} after "
            f"{stack.net.now - v0:.2f} virtual s and "
            f"{time.perf_counter() - t_drive:.1f} wall s (want "
            f"{nblocks + 1} within {TXFLOW_MAX_VIRTUAL_S} and "
            f"{TXFLOW_MAX_WALL_S})")
    k7_ms = [s.elapsed_time(e) for s, e in k7_events]
    last_commit = max(c["done"] for c in commits)

    # every peer's flags: the expected ones and the host path's
    host = TxValidator(SwCSP(), EndorsementPolicy(required=2),
                       msp=stack.msp, state_get=KVState().get)
    t_host = time.perf_counter()
    ntx = nvalid = 0
    for h in range(1, nblocks + 1):
        blk = stack.peers[0].block_store.get(h)
        raw = list(blk.data.transactions)
        want = [int(sub.expected[_hashlib.sha256(t).digest()]) for t in raw]
        host_flags = [int(f) for f in host.validate_block(blk)]
        if host_flags != want:
            raise SystemExit(f"{what}: block {h}: the host path's flags "
                             f"differ from the expected ones")
        for peer in stack.peers:
            got = peer.block_store.get(h)
            if list(got.data.transactions) != raw:
                raise SystemExit(f"{what}: block {h} differs between peers")
            if list(got.metadata.entries[0]) != want:
                raise SystemExit(f"{what}: {peer.org} block {h}: committed "
                                 f"flags differ from the host path's")
        ntx += len(raw)
        nvalid += sum(1 for f in want if f == 0)
    host_s = time.perf_counter() - t_host
    hostile = {k: sum(1 for v in sub.kinds.values() if v == k)
               for k in W.HOSTILE_KINDS}
    if ntx != nblocks * bsz or nvalid != ntx - sum(hostile.values()):
        raise SystemExit(f"{what}: {ntx} transactions committed, {nvalid} "
                         f"valid, hostile {hostile}")
    states = [p.state.range_query() for p in stack.peers]
    if states[0] != states[1] or dict(states[0]) != sub.writes:
        raise SystemExit(f"{what}: the peers' states differ from each "
                         f"other or from the honest writes")
    ledgers = {tuple(c.ledger.get(i).SerializeToString()
                     for i in range(nblocks + 1)) for c in stack.chains}
    if len(ledgers) != 1:
        raise SystemExit(f"{what}: the orderer ledgers hold {len(ledgers)} "
                         f"different block sequences")
    k7 = launches.get("K7", {}).get("P-256", 0)
    blocks = csp._c_block_blocks.value() - blocks0
    want_k7 = nblocks * len(stack.peers)
    if k7 != want_k7 or blocks != want_k7 or len(k7_ms) != want_k7:
        raise SystemExit(f"{what}: K7 launched {k7} times, "
                         f"tpu_block_blocks_total {blocks}, {len(k7_ms)} "
                         f"timed, want {want_k7}")
    if (csp.stats["fallbacks"] or csp._c_block_fallbacks.value() != block_fb0
            or csp.stats.get("runs") not in (None, "cuda")):
        raise SystemExit(f"{what}: a fallback: {csp.stats}")
    heights = sorted(first_commit)
    per_height = [first_commit[h] - (first_commit[h - 1] if h > 1 else v0)
                  for h in heights]
    for c, ms in zip(commits, k7_ms):
        c["k7_ms"] = ms
        del c["done"]
    row = {
        "validators": n, "block_txs": bsz, "heights": len(heights),
        "virtual_s_per_height": per_height,
        "wall_s": time.perf_counter() - t0, "build_s": build_s,
        "submit_s": sub.seconds, "drive_s": drive_s,
        "host_check_s": host_s,
        "tx_committed": ntx, "tx_valid": nvalid, "hostile": hostile,
        "tx_per_s": ntx / (last_commit - t0),
        "valid_tx_per_s": nvalid / (last_commit - t0),
        "commits": commits, "launches": launches,
        "tpu_block_blocks_total": blocks,
        "net_bytes": stack.net.tx_bytes, "net_msgs": stack.net.tx_msgs,
    }
    csp.close()
    log(f"6j transaction flow ({card}): {n} validators, {len(heights)} "
        f"heights decided, virtual s a height "
        f"{[round(v, 3) for v in per_height]}, wall {row['wall_s']:.1f} s "
        f"(submit {sub.seconds:.1f} s, drive {drive_s:.1f} s), "
        f"{ntx} tx committed ({nvalid} valid) at {row['tx_per_s']:.1f} tx/s "
        f"from the first submit to the last commit (host clock)")
    for c in commits:
        log(f"6j commit ({card}): {c['peer']} block {c['block']} "
            f"({c['txs']} tx): commit_block {c['wall_ms']:.1f} ms wall, "
            f"K7 {c['k7_ms']:.3f} ms CUDA events")
    shown = ", ".join(f"{k} {launches.get(k) or 0}"
                      for k in ("K1", "K2", "K3", "K7"))
    log(f"6j launches ({card}): {shown}; checks: flags equal to "
        f"TxValidator(SwCSP()) on the same blocks and to the built ones "
        f"(hostile {hostile}), both peers' states equal the honest writes "
        f"({len(sub.writes)} keys), {n} orderer ledgers byte-equal, K7 "
        f"{k7} = tpu_block_blocks_total {blocks}")
    return row


# ------------------------------------------------ the orderer node (6k)
# BASELINE.json config 2: 4 BDLS validators, one channel, an empty-tx
# firehose, through four OrdererNodes over the port's authenticated
# cluster on loopback TCP; the batch knobs are make_channel_config's
# defaults (bdls_tpu/ordering/registrar.py:85-96, Fabric's sample
# configtx.yaml): 500 messages, 2 MB preferred, 10 MB absolute, 2 s
# batch timeout, 0.05 s consensus latency
ORDERER_NODES = 4
ORDERER_TXS = 2000
ORDERER_BAD_SIG_EVERY = 100      # i % 100 == 99: one bit of sig_s flipped
ORDERER_BAD_ORG_EVERY = 200      # i % 200 == 149: an org not a writer
ORDERER_DEADLINE_S = 120.0
ORDERER_CHANNEL = "firehose"
ORDERER_EXPECT = {"valid": None, "bad_sig": "ErrBadSignature",
                  "bad_org": "ErrPolicyViolation"}


def orderer_txs(n: int, channel: str = ORDERER_CHANNEL) -> list:
    """``n`` (envelope bytes, kind) of the reference test's ``make_tx``
    shape (``tests/test_ordering.py:42``), signed by an org1 P-256
    client; 1 in ORDERER_BAD_SIG_EVERY has a flipped bit in sig_s, 1 in
    ORDERER_BAD_ORG_EVERY comes from org2, which may not write."""
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.ordering import fabric_codec as pb
    from bdls_tpu_torch.ordering.block import tx_digest

    sw = SwCSP()
    keys = {"org1": sw.key_from_scalar("P-256", 0xC11E47),
            "org2": sw.key_from_scalar("P-256", 0x0C2E47)}
    out = []
    for i in range(n):
        kind = ("bad_sig" if i % ORDERER_BAD_SIG_EVERY == 99 else
                "bad_org" if i % ORDERER_BAD_ORG_EVERY == 149 else "valid")
        org = "org2" if kind == "bad_org" else "org1"
        env = pb.TxEnvelope()
        env.header.type = pb.TxType.TX_NORMAL
        env.header.channel_id = channel
        env.header.tx_id = f"tx-{i}"
        pub = keys[org].public_key()
        env.header.creator_x = pub.x.to_bytes(32, "big")
        env.header.creator_y = pub.y.to_bytes(32, "big")
        env.header.creator_org = org
        env.payload = b"payload-%d" % i
        r, s_ = sw.sign(keys[org], tx_digest(env))
        if kind == "bad_sig":
            s_ ^= 1
        env.sig_r = r.to_bytes(32, "big")
        env.sig_s = s_.to_bytes(32, "big")
        out.append((env.SerializeToString(), kind))
    return out


def aes_check() -> dict:
    """The host AES-256-GCM on this machine: the known answers of
    ``tests/aes_gcm_kat.json`` (made with the ``cryptography`` package,
    which this machine lacks), then one ``MAX_FRAME`` (32 MB) frame
    sealed and opened, each timed alone on the host clock."""
    from bdls_tpu_torch.comm.aead import AESGCM
    from bdls_tpu_torch.comm.cluster import MAX_FRAME

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "aes_gcm_kat.json")
    with open(path) as f:
        vectors = json.load(f)
    for v in vectors:
        aad = None if v["aad"] is None else bytes.fromhex(v["aad"])
        if AESGCM(bytes.fromhex(v["key"])).encrypt(
                bytes.fromhex(v["nonce"]), bytes.fromhex(v["plaintext"]),
                aad).hex() != v["sealed"]:
            raise SystemExit(f"AES-256-GCM: known answer {v} differs")
    g = AESGCM(bytes(range(32)))
    frame = np.random.default_rng(SEED).integers(
        0, 256, MAX_FRAME, dtype=np.uint8).tobytes()
    nonce = (5).to_bytes(12, "little")
    t0 = time.perf_counter()
    sealed = g.encrypt(nonce, frame, None)
    t1 = time.perf_counter()
    opened = g.decrypt(nonce, sealed, None)
    t2 = time.perf_counter()
    if opened != frame:
        raise SystemExit("AES-256-GCM: the 32 MB frame did not open")
    return {"kat": len(vectors), "bytes": MAX_FRAME,
            "seal_s": t1 - t0, "open_s": t2 - t1,
            "seal_mb_per_s": MAX_FRAME / (t1 - t0) / 1e6,
            "open_mb_per_s": MAX_FRAME / (t2 - t1) / 1e6}


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def drive_orderer(card: str, n_tx: int = ORDERER_TXS, make_csp=None,
                  verifier=None, max_message_count: int = 500,
                  batch_timeout_s: float = 2.0) -> dict:
    """Phase 6k: config 2 through four port ``OrdererNode``s (module
    docstring). Each node has its own provider (``make_csp()``,
    ``TorchCSP()`` by default) and a ``FileLedger``; ``verifier=None``
    lets each chain's engine verify on the card. Launch counts are set
    to 0 just before the first broadcast and read after the last
    commit. A host ``make_csp`` and ``verifier`` and smaller batch knobs
    rehearse the phase on the CPU
    (``tests/test_torch_orderer_node.py``); K1 and K2 are then not
    required to launch."""
    import tempfile
    import threading

    from bdls_tpu_torch.comm import aead
    from bdls_tpu_torch.comm import cluster as C
    from bdls_tpu_torch.consensus.identity import Signer
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.models.orderer import OrdererNode
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ordering import fabric_codec as pb
    from bdls_tpu_torch.ordering.chain import FRAME_CONSENSUS
    from bdls_tpu_torch.ordering.registrar import (make_channel_config,
                                                   make_genesis)

    what = f"phase 6k, {ORDERER_NODES} orderer nodes, {n_tx} transactions"
    need_launches = make_csp is None
    make_csp = make_csp or TorchCSP
    deadline_s = ORDERER_DEADLINE_S
    aes = aes_check()
    ch = ORDERER_CHANNEL
    t_sign = time.perf_counter()
    txs = orderer_txs(n_tx)
    sign_s = time.perf_counter() - t_sign
    kinds = [k for _, k in txs]
    n_valid = kinds.count("valid")
    env_bytes = [len(raw) for raw, _ in txs]

    # the instruments: sealed frames and their seconds, failed tags,
    # node 3's pulled blocks and consensus frames, each node's commits
    seal = {"frames": 0, "bytes": 0, "s": 0.0, "largest": 0}
    seal_lock = threading.Lock()
    unseal_fail = [0]
    real_encrypt, real_unseal = aead.AESGCM.encrypt, C.SecureChannel.unseal

    def encrypt(self, nonce, data, aad):
        t = time.perf_counter()
        out = real_encrypt(self, nonce, data, aad)
        dt = time.perf_counter() - t
        with seal_lock:
            seal["frames"] += 1
            seal["bytes"] += len(data)
            seal["s"] += dt
            seal["largest"] = max(seal["largest"], len(data))
        return out

    def unseal(self, sealed):
        frame = real_unseal(self, sealed)
        if frame is None:
            unseal_fail[0] += 1
        return frame

    tmp = tempfile.mkdtemp(prefix="chip_smoke_6k_")
    signers = [Signer.from_scalar(0x6B00 + i) for i in range(ORDERER_NODES)]
    csps = [make_csp() for _ in signers]
    nodes = []
    commit_t = [dict() for _ in signers]
    block_txs: dict = {}
    pulls, cons_sent = [], []
    results = [None] * n_tx
    late = ORDERER_NODES - 1

    def track(i):
        chain = nodes[i].registrar.chains[ch]
        inner = chain.on_commit

        def on_commit(blk):
            commit_t[i].setdefault(blk.header.number, time.perf_counter())
            if i == 0:
                block_txs[blk.header.number] = len(blk.data.transactions)
            inner(blk)
        chain.on_commit = on_commit

    def track_late():
        chain = nodes[late].registrar.chains[ch]
        real_pull = chain.receive_pulled_block

        def pulled(block_bytes, now):
            ok = real_pull(block_bytes, now)
            if ok:
                pulls.append(time.perf_counter())
            return ok
        chain.receive_pulled_block = pulled
        real_send = nodes[late].cluster.send

        def send(identity, channel, payload):
            if payload[:1] == FRAME_CONSENSUS:
                cons_sent.append(time.perf_counter())
            return real_send(identity, channel, payload)
        nodes[late].cluster.send = send

    queue_lock = threading.Lock()
    order = iter(range(n_tx))

    def client(k: int) -> None:
        node = nodes[k]
        while True:
            with queue_lock:
                i = next(order, None)
            if i is None:
                return
            t = time.perf_counter()
            try:
                node.broadcast(txs[i][0])
                err = None
            except Exception as exc:  # noqa: BLE001 — the verdict is kept
                err = type(exc).__name__
            results[i] = (k, t, time.perf_counter(), err)

    aead.AESGCM.encrypt, C.SecureChannel.unseal = encrypt, unseal
    # a node stuck under its lock would stall the checks below too: past
    # the deadline and a minute, dump every thread's stack and exit
    faulthandler.dump_traceback_later(deadline_s + 90.0, exit=True)
    threads = []
    t_join = caught_up = None
    try:
        for i, s in enumerate(signers):
            nodes.append(OrdererNode(s, base_dir=f"{tmp}/node{i}",
                                     csp=csps[i], verifier=verifier))
        for a in nodes:
            for b in nodes:
                if a is not b:
                    a.set_endpoint(b.identity, *b.address)
        genesis = make_genesis(make_channel_config(
            ch, [s.identity for s in signers],
            max_message_count=max_message_count,
            batch_timeout_s=batch_timeout_s, writer_orgs=("org1",)))
        for i in range(late):
            nodes[i].join_channel(genesis)
            track(i)
            nodes[i].start()
        # set-up: the mesh formed, every node to every other (both ends
        # of a simultaneous dial keep the same connection, and a chain
        # relays a pending transaction again: ROADMAP.md Queue C)
        ids = {n.identity for n in nodes}
        t_mesh, stable = time.perf_counter(), 0
        while stable < 2:
            if time.perf_counter() - t_mesh > 30.0:
                raise SystemExit(f"{what}: the cluster mesh did not form")
            full = all(set(n.cluster.connected_peers()) >= ids - {n.identity}
                       for n in nodes)
            stable = stable + 1 if full else 0
            time.sleep(0.5)
        mesh_s = time.perf_counter() - t_mesh
        ecdsa.reset_launches()
        t0 = time.perf_counter()
        for k in range(late):
            threads.append(threading.Thread(target=client, args=(k,),
                                            daemon=True))
            threads[-1].start()
        done = False
        while time.perf_counter() - t0 < deadline_s:
            heights = [n.channel_height(ch) if (j < late or t_join) else 0
                       for j, n in enumerate(nodes)]
            if t_join is None and min(heights[:late]) >= 3:
                # blocks 1 and 2 are on the other three: the late joiner
                # joins two heights behind (one height behind, the
                # engine's own decide message closes the gap, no pull)
                t_join = time.perf_counter()
                nodes[late].join_channel(genesis)
                track(late)
                track_late()
                nodes[late].start()
                threads.append(threading.Thread(target=client,
                                                args=(late,), daemon=True))
                threads[-1].start()
            elif t_join is not None:
                if caught_up is None and heights[late] >= heights[0]:
                    caught_up = time.perf_counter()
                if (len(set(heights)) == 1
                        and not any(t.is_alive() for t in threads)
                        and sum(block_txs.get(h, 0)
                                for h in range(1, heights[0])) >= n_valid):
                    done = True
                    break
            time.sleep(0.02)
        t_done = time.perf_counter()
        launches = _round_launches()
        heights = [n.channel_height(ch) if (j < late or t_join) else 0
                   for j, n in enumerate(nodes)]
    finally:
        aead.AESGCM.encrypt, C.SecureChannel.unseal = real_encrypt, real_unseal
        for n in nodes:
            n.stop()
        faulthandler.cancel_dump_traceback_later()
    if not done:
        raise SystemExit(
            f"{what}: heights {heights}, {sum(block_txs.values())} of "
            f"{n_valid} valid transactions ordered, the late joiner "
            f"{'joined' if t_join else 'never joined'}, after "
            f"{t_done - t0:.1f} s (deadline {deadline_s} s)")

    # the four ledgers, byte for byte, and what they hold
    H = heights[0]
    ledgers = [[b.SerializeToString() for b in n.deliver(ch, 0, H - 1)]
               for n in nodes]
    if any(lg != ledgers[0] for lg in ledgers):
        raise SystemExit(f"{what}: the four ledgers differ")
    by_id = {f"tx-{i}": i for i in range(n_tx)}
    in_block, blocks = {}, []
    for raw in ledgers[0][1:]:
        blk = pb.Block.FromString(raw)
        blocks.append({"number": blk.header.number,
                       "txs": len(blk.data.transactions),
                       "bytes": len(raw)})
        for t in blk.data.transactions:
            i = by_id[pb.TxEnvelope.FromString(t).header.tx_id]
            if i in in_block:
                raise SystemExit(f"{what}: tx-{i} ordered twice")
            in_block[i] = blk.header.number
    hostile_in = [i for i in in_block if kinds[i] != "valid"]
    missing = [i for i in range(n_tx) if kinds[i] == "valid"
               and i not in in_block]
    if hostile_in or missing:
        raise SystemExit(f"{what}: hostile transactions ordered "
                         f"{hostile_in[:5]}, valid ones missing "
                         f"{missing[:5]} ({len(missing)})")
    wrong = [(i, kinds[i], r[3]) for i, r in enumerate(results)
             if r is None or r[3] != ORDERER_EXPECT[kinds[i]]]
    if wrong:
        raise SystemExit(f"{what}: broadcasts with the wrong outcome "
                         f"(index, kind, error): {wrong[:5]} ({len(wrong)})")
    auth_fail = [n.cluster.stats["auth_fail"] for n in nodes]
    if any(auth_fail) or unseal_fail[0]:
        raise SystemExit(f"{what}: auth_fail {auth_fail}, failed tags "
                         f"{unseal_fail[0]}")
    if need_launches and not (launches.get("K1") or launches.get("K2")):
        raise SystemExit(f"{what}: K1 and K2 never launched: {launches}")
    fallbacks = [getattr(c, "stats", {}).get("fallbacks", 0) for c in csps]
    if any(fallbacks):
        raise SystemExit(f"{what}: provider fallbacks {fallbacks}")
    own = [h for h in range(1, H) if commit_t[late].get(h) is not None]
    after_pull = [t for t in cons_sent if pulls and t > pulls[-1]]
    if not pulls or not after_pull or len(pulls) >= len(own):
        raise SystemExit(f"{what}: the late joiner pulled {len(pulls)} "
                         f"blocks of {len(own)} and sent "
                         f"{len(after_pull)} consensus frames after its "
                         f"last pull")

    # the measures, on the host clock
    first = min(r[1] for r in results)
    last_commit = max(commit_t[j][H - 1] for j in range(ORDERER_NODES))
    valid = [i for i in range(n_tx) if kinds[i] == "valid"]
    bcast_ms = [(results[i][2] - results[i][1]) * 1e3 for i in valid]
    s2c_ms = [(min(commit_t[j][in_block[i]] for j in range(ORDERER_NODES)
                   if in_block[i] in commit_t[j]) - results[i][2]) * 1e3
              for i in valid]
    node0 = nodes[0]
    gauges = {name: g.value((ch,)) for name, g in (("committed_block_number", node0._g_block),
                              ("is_leader", node0._g_leader),
                              ("leader_id", node0._g_leader_id),
                              ("cluster_size", node0._g_cluster),
                              ("normal_proposals_received", node0._c_normal),
                              ("config_proposals_received", node0._c_config),
                              ("active_nodes", node0._g_active))}
    row = {
        "nodes": ORDERER_NODES, "txs": n_tx, "valid": n_valid,
        "hostile": {k: kinds.count(k) for k in ("bad_sig", "bad_org")},
        "envelope_bytes": {"min": min(env_bytes), "max": max(env_bytes),
                           "mean": sum(env_bytes) / len(env_bytes)},
        "sign_s": sign_s, "mesh_s": mesh_s, "height": H,
        "blocks": blocks,
        "wall_s": t_done - t0,
        "tx_per_s": n_valid / (last_commit - first),
        "broadcast_ms": {"median": _pct(bcast_ms, 0.5),
                         "p99": _pct(bcast_ms, 0.99)},
        "submit_to_commit_ms": {"median": _pct(s2c_ms, 0.5),
                                "p99": _pct(s2c_ms, 0.99)},
        "late_joiner": {"joined_after_s": t_join - t0,
                        "caught_up_s": (caught_up or t_done) - t_join,
                        "pulled_blocks": len(pulls),
                        "consensus_frames_after_pull": len(after_pull),
                        "blocks_not_pulled": len(own) - len(pulls)},
        "sealed": {**seal, "mb_per_s": seal["bytes"] / seal["s"] / 1e6
                   if seal["s"] else None},
        "aes_gcm_max_frame": aes,
        "auth_fail": auth_fail, "launches": launches,
        "gauges_node0": gauges,
        "cluster_stats": [dict(n.cluster.stats) for n in nodes],
        "relays": [{k: getattr(n.registrar.chains[ch].metrics, k)
                    for k in ("relays_sent", "relays_failed",
                              "relays_resent")} for n in nodes],
    }
    for c in csps:
        getattr(c, "close", lambda: None)()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"6k orderer nodes ({card}): {ORDERER_NODES} OrdererNodes in one "
        f"process over the port's cluster on loopback TCP, {n_tx} "
        f"transactions ({n_valid} valid, signed in {sign_s:.1f} s before "
        f"the window), {H - 1} blocks {[b['txs'] for b in blocks]} in "
        f"{row['wall_s']:.1f} s: {row['tx_per_s']:.1f} valid tx/s from the "
        f"first broadcast to the last commit on the slowest node (host "
        f"clock); broadcast {row['broadcast_ms']['median']:.2f} ms median, "
        f"{row['broadcast_ms']['p99']:.2f} ms p99; submit to commit "
        f"{row['submit_to_commit_ms']['median']:.1f} ms median, "
        f"{row['submit_to_commit_ms']['p99']:.1f} ms p99")
    log(f"6k late joiner ({card}): joined {t_join - t0:.2f} s after the "
        f"first broadcast, caught up in "
        f"{row['late_joiner']['caught_up_s']:.2f} s, pulled {len(pulls)} "
        f"blocks (proofs verified by its engine's verifier), then sent "
        f"{len(after_pull)} consensus frames and committed "
        f"{len(own) - len(pulls)} blocks itself")
    log(f"6k cluster ({card}): {seal['frames']} frames sealed, "
        f"{seal['bytes']} bytes, the largest {seal['largest']}, AES-GCM "
        f"{row['sealed']['mb_per_s'] or 0:.1f} MB/s in seal calls beside "
        f"the node threads; alone, a {aes['bytes']}-byte frame sealed at "
        f"{aes['seal_mb_per_s']:.0f} MB/s and opened at "
        f"{aes['open_mb_per_s']:.0f} MB/s, {aes['kat']} known answers "
        f"equal; "
        f"auth_fail {auth_fail}, failed tags {unseal_fail[0]}; launches "
        f"{launches}; node 0's gauges {gauges}")
    log(f"6k relays ({card}): each node's chain (sent, refused, sent "
        f"again) {[tuple(r.values()) for r in row['relays']]}; each "
        f"node's cluster (refused sends, router errors) "
        f"{[(c['send_refused'], c['router_errors']) for c in row['cluster_stats']]}")
    log(f"6k checks ({card}): the four ledgers byte-equal, every valid "
        f"transaction once, every hostile broadcast refused "
        f"({ORDERER_EXPECT['bad_sig']}, {ORDERER_EXPECT['bad_org']}), no "
        f"provider fallback")
    return row

# ------------------------------------------ the peer's network plane (6l)
# BASELINE.json config 3's blocks (1000-tx blocks, each transaction
# endorsed by org1 and org2 with P-256 keys, 1 in 100 hostile, as 6j)
# through gossiping peers. The endorsement policy is Fabric's sample
# configtx.yaml application default, `Endorsement: ImplicitMeta
# "MAJORITY Endorsement"` over org1.member and org2.member; the gossip
# knobs are Fabric's sample core.yaml peer.gossip defaults:
# propagatePeerNum 3 (the fanout), aliveTimeInterval 5 s,
# aliveExpirationTimeout 25 s, election.leaderElectionDuration 5 s.
# Fabric's integration/nwo standard networks have 2 peer orgs; here each
# has 4 peers, so that a fanout of 3 does not reach every peer in one hop
PEER_ORGS = ("org1", "org2")
PEERS_PER_ORG = 4
PEER_BLOCKS = 3
PEER_BLOCK_TXS = 1000
PEER_HOSTILE_EVERY = 100
PEER_FANOUT = 3
PEER_ALIVE = {"alive_interval": 5.0, "dead_after": 25.0, "lead_after": 5.0}
PEER_STEP_S = 0.25
PEER_MAX_STEPS = 480             # a stage's limit: 120 virtual s
# org p's peer j signs with P-256 scalar PEER_SCALAR[org] + j; org2's
# peer0 has the smaller identity, so it leads first and the bootstrap
# peer (org1 peer0) stays online when the leader goes
PEER_SCALAR = {"org1": 0x6C10, "org2": 0x6C20}
PEER_OUTSIDER = 0x6C99           # a key the MSP never registers


class _ListSource:
    """The orderer stand-in: a fixed block list, revealed up to
    ``limit``; each block handed out is a copy, as a deliver stream's."""

    def __init__(self, blocks):
        self.blocks = list(blocks)
        self.limit = 1

    def height(self) -> int:
        return self.limit

    def get_block(self, n: int):
        if n >= self.limit:
            return None
        return type(self.blocks[n]).FromString(
            self.blocks[n].SerializeToString())


class _TimedVerify:
    """A peer's provider as its DiscoveryNode sees it: each alive check's
    host ms and the launches it took are kept."""

    def __init__(self, csp, checks: list):
        self._csp = csp
        self._checks = checks

    def verify(self, req) -> bool:
        before = _round_launches()
        t = time.perf_counter()
        ok = self._csp.verify(req)
        ms = (time.perf_counter() - t) * 1e3
        self._checks.append((ms, _launch_delta(before, _round_launches())))
        return ok

    def __getattr__(self, name):
        return getattr(self._csp, name)


def _launch_delta(before: dict, after: dict) -> dict:
    return {k: sum(after.get(k, {}).values()) - sum(before.get(k, {})
                                                    .values())
            for k in set(after) | set(before)
            if sum(after.get(k, {}).values()) != sum(before.get(k, {})
                                                      .values())}


def peer_plane_blocks(make_csp, n_blocks: int, block_txs: int,
                      hostile_every: int, offset: int = 50):
    """Genesis and ``n_blocks`` blocks of ``block_txs`` kvput
    transactions, built as ``tests/_txflow_workload.py`` builds them (an
    ``Endorser`` a org, the client's signature as ``Gateway.submit``
    makes it, its four hostile kinds), on a provider of their own."""
    import types

    from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
    from bdls_tpu_torch.models import txflow as F
    from bdls_tpu_torch.models.peer import Gateway, PeerNode
    from bdls_tpu_torch.ordering.block import (genesis_block, header_hash,
                                               make_block)
    from bdls_tpu_torch.peer.validator import EndorsementPolicy

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import _txflow_workload as W

    csp = make_csp()
    try:
        msp = LocalMSP(csp)
        for org, scalar in F.ORG_SCALARS[:2]:
            msp.register(Identity(org=org, key=csp.key_from_scalar(
                "P-256", scalar).public_key()))
        client = csp.key_from_scalar("P-256", F.CLIENT_SCALAR)
        msp.register(Identity(org=F.CLIENT_ORG, key=client.public_key()))
        genesis = genesis_block(F.CHANNEL)
        peers = []
        for org, scalar in F.ORG_SCALARS[:2]:
            peer = PeerNode(channel_id=F.CHANNEL, csp=csp, org=org,
                            signing_key=csp.key_from_scalar("P-256", scalar),
                            genesis=genesis, orderer_sources=[],
                            policy=EndorsementPolicy(required=2), msp=msp)
            peer.endorser.register_contract("kvput", F.kv_put_contract)
            peers.append(peer)
        envs = []
        gw = Gateway(csp, client, F.CLIENT_ORG, peers, broadcast=envs.append,
                     required_orgs=2)
        txs = W.plan(n_blocks * block_txs, block_txs, hostile_every, offset)
        sub = W.submit_plan(types.SimpleNamespace(gateway=gw, peers=peers,
                                                  csp=csp), txs)
    finally:
        getattr(csp, "close", lambda: None)()
    blocks = [genesis]
    for b in range(n_blocks):
        blocks.append(make_block(b + 1, header_hash(blocks[-1].header),
                                 envs[b * block_txs:(b + 1) * block_txs]))
    return blocks, sub, txs


def _plane_msp(csp):
    """The channel MSP on one peer's provider: the endorsers, the client
    and every peer's own key; not the rogue endorser, not the
    outsider."""
    from bdls_tpu_torch.crypto.msp import Identity, LocalMSP
    from bdls_tpu_torch.models import txflow as F

    msp = LocalMSP(csp)
    for org, scalar in F.ORG_SCALARS[:2] + ((F.CLIENT_ORG, F.CLIENT_SCALAR),):
        msp.register(Identity(org=org, key=csp.key_from_scalar(
            "P-256", scalar).public_key()))
    for org in PEER_ORGS:
        for j in range(PEERS_PER_ORG):
            msp.register(Identity(org=org, key=csp.key_from_scalar(
                "P-256", PEER_SCALAR[org] + j).public_key()))
    return msp


def _peer_timeline(make_csp, blocks, tmp: str, card: bool) -> dict:
    """The timeline of phase 6l (module docstring) over ``blocks`` on
    one provider a peer (``make_csp()``). Returns the run's nodes and
    what it saw; the checks are the caller's."""
    from bdls_tpu_torch.models import txflow as F
    from bdls_tpu_torch.models.peer import PeerNode
    from bdls_tpu_torch.ops import block_verify, ecdsa
    from bdls_tpu_torch.peer.gossip import GossipNode
    from bdls_tpu_torch.peer.membership import AliveMsg, DiscoveryNode
    from bdls_tpu_torch.peer.snapshot import (bootstrap_from_snapshot,
                                              export_snapshot)
    from bdls_tpu_torch.peer.validator import EndorsementPolicy

    n_blocks = len(blocks) - 1
    source = _ListSource(blocks)
    registry: dict = {}
    names, csps, nodes = [], [], []
    alive_checks, decisions, commits = [], [], []
    step_s, leaders = {}, []
    now = 0.0

    def log_admit(node):
        inner = node._admit

        def admit(msg, t):
            rejected = node.stats["alive_rejected"]
            ok = inner(msg, t)
            decisions.append((t, node.endpoint, msg.endpoint, msg.seq,
                              ok, node.stats["alive_rejected"] - rejected))
            return ok
        node._admit = admit

    def timed_commit(name, peer):
        inner = peer.committer.commit_block

        def commit(blk):
            t = time.perf_counter()
            flags = inner(blk)
            commits.append({"peer": name, "block": blk.header.number,
                            "ms": (time.perf_counter() - t) * 1e3})
            return flags
        peer.committer.commit_block = commit
        if peer.deliverer is not None:
            peer.deliverer.on_block = commit

    def add_node(name, org, peer, key, seed):
        node = DiscoveryNode(GossipNode(peer, fanout=PEER_FANOUT, seed=seed),
                             endpoint=f"{name}:7051", registry=registry,
                             signing_key=key, org=org, **PEER_ALIVE)
        node.csp = _TimedVerify(node.csp, alive_checks)
        log_admit(node)
        timed_commit(name, peer)
        names.append(name)
        nodes.append(node)
        return node

    for org in PEER_ORGS:
        for j in range(PEERS_PER_ORG):
            if (org, j) == ("org2", PEERS_PER_ORG - 1):
                continue                      # the snapshot joiner, later
            csp = make_csp()
            csps.append(csp)
            key = csp.key_from_scalar("P-256", PEER_SCALAR[org] + j)
            peer = PeerNode(channel_id=F.CHANNEL, csp=csp, org=org,
                            signing_key=key, genesis=blocks[0],
                            orderer_sources=[source] if j == 0 else [],
                            policy=EndorsementPolicy(required=2),
                            msp=_plane_msp(csp))
            add_node(f"{org}-peer{j}", org, peer, key, len(nodes))
    by = dict(zip(names, nodes))
    first, second = by["org2-peer0"], by["org1-peer0"]
    if not first.identity < second.identity:
        raise SystemExit("phase 6l: org2 peer0's identity is not the "
                         "smaller one; the timeline needs it to lead first")

    def online():
        return [n for n in nodes if n.gossip.online]

    def drive(stage, cond):
        nonlocal now
        t = time.perf_counter()
        for _ in range(PEER_MAX_STEPS):
            now += PEER_STEP_S
            for node in nodes:
                node.tick(now)
            up = [n.endpoint for n in online() if n.is_leader(now)]
            leaders.append(up)
            if cond():
                step_s[stage] = time.perf_counter() - t
                return
        raise SystemExit(
            f"phase 6l, stage {stage}: not reached in {PEER_MAX_STEPS} "
            f"steps: heights {[n.peer.height() for n in nodes]}, views "
            f"{[len(n.view) for n in nodes]}, leaders {leaders[-1]}")

    k7_events = []
    real_k7 = block_verify.verify_block_cuda

    def k7_timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_k7(*a, **kw)
        end.record()
        k7_events.append((start, end))
        return out

    started = list(nodes)
    if card:
        block_verify.verify_block_cuda = k7_timed
    ecdsa.reset_launches()
    try:
        # 1. seven peers; each but org1 peer0 bootstraps to org1 peer0
        for node in nodes[1:]:
            node.bootstrap(second.endpoint, now)
        drive("1_membership", lambda: all(
            len(n.view) == len(started) - 1 for n in started)
            and sum(n.is_leader(now) for n in started) == 1)
        # a tampered alive (a member's, one bit of s flipped) and an
        # outsider's, both at org1 peer2
        def signed_alive(scalar, endpoint, flip=0):
            key = csps[0].key_from_scalar("P-256", scalar)
            pub = key.public_key()
            msg = AliveMsg("org1", pub.x, pub.y, endpoint, 10**6)
            r, s_ = csps[0].sign(key, msg.tbs_digest())
            return AliveMsg("org1", pub.x, pub.y, endpoint, 10**6, r,
                            s_ ^ flip)

        target = by["org1-peer2"]
        tampered = signed_alive(PEER_SCALAR["org1"] + 1, "org1-peer1:7051",
                                flip=1)
        outsider = signed_alive(PEER_OUTSIDER, "outsider:7051")
        rejected = target.stats["alive_rejected"]
        target.receive_alive([tampered, outsider], by["org1-peer1"], now)
        hostile_alive = {
            "refused": target.stats["alive_rejected"] - rejected,
            "in_view": [target.view.get(m.ident(), (None,))[0] == m
                        for m in (tampered, outsider)]}
        # 2. blocks 1..n-1
        source.limit = n_blocks
        drive("2_blocks", lambda: all(n.peer.height() == n_blocks
                                      for n in started))
        # 3. the leader goes offline; 4. the last block
        leader = [n for n in started if n.is_leader(now)][0]
        leader.gossip.online = False
        source.limit = n_blocks + 1

        def failed_over():
            up = [n for n in online() if n.is_leader(now)]
            return (len(up) == 1 and up[0] is not leader
                    and all(n.peer.height() == n_blocks + 1
                            for n in online()))
        drive("4_failover", failed_over)
        # 5. org1 peer1's snapshot; org2's last peer starts from it and
        # joins through org1 peer0; then the old leader comes back and
        # catches up in one anti-entropy round
        t_snap = time.perf_counter()
        path = os.path.join(tmp, "org1-peer1.snapshot")
        header = export_snapshot(by["org1-peer1"].peer, path)
        snap_bytes = os.path.getsize(path)
        csp = make_csp()
        csps.append(csp)
        jname = f"org2-peer{PEERS_PER_ORG - 1}"
        jkey = csp.key_from_scalar("P-256", PEER_SCALAR["org2"] +
                                   PEERS_PER_ORG - 1)
        jpeer = bootstrap_from_snapshot(
            path, csp, "org2", jkey, orderer_sources=(),
            policy=EndorsementPolicy(required=2), msp=_plane_msp(csp))
        joiner = add_node(jname, "org2", jpeer, jkey, len(nodes))
        joiner.bootstrap(second.endpoint, now)
        drive("5_snapshot_joiner", lambda: joiner.peer.height() ==
              n_blocks + 1 and len(joiner.view) >= len(online()) - 1)
        joiner_s = time.perf_counter() - t_snap
        leader.gossip.online = True
        leader.gossip.anti_entropy()
        if card:
            torch.cuda.synchronize()
        launches = _flow_launches()
    finally:
        block_verify.verify_block_cuda = real_k7
    return {"nodes": nodes, "csps": csps, "by": by,
            "leader": leader, "joiner": joiner,
            "alive_checks": alive_checks, "decisions": decisions,
            "commits": commits, "k7_events": k7_events, "step_s": step_s,
            "leaders": leaders, "hostile_alive": hostile_alive,
            "snapshot": {"bytes": snap_bytes, "height": header["height"],
                         "joiner_s": joiner_s},
            "launches": launches, "now": now}


def _kv(peer) -> list:
    return [(k, peer.state.get(k), peer.state.version(k))
            for k in peer.state.keys()]


def drive_peer_plane(card: str, n_blocks: int = PEER_BLOCKS,
                     block_txs: int = PEER_BLOCK_TXS,
                     hostile_every: int = PEER_HOSTILE_EVERY,
                     offset: int = 50, make_csp=None) -> dict:
    """Phase 6l: config 3's blocks through a gossiping peer network
    (module docstring). ``make_csp`` (``TorchCSP`` by default) makes each
    peer's provider; a host ``make_csp`` and smaller blocks rehearse the
    phase on the CPU (``tests/test_torch_peer_plane.py``), and K1, K2
    and K7 are then not required to launch."""
    import tempfile

    from bdls_tpu_torch.crypto.csp import PublicKey
    from bdls_tpu_torch.crypto.msp import Identity, SignedData
    from bdls_tpu_torch.crypto.policy import (ImplicitMetaPolicy,
                                              SignaturePolicy, from_dsl)
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.models import txflow as F
    from bdls_tpu_torch.ordering import fabric_codec as pb
    from bdls_tpu_torch.peer.ccruntime import ExternalContract
    from bdls_tpu_torch.peer.discovery import (ChannelTopology,
                                               DiscoveryService, PeerRecord)
    from bdls_tpu_torch.peer.endorser import Endorser, Proposal, sign_proposal
    from bdls_tpu_torch.peer.validator import (EndorsementPolicy, TxFlag,
                                               endorsement_preimage)

    what = (f"phase 6l, {len(PEER_ORGS) * PEERS_PER_ORG} peers, "
            f"{n_blocks} blocks of {block_txs} transactions")
    need_launches = make_csp is None
    make_csp = make_csp or TorchCSP
    tmp = tempfile.mkdtemp(prefix="chip_smoke_6l_")
    t_all = time.perf_counter()

    # the membership timeline on the host first, over blocks of one
    # transaction: the alive messages, and the verdict each receiver
    # gives each, do not depend on the blocks' size
    t0 = time.perf_counter()
    tiny, _, _ = peer_plane_blocks(SwCSP, n_blocks, 1, 0)
    host = _peer_timeline(SwCSP, tiny, tmp, card=False)
    host_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    blocks, sub, txs = peer_plane_blocks(make_csp, n_blocks, block_txs,
                                         hostile_every, offset)
    build_s = time.perf_counter() - t0
    run = _peer_timeline(make_csp, blocks, tmp, card=need_launches)
    nodes, by, csps = run["nodes"], run["by"], run["csps"]
    H = n_blocks + 1

    # ---- checks -----------------------------------------------------
    heights = [n.peer.height() for n in nodes]
    if heights != [H] * len(nodes):
        raise SystemExit(f"{what}: heights {heights}, want {H}")
    ref = by["org1-peer1"].peer
    for n in nodes:
        # the snapshot joiner's store starts at its anchor
        for h in range(getattr(n.peer.block_store, "_base", 0), H):
            if (n.peer.get_block(h).SerializeToString()
                    != ref.get_block(h).SerializeToString()):
                raise SystemExit(f"{what}: {n.endpoint} block {h} differs")
        if _kv(n.peer) != _kv(ref):
            raise SystemExit(f"{what}: {n.endpoint}'s KV state differs")
    for h in range(1, H):
        blk = ref.get_block(h)
        want = [int(sub.expected[hashlib.sha256(t).digest()])
                for t in blk.data.transactions]
        if list(blk.metadata.entries[0]) != want:
            raise SystemExit(f"{what}: block {h}'s flags differ from the "
                             f"ones its transactions were built to get")
    hostile = {k: list(sub.kinds.values()).count(k)
               for k in sorted(set(sub.kinds.values()))}
    if dict(ref.state.range_query()) != sub.writes:
        raise SystemExit(f"{what}: the KV state differs from the honest "
                         f"writes")
    if run["decisions"] != host["decisions"]:
        diff = next(i for i, (a, b) in enumerate(zip(run["decisions"],
                                                     host["decisions"]))
                    if a != b) if run["decisions"] and host["decisions"] \
            else 0
        raise SystemExit(f"{what}: {len(run['decisions'])} alive decisions "
                         f"against the host run's {len(host['decisions'])}; "
                         f"the first to differ, #{diff}")
    ha = run["hostile_alive"]
    if ha != {"refused": 2, "in_view": [False, False]}:
        raise SystemExit(f"{what}: the tampered and the outsider's alive "
                         f"messages: {ha}")
    seq = []
    for up in run["leaders"]:
        if len(up) > 1:
            raise SystemExit(f"{what}: two leaders at once: {up}")
        if up and (not seq or seq[-1] != up[0]):
            seq.append(up[0])
    if seq != ["org2-peer0:7051", "org1-peer0:7051"]:
        raise SystemExit(f"{what}: the leaders in turn were {seq}")
    joiner = run["joiner"]
    replayed = [c for c in run["commits"]
                if c["peer"] == joiner.endpoint.split(":")[0]]
    if replayed or any(joiner.peer.get_block(h) is not None
                       for h in range(H - 1)):
        raise SystemExit(f"{what}: the snapshot joiner replayed "
                         f"{replayed}")
    gstats = {k: sum(n.gossip.stats[k] for n in nodes)
              for k in nodes[0].gossip.stats}
    if not gstats["pushed"] or not gstats["transferred"]:
        raise SystemExit(f"{what}: no push or no state transfer: {gstats}")
    launches = run["launches"]
    if need_launches:
        if not (launches.get("K1") or launches.get("K2")) or \
                not launches.get("K7"):
            raise SystemExit(f"{what}: launches {launches}")
        fb = [c.stats["fallbacks"] for c in csps] + \
            [c._c_block_fallbacks.value() for c in csps]
        if any(fb) or any(c.stats.get("runs") != "cuda" for c in csps):
            raise SystemExit(f"{what}: a fallback: {fb}")
        k7 = sum(launches["K7"].values())
        if k7 != len(run["commits"]) or len(run["k7_events"]) != k7:
            raise SystemExit(f"{what}: K7 launched {k7} times for "
                             f"{len(run['commits'])} commits")

    # ---- the policy on org1 peer1's provider -----------------------
    msp = by["org1-peer1"].peer.msp
    policy = ImplicitMetaPolicy("MAJORITY", [
        SignaturePolicy(from_dsl("OR('org1.member')"), msp),
        SignaturePolicy(from_dsl("OR('org2.member')"), msp)])
    flags = list(run["leader"].peer.get_block(1).metadata.entries[0])
    judged, policy_ms, first_valid = 0, [], None
    for t, raw in enumerate(blocks[1].data.transactions):
        if flags[t] not in (TxFlag.VALID, TxFlag.ENDORSEMENT_POLICY_FAILURE):
            continue
        env = pb.TxEnvelope.FromString(raw)
        action = pb.EndorsedAction.FromString(env.payload)
        data = endorsement_preimage(action)
        signed = [SignedData(data, Identity(e.org, PublicKey(
            "P-256", int.from_bytes(e.endorser_x, "big"),
            int.from_bytes(e.endorser_y, "big"))),
            int.from_bytes(e.sig_r, "big"), int.from_bytes(e.sig_s, "big"))
            for e in action.endorsements]
        t1 = time.perf_counter()
        ok = policy.evaluate(signed)
        policy_ms.append((time.perf_counter() - t1) * 1e3)
        if ok != (flags[t] == TxFlag.VALID):
            raise SystemExit(f"{what}: block 1 tx {t}: the policy says "
                             f"{ok}, K7's flag {TxFlag(flags[t]).name}")
        if ok and first_valid is None:
            first_valid = signed
        judged += 1
    svc = DiscoveryService(msp)
    svc.register_channel(ChannelTopology(
        channel_id=F.CHANNEL,
        peers=[PeerRecord(n.org, n.endpoint, n.peer.height())
               for n in nodes],
        policies={"kvput": EndorsementPolicy(
            required=2, orgs=frozenset(PEER_ORGS))}))
    desc = svc.endorsement_descriptor(F.CHANNEL, "kvput")
    layout_ok = [policy.evaluate([sd for sd in first_valid
                                  if sd.identity.org in layout])
                 for layout in desc.layouts]
    if not layout_ok or not all(layout_ok):
        raise SystemExit(f"{what}: discovery's layouts {desc.layouts}: "
                         f"the policy says {layout_ok}")

    # ---- block 1's write-sets again, through the contract runtime ----
    import inspect

    src = os.path.join(tmp, "kvput_contract.py")
    with open(src, "w") as f:
        f.write(inspect.getsource(F.kv_put_contract))
    ext = ExternalContract(src, "kv_put_contract", timeout=10.0)
    ecsp = make_csp()
    try:
        endorser = Endorser(ecsp, ecsp.key_from_scalar(
            "P-256", F.ORG_SCALARS[0][1]), "org1", by["org1-peer1"].peer.state)
        endorser.register_contract("kvput", ext)
        sw = SwCSP()
        client = sw.key_from_scalar("P-256", F.CLIENT_SCALAR)
        t1 = time.perf_counter()
        same = 0
        for t, raw in enumerate(blocks[1].data.transactions):
            env = pb.TxEnvelope.FromString(raw)
            try:
                action = pb.EndorsedAction.FromString(env.payload)
            except Exception:  # noqa: BLE001 — the bad payload
                continue
            plan = txs[t]
            prop = sign_proposal(sw, client, Proposal(
                channel_id=F.CHANNEL, contract="kvput", args=list(plan.args),
                creator_x=b"", creator_y=b"", creator_org=F.CLIENT_ORG))
            got = endorser.process_proposal(prop)
            if (got.write_set.SerializeToString()
                    != action.write_set.SerializeToString()):
                raise SystemExit(f"{what}: block 1 tx {t}: the contract "
                                 f"runtime's write-set differs")
            same += 1
        ext_s = time.perf_counter() - t1
        ext_stats = dict(ext.stats)
    finally:
        ext.close()
        getattr(ecsp, "close", lambda: None)()

    # ---- figures ------------------------------------------------------
    k7_ms = [s.elapsed_time(e) for s, e in run["k7_events"]]
    per_block = {}
    for c in run["commits"]:
        per_block.setdefault(c["block"], []).append(c["ms"])
    checks_ms = sorted(ms for ms, _ in run["alive_checks"])
    alive_launches = {}
    for _, d in run["alive_checks"]:
        for k, v in d.items():
            alive_launches[k] = alive_launches.get(k, 0) + v
    mstats = {k: sum(n.stats[k] for n in nodes) for k in nodes[0].stats}
    row = {
        "peers": len(nodes), "blocks": n_blocks, "block_txs": block_txs,
        "hostile": hostile, "build_s": build_s, "host_run_s": host_s,
        "step_s": run["step_s"], "virtual_s": run["now"],
        "commits": {str(b): {"peers": len(v), "median_ms": _pct(v, 0.5),
                             "max_ms": max(v)}
                    for b, v in sorted(per_block.items())},
        "k7_ms": k7_ms,
        "alive_checks": {"count": len(checks_ms),
                         "launches": alive_launches,
                         "median_ms": _pct(checks_ms, 0.5) if checks_ms
                         else None,
                         "p99_ms": _pct(checks_ms, 0.99) if checks_ms
                         else None},
        "alive_decisions": len(run["decisions"]),
        "policy": {"txs": judged, "ms_per_tx": sum(policy_ms) / len(policy_ms)
                   if policy_ms else None,
                   "layouts": desc.layouts},
        "contract_runtime": {"txs": same, "s": ext_s, **ext_stats},
        "gossip_stats": gstats, "membership_stats": mstats,
        "snapshot": run["snapshot"], "leaders": seq,
        "launches": launches, "wall_s": time.perf_counter() - t_all,
    }
    for c in csps:
        getattr(c, "close", lambda: None)()
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"6l peer plane ({card}): {len(nodes)} peers, {n_blocks} blocks of "
        f"{block_txs} tx (built in {build_s:.1f} s before the window, "
        f"from an orderer stand-in), membership timeline on the host first "
        f"in {host_s:.1f} s; stages {', '.join(f'{k} {v:.1f} s' for k, v in run['step_s'].items())} "
        f"(wall), {run['now']:.2f} virtual s")
    for b, v in row["commits"].items():
        log(f"6l block {b} ({card}): commit_block on {v['peers']} peers "
            f"median {v['median_ms']:.1f} ms, max {v['max_ms']:.1f} ms")
    log(f"6l K7 ({card}): {len(k7_ms)} launches, CUDA events "
        f"{[round(m, 3) for m in k7_ms]} ms")
    ac = row["alive_checks"]
    log(f"6l alive checks ({card}): {ac['count']} checks, launches "
        f"{ac['launches']}, median {ac['median_ms'] or 0:.3f} ms, p99 "
        f"{ac['p99_ms'] or 0:.3f} ms a check (host clock); "
        f"{len(run['decisions'])} decisions equal to the host run's")
    log(f"6l policy ({card}): ImplicitMeta MAJORITY over org1.member and "
        f"org2.member on {judged} transactions of block 1, "
        f"{row['policy']['ms_per_tx'] or 0:.3f} ms a transaction, each "
        f"verdict equal to K7's flag; discovery's layouts {desc.layouts}")
    log(f"6l contract runtime ({card}): {same} write-sets of block 1 "
        f"byte-equal through ExternalContract in {ext_s:.1f} s, "
        f"{ext_stats}")
    log(f"6l gossip ({card}): {gstats}; membership {mstats}; leaders in "
        f"turn {seq}")
    log(f"6l snapshot ({card}): {run['snapshot']['bytes']} bytes at height "
        f"{run['snapshot']['height']}, the joiner at height {H} in "
        f"{run['snapshot']['joiner_s']:.2f} s; launches {launches}")
    log(f"6l checks ({card}): {len(nodes)} ledgers and KV states equal at "
        f"height {H}, flags as built (hostile {hostile}), the tampered and "
        f"the outsider's alive refused, one failover, no replay, push and "
        f"state transfer, no provider fallback")
    return row


def main() -> int:
    t_start = time.perf_counter()
    phase_s, lap_t = {}, [t_start]

    def lap(name: str) -> None:
        """Seconds since the last lap, under the phase that just ended."""
        now = time.perf_counter()
        phase_s[name] = now - lap_t[0]
        lap_t[0] = now

    # ---- 1. the card ---------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = smi("name,power.limit")
    log(card)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"max SM clock {sm_clock_hz / 1e6:.0f} MHz")

    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.crypto.csp import PublicKey, VerifyRequest
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import _build, ecdsa
    from bdls_tpu_torch.ops.curves import CURVES
    from bdls_tpu_torch.ops.verify_fold import verify_fold

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    names = {"P-256": "verify_kernel<CurveP256>",
             "secp256k1": "verify_kernel<CurveK256>"}
    pnames = {"P-256": "pinned_kernel<CurveP256>",
              "secp256k1": "pinned_kernel<CurveK256>"}
    bnames = {"P-256": "block_lane_kernel<CurveP256>",
              "secp256k1": "block_lane_kernel<CurveK256>"}
    mnames = {"P-256": "mont16_kernel<CurveP256>",
              "secp256k1": "mont16_kernel<CurveK256>"}
    lap("1")

    # ---- the main path's requests (pure-Python ECDSA, seeded) ----------
    sw = SwCSP()
    t0 = time.perf_counter()
    round_digest = sw.hash(b"bdls round 7 height 42")
    votes, vote_ok = [], []
    for v in range(128):
        key = sw.key_gen("secp256k1", rng)
        # two Byzantine validators sign another message
        forged = v % 61 == 7
        r, s = sw.sign(key, sw.hash(b"other round") if forged
                       else round_digest)
        votes.append(VerifyRequest(key.public_key(), round_digest, r, s))
        vote_ok.append(not forged)
    endorsers = [sw.key_gen("P-256", rng) for _ in range(64)]
    block, block_ok = [], []
    for tx in range(1000):
        digest = sw.hash(b"tx-%d" % tx + rng.bytes(16))
        for j in range(2):
            key = endorsers[(2 * tx + j) % len(endorsers)]
            r, s = sw.sign(key, digest)
            tampered = tx % 97 == 5 and j == 1
            d = sw.hash(b"forged") if tampered else digest
            block.append(VerifyRequest(key.public_key(), d, r, s))
            block_ok.append(not tampered)
    log(f"signed 128 votes + 2000 endorsements in "
        f"{time.perf_counter() - t0:.1f} s (pure-Python ECDSA)")
    t0 = time.perf_counter()
    pinned_in = make_pinned_inputs(sw, rng)
    log(f"signed 128 consensus envelopes + 2000 endorsements by 16 "
        f"endorsers in {time.perf_counter() - t0:.1f} s")
    lap("requests")

    # ---- 2. build: the first process of phase 6g --------------------------
    # a fresh store: the process builds all 11 libraries with nvcc, one
    # compiler a build side by side, into build/ and the store, then pins
    # the round's keys, runs the vote round and writes the key snapshot;
    # meanwhile this process works out the integer ECDSA's verdicts for
    # phase 6g. The libraries it built are the ones loaded here.
    shutil.rmtree(PLANE_DIR, ignore_errors=True)
    os.makedirs(PLANE_DIR)
    with open(os.path.join(PLANE_DIR, "inputs.json"), "w") as f:
        json.dump(_plane_inputs(pinned_in, block), f)
    store = os.path.join(PLANE_DIR, "store")
    first = start_child("build", PLANE_DIR, store)
    plane_truth_ = plane_truth(pinned_in, block)
    built = finish_child(first, "build", PLANE_DIR, 900)
    info = built["build"]
    log(f"build: nvcc {info['seconds']:.1f} s (one compiler a source, side "
        f"by side, in phase 6g's first process) -> "
        f"{sorted(info['paths'].values())}; each: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in sorted(info["nvcc_seconds"].items())))
    check_build_child(built, plane_truth_, card)
    # the requests above live to the end of the run: keep them out of the
    # collector's full passes, each of which stalls this process some
    # 100 ms (phase 6d times 85 submits in milliseconds)
    gc.collect()
    gc.freeze()
    regs = ptxas_lines(info["ptxas"])
    for kern, lines in sorted(regs.items()):
        log(f"ptxas {kern}: " + " | ".join(lines))
    per = ecdsa.lanes_per_block("vpu")
    log(f"K1/K2/K7 geometry (vpu builds): {_build.VERIFY_GROUP} threads a "
        f"lane, {per} lanes a block of {ecdsa.GROUP_THREADS} threads; "
        + ", ".join(f"{-(-b // per)} blocks at {b} lanes" for b in BUCKETS))
    for kern in ("pinned_kernel", "pinned_kernel_count"):
        for curve in ("CurveP256", "CurveK256"):
            log(f"ptxas {kern}<{curve}> (K2's group body, "
                f"csrc/pinned_group.cuh): "
                + " | ".join(regs.get(f"{kern}<{curve}>", ["not found"])))
    # the mxu builds: the same group bodies, each round's products in K5's
    # warp call, inlined (its static buffers in the [mxu] kernels' smem
    # figures above)
    mper = ecdsa.lanes_per_block("mxu")
    log(f"mxu builds geometry: {_build.LANE_THREADS['mxu']} threads a "
        f"lane, {mper} lanes a block of {ecdsa.block_threads('mxu')} "
        f"threads; " + ", ".join(f"{-(-b // mper)} blocks at {b} lanes"
                                 for b in BUCKETS))
    bls_funcs = ptxas_functions(info["ptxas"].get("bls.cu", ""))
    for name, line in sorted(bls_funcs.items()):
        log(f"ptxas bls.cu {name}: {line}")
    lib = _build.lib()
    k8_lines = regs.get("ed25519_kernel", ["not found"])
    k8_build = {
        "ptxas": k8_lines,
        "spills": any(re.search(r"[1-9]\d* bytes spill", ln)
                      for ln in k8_lines),
        "lane_threads": lib.bdls_ed25519_lane_threads(),
        "shared_bytes_per_lane": lib.bdls_ed25519_lane_smem(),
        "shared_bytes_per_block": lib.bdls_ed25519_lane_smem()
        * ecdsa.GROUP_THREADS // lib.bdls_ed25519_lane_threads()}
    log(f"ptxas ed25519_kernel (K8's group body, csrc/edwards_group.cuh): "
        + " | ".join(k8_lines) + f" | {k8_build['lane_threads']} threads a "
        f"lane, {k8_build['shared_bytes_per_lane']} bytes of shared memory "
        f"a lane, {k8_build['shared_bytes_per_block']} a block of "
        f"{ecdsa.GROUP_THREADS} threads; spills: "
        f"{'yes' if k8_build['spills'] else 'none'}")
    k4_build = {"lane_threads": lib.bdls_mont16_lane_threads(),
                "shared_bytes_per_lane": lib.bdls_mont16_lane_smem(),
                "shared_bytes_per_block": lib.bdls_mont16_lane_smem()
                * ecdsa.GROUP_THREADS // lib.bdls_mont16_lane_threads()}
    for kern in ("mont16_kernel", "mont16_kernel_count"):
        for curve in ("CurveP256", "CurveK256"):
            lines = regs.get(f"{kern}<{curve}>", ["not found"])
            spills = any(re.search(r"[1-9]\d* bytes spill", ln)
                         for ln in lines)
            k4_build[f"{kern}<{curve}>"] = {"ptxas": lines, "spills": spills}
            log(f"ptxas {kern}<{curve}> (K4's group body, "
                f"csrc/mont16_group.cuh): " + " | ".join(lines)
                + f" | spills: {'yes' if spills else 'none'}")
    log(f"K4 geometry: {k4_build['lane_threads']} threads a lane, "
        f"{k4_build['shared_bytes_per_lane']} bytes of shared memory a "
        f"lane, {k4_build['shared_bytes_per_block']} a block of "
        f"{ecdsa.GROUP_THREADS} threads")

    from bdls_tpu_torch.ops import sha256
    log(f"K6 geometry: a CTA of {sha256.THREADS} threads (a schedule warp "
        f"and a rounds warp) for 32 lanes, a 16,384-byte ring; "
        + ", ".join(f"{-(-b // 32)} CTAs at {b} lanes"
                    for b in (128, 2048, 2049, 8192)))

    def limbs(lanes):
        return [torch.from_numpy(ints_to_limbs(c).view(np.int32)).to(dev)
                for c in vectors.columns(lanes)]
    lap("2")

    # ---- 3. kernel vs plain vs the integer ECDSA, at the main buckets ---
    # each curve's batch: valid, tampered and hostile lanes, filled up to
    # the main path's bucket with the main path's own requests
    fill = {"secp256k1": (votes, vote_ok), "P-256": (block, block_ok)}
    batch, truth, results = {}, {}, {}
    for curve_name, cv in CURVES.items():
        mixed = vectors.mixed_lanes(curve_name, rng)
        mixed += vectors.ladder_lanes(curve_name, rng)
        reqs, oks = fill[curve_name]
        k = MAIN_BUCKET[curve_name] - len(mixed)
        idx = [i % len(reqs) for i in range(k)]
        lanes = mixed + [(q.key.x, q.key.y, q.r, q.s, q.digest, "main path")
                         for q in (reqs[i] for i in idx)]
        want = np.array(vectors.expected(curve_name, mixed)
                        + [oks[i] for i in idx])
        args = limbs(lanes)
        kern = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = verify_fold(cv, *args).cpu().numpy()
        plain_ms = (time.perf_counter() - t0) * 1e3
        diff = np.abs(kern.astype(np.int64) - plain.astype(np.int64))
        bad = [lanes[i][5] for i in np.flatnonzero(diff)]
        log(f"{curve_name}: kernel vs plain on {len(lanes)} lanes "
            f"({len(mixed)} mixed): {int(diff.sum())} differ {bad}; "
            f"valid {int(kern.sum())}; plain {plain_ms:.0f} ms")
        if diff.any():
            raise SystemExit(f"{curve_name}: kernel disagrees with plain")
        if not np.array_equal(kern, want):
            raise SystemExit(f"{curve_name}: kernel disagrees with SwCSP")
        batch[curve_name], truth[curve_name] = lanes, want
        results[curve_name] = {"max_abs_err": int(diff.max()),
                               "lanes_checked": len(lanes),
                               "plain_ms": plain_ms}
    lap("3")

    # ---- 4. K2 vs plain vs the integer ECDSA, at the main buckets ------
    pinned = check_pinned_kernel(pinned_in, rng, dev)
    lap("4")

    # ---- 4b. K6 and K7 vs plain, hashlib and the host oracle -----------
    t0 = time.perf_counter()
    blk = make_block_inputs(rng)
    log(f"signed the block lane's {sum(len(r.lanes) for r in blk.values())} "
        f"endorsements in {time.perf_counter() - t0:.1f} s")
    sha_checked = check_sha256_kernel(blk, rng, dev)
    checked = check_block_kernels(blk, dev)
    lap("4b")

    # ---- 3c. K8 vs plain vs the RFC 8032 oracle, at 128 and 2048 -------
    t0 = time.perf_counter()
    ed_in = make_ed25519_inputs(rng)
    log(f"signed 85 + 683 Ed25519 votes in {time.perf_counter() - t0:.1f} s")
    ed_checked = check_ed25519_kernel(ed_in, rng, dev)
    lap("3c")

    # ---- 3d. K9 vs plain vs the oracle, stage for stage, on 10 lanes ---
    t0 = time.perf_counter()
    cert_in = make_cert_inputs()
    log(f"made the committees of 128 and 1024 BLS keys and 68 quorum "
        f"certificates in {time.perf_counter() - t0:.1f} s")
    bls_checked = check_bls_kernel(cert_in, dev)
    lap("3d")

    # ---- 3e. K4 vs plain vs the integer ECDSA, at the main buckets -----
    k4_checked = check_mont16_kernel(batch, truth, rng, dev)
    lap("3e")

    # ---- 3f. K5's product vs CIOS; each mxu build vs its vpu kernel ----
    mxu_checked = check_mxu(batch, truth, pinned, checked, ed_checked, rng,
                            dev)
    lap("3f")

    # ---- 3g. K10: the masked count and the split vs unsplit -------------
    mesh_checked = check_mesh(batch, truth, pinned, rng, dev)
    lap("3g")

    # ---- 3h. K11 vs plain vs the oracle's full exponent, 10 lanes -------
    k11_checked = check_final_full(bls_checked, dev)
    lap("3h")

    # ---- 5. the K1 main path ----------------------------------------------
    # a flush window far longer than the 128 submits take: the round
    # goes out as one launch, at the explicit flush(); the latency tier
    # off, so the vote round is K1's eager launch (phase 6d drives K3)
    csp = TorchCSP(device="cuda", key_cache_size=0, use_cpu_fallback=False,
                   flush_interval=1.0, latency_max_lanes=0)
    csp.warmup([(c, b) for c in CURVES for b in BUCKETS])
    ecdsa.reset_launches()
    t0 = time.perf_counter()
    futs = [csp.submit(v) for v in votes]
    csp.flush()
    got_votes = [f.result(60) for f in futs]
    vote_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = csp.verify_batch(block)
    block_s = time.perf_counter() - t0
    launches = dict(ecdsa.LAUNCHES)
    stats = csp.stats
    log(f"main path: vote round 128 lanes {vote_s * 1e3:.2f} ms, "
        f"block batch 2000 lanes {block_s * 1e3:.2f} ms, "
        f"launches {launches}, stats {stats}")
    if got_votes != vote_ok:
        raise SystemExit("vote round: verdicts differ from construction")
    if got != block_ok:
        raise SystemExit("block batch: verdicts differ from construction")
    if stats["fallbacks"] != 0 or stats["batches"] <= 0:
        raise SystemExit(f"main path: bad stats {stats}")
    if launches != {"P-256": 1, "secp256k1": 1}:
        raise SystemExit(f"main path: launches {launches}, want 1 each")
    if any(ecdsa.LAUNCHES_PINNED.values()):
        raise SystemExit("K1 main path: the pinned kernel ran without a "
                         "key cache")
    lap("5")

    # ---- 6. the K2 main path ---------------------------------------------
    pinned_main, live = drive_pinned_main_path(pinned_in)
    lap("6")

    # ---- 6b. the block lane (K7), and K6's own path ------------------------
    block_main, block_csp = drive_block_main_path(blk)
    lap("6b")

    # ---- 6c. the Ed25519 vote path (K8) -----------------------------------
    ed_main, ed_csp = drive_ed25519_main_path(ed_in)
    lap("6c")

    # ---- 6d. the latency tier (K3) and the ring repro --------------------
    lat_main, lat_csp = drive_latency_main_path(votes, vote_ok)
    lap("6d")

    # ---- 6e. the certificate lane (K9) -------------------------------------
    cert_main = drive_cert_main_path(cert_in)
    lap("6e")

    # ---- 5b. the main path under kernel_field="mont16" (K4) --------------
    main_mont16 = drive_field_main_path("mont16", votes, vote_ok, block,
                                        block_ok, pinned_in, blk, ed_in)
    lap("5b")

    # ---- 5c. the main path under kernel_field="mxu" (K5's builds) --------
    main_mxu = drive_field_main_path("mxu", votes, vote_ok, block, block_ok,
                                     pinned_in, blk, ed_in)
    lap("5c")

    # ---- 5d. the mesh main path (K10) ---------------------------------------
    main_mesh = drive_mesh_main_path(block, block_ok, pinned_in, dev)
    lap("5d")

    # ---- 6f. the "kernel" certificate path (K9's Miller + K11) ----------
    cert_full = drive_cert_kernel_path(cert_in)
    lap("6f")

    # ---- 6g. the provider plane: cold start, accumulator, stall, profile --
    restored = finish_child(start_child("restore", PLANE_DIR, store,
                                        nvcc=False),
                            "restore", PLANE_DIR, 300)
    check_restore_child(restored, plane_truth_, card)
    # poison the two libraries nvcc made fastest, in two copies of the
    # store: one for a process with nvcc, one for a process without
    quick = sorted(info["nvcc_seconds"], key=info["nvcc_seconds"].get)[:2]
    stores = {}
    for role in ("rebuild", "nonvcc"):
        stores[role] = os.path.join(PLANE_DIR, f"store-{role}")
        shutil.copytree(store, stores[role])
        poison(stores[role], quick)
    rebuild = start_child("rebuild", PLANE_DIR, stores["rebuild"])
    nonvcc = start_child("nonvcc", PLANE_DIR, stores["nonvcc"], nvcc=False)
    prof = profile_capture(block, block_ok, blk, block_csp, PLANE_DIR)
    acc_stall = accumulator_and_stall(votes, vote_ok)
    rebuilt = finish_child(rebuild, "rebuild", PLANE_DIR, 600)
    zero = {"P-256": 0, "secp256k1": 0}
    _check_round(rebuilt, "vote_round", plane_truth_, zero,
                 {"P-256": 0, "secp256k1": 1}, 127)
    if (rebuilt["rejects"] != {"truncated": 1.0, "corrupt": 1.0}
            or rebuilt["persistent"] != 9
            or rebuilt["nvcc_builds"] != sorted(quick)
            or rebuilt["restored"] != 144):
        raise SystemExit(f"6g poisoned store, nvcc: rejects "
                         f"{rebuilt['rejects']}, {rebuilt['persistent']} "
                         f"loaded, rebuilt {rebuilt['nvcc_builds']} (poisoned "
                         f"{quick}), {rebuilt['restored']} keys restored")
    raised = finish_child(nonvcc, "nonvcc", PLANE_DIR, 300, want_rc=1)
    if ("nvcc not found" not in raised["stderr"]
            or any(k not in raised["stderr"] for k in quick)):
        raise SystemExit(f"6g poisoned store, no nvcc: not the raise "
                         f"wanted:\n{raised['stderr'][-2000:]}")
    log(f"6g poisoned store ({quick[0]} truncated, {quick[1]} one byte "
        f"flipped): with nvcc, rejects {rebuilt['rejects']}, those two "
        f"rebuilt ({', '.join(f'{k} {v:.1f} s' for k, v in sorted(rebuilt['build']['nvcc_seconds'].items()))}), "
        f"9 loaded, the same verdicts, time to first verdict "
        f"{rebuilt['ttfv_s']:.2f} s; without nvcc, exit {raised['rc']}: "
        + raised["stderr"].strip().splitlines()[-1][:300])
    plane = {"build": {k: built[k] for k in ("ttfv_s", "lib_s", "proc_s",
                                             "snapshot_keys")},
             "restore": {k: restored[k] for k in ("ttfv_s", "lib_s", "proc_s",
                                                   "persistent", "restored")},
             "rebuild": {k: rebuilt[k] for k in ("ttfv_s", "lib_s", "proc_s",
                                                  "persistent", "rejects",
                                                  "nvcc_builds")},
             "nvcc_seconds": info["nvcc_seconds"],
             "rebuild_nvcc_seconds": rebuilt["build"]["nvcc_seconds"],
             "nonvcc_rc": raised["rc"], "profile": prof, **acc_stall}
    log(f"6g time to first verdict: {plane['build']['ttfv_s']:.2f} s from "
        f"nvcc, {plane['restore']['ttfv_s']:.2f} s from the store ({card})")
    lap("6g")

    # ---- 6h. the sidecar: verifyd and its clients on the card ------------
    sidecar = drive_sidecar(votes, vote_ok, block, block_ok, pinned_in, blk,
                            block_main["main"]["flags"], cert_in, store, card)
    lap("6h")

    # ---- 6i. the consensus engine deciding heights through the card ------
    consensus = drive_consensus(card)
    lap("6i")

    # ---- 6j. the transaction flow: endorse, order, commit ----------------
    txflow = drive_txflow(card)
    lap("6j")

    # ---- 6k. config 2 through four orderer nodes over the cluster --------
    orderer = drive_orderer(card)
    lap("6k")

    # ---- 6l. config 3's blocks through a gossiping peer network --------
    peer_plane = drive_peer_plane(card)
    lap("6l")

    # ---- 7. timing -------------------------------------------------------
    def vote_round():
        t = time.perf_counter()
        fs = [csp.submit(v) for v in votes]
        csp.flush()
        if [f.result(60) for f in fs] != vote_ok:
            raise SystemExit("vote round: verdicts differ")
        return (time.perf_counter() - t) * 1e3

    def block_batch():
        t = time.perf_counter()
        if csp.verify_batch(block) != block_ok:
            raise SystemExit("block batch: verdicts differ")
        return (time.perf_counter() - t) * 1e3

    ecdsa.reset_launches()
    vote_ms = sorted(vote_round() for _ in range(9))
    timed_launches = dict(ecdsa.LAUNCHES)
    block_ms = sorted(block_batch() for _ in range(5))
    log(f"vote round 128 lanes: median {vote_ms[4]:.2f} ms "
        f"(min {vote_ms[0]:.2f}, max {vote_ms[-1]:.2f}), "
        f"{timed_launches['secp256k1']} launches in 9 rounds; block batch "
        f"2000 lanes: median {block_ms[2]:.2f} ms (min {block_ms[0]:.2f}, "
        f"max {block_ms[-1]:.2f})")
    if timed_launches["secp256k1"] != 9:
        raise SystemExit(f"vote rounds: launches {timed_launches}, want 9")
    for curve_name, cv in CURVES.items():
        res = results[curve_name]
        lanes, want = batch[curve_name], truth[curve_name]
        res["buckets"] = {}
        for b in BUCKETS:
            idx = [i % len(lanes) for i in range(b)]
            tiled = [lanes[i] for i in idx]
            args = limbs(tiled)
            ok = ecdsa.verify_fold_cuda(cv, *args).cpu().numpy()
            if not np.array_equal(ok, want[idx]):
                raise SystemExit(f"{curve_name} B={b}: verdicts differ")
            reps = 20 if b <= 2048 else 10
            ms = cuda_ms(lambda: ecdsa.verify_fold_cuda(cv, *args), reps)
            bms, by = bound_ms(cv, tiled, sm_clock_hz)
            res["buckets"][b] = {"ms": ms, "verifies_per_s": b / ms * 1e3,
                                 "bound_ms": bms, "bound_by": by,
                                 "bound_share": bms / ms}
            log(f"{curve_name} B={b}: kernel {ms:.3f} ms "
                f"({b / ms * 1e3:,.0f} verifies/s), bound {bms:.4f} ms "
                f"({by}, {bms / ms:.2%} of the kernel time)")
        args8 = limbs(lanes[:8])
        t0 = time.perf_counter()
        verify_fold(cv, *args8)
        torch.cuda.synchronize()
        res["plain_ms_bucket8"] = (time.perf_counter() - t0) * 1e3
        # the provider adds the low-S policy for P-256
        half = cv.fn.modulus // 2
        reqs, pwant = [], []
        for i in range(8192):
            qx, qy, r, s, d, _ = lanes[i % len(lanes)]
            reqs.append(VerifyRequest(PublicKey(curve_name, qx, qy), d, r, s))
            pwant.append(bool(want[i % len(lanes)])
                         and (curve_name != "P-256" or s <= half))
        csp.verify_batch(reqs)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            if csp.verify_batch(reqs) != pwant:
                raise SystemExit(f"{curve_name}: provider verdicts differ")
        e2e = (time.perf_counter() - t0) / reps
        res["provider_8192_s"] = e2e
        res["provider_verifies_per_s"] = 8192 / e2e
        # the kernel's share of the end-to-end time at 8192 lanes; the
        # rest is host work (screen, marshal, copies, futures)
        res["kernel_share_8192"] = res["buckets"][8192]["ms"] / (e2e * 1e3)
        log(f"{curve_name}: plain {res['plain_ms']:.0f} ms at "
            f"B={MAIN_BUCKET[curve_name]}, {res['plain_ms_bucket8']:.0f} ms "
            f"at B=8; provider 8192 lanes {e2e * 1e3:.1f} ms "
            f"({8192 / e2e:,.0f} verifies/s end to end, kernel share "
            f"{res['kernel_share_8192']:.2f})")
    csp.close()
    if csp.stats["fallbacks"] != 0:
        raise SystemExit("a fallback happened during timing")
    time_pinned(pinned, pinned_main, live, pinned_in, sm_clock_hz, dev)
    sha_times = time_sha256(sha_checked, blk, sm_clock_hz, dev)
    block_times = time_block(checked, blk, block_csp, sm_clock_hz, dev)
    lat_times = time_latency(batch["secp256k1"], truth["secp256k1"],
                             lat_csp, votes, vote_ok[:85], sm_clock_hz, dev)
    ed_times = time_ed25519(ed_checked, ed_csp, sm_clock_hz, dev)
    bls_times = time_bls(bls_checked, sm_clock_hz, dev)
    from bdls_tpu_torch.crypto.torch_provider import block_lane_screen
    from bdls_tpu_torch.ops import block_verify

    k4k5_times = time_k4k5(
        batch, truth, pinned, checked, ed_checked,
        block_verify.pack_block_request(
            blk["main"], lane_ok=block_lane_screen("P-256")),
        sm_clock_hz, dev)
    mesh_times = time_mesh(batch, truth, pinned, rng, sm_clock_hz, dev)
    k11_times = time_final_full(bls_checked, sm_clock_hz, dev)
    lap("7")

    # ---- 8. report -------------------------------------------------------
    kernels = []
    for curve_name, cv in CURVES.items():
        res = results[curve_name]
        mb = MAIN_BUCKET[curve_name]
        at = res["buckets"][mb]
        lanes = batch[curve_name]
        kernels.append({
            "name": f"{names[curve_name]} ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/verify.cu",
            "replaces": "bdls_tpu/ops/verify_fold.py:860",
            "launches": launches[curve_name],
            "max_abs_err": res["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": None,
            "bucket": mb,
            "needed_muls_per_lane": needed_muls(cv, lanes) / len(lanes),
            "by_bucket": res["buckets"],
            "plain_ms_bucket8": res["plain_ms_bucket8"],
            "provider_verifies_per_s_8192":
                res["provider_verifies_per_s"],
            "kernel_share_8192": res["kernel_share_8192"],
        })
    for curve_name, cv in CURVES.items():
        res = pinned[curve_name]
        at = res["buckets"][MAIN_BUCKET[curve_name]]
        kernels.append({
            "name": f"{pnames[curve_name]}, a thread group a lane "
                    f"(csrc/pinned_group.cuh) ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/pinned.cu",
            "replaces": "bdls_tpu/ops/verify_fold.py:736",
            "launches": pinned_main["launches"][curve_name],
            "max_abs_err": res["max_abs_err"],
            "ms": at["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            "library_ms": None,
            "bucket": MAIN_BUCKET[curve_name],
            "keys_pinned": res["keys"],
            "needed_muls_per_lane": res["needed_muls_per_lane"],
            "by_bucket": res["buckets"],
            "plain_ms_bucket8": res["plain_ms_bucket8"],
        })
    sha = sha_times["main"]
    kernels.append({
        "name": "sha256_kernel",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/sha256.cu",
        "replaces": "bdls_tpu/ops/sha256.py:170",
        "launches": block_main["sha256_batch"]["launches"],
        "committer_launches": block_main["main"]["k6_launches"],
        "max_abs_err": max(v["max_abs_err"] for k, v in sha_checked.items()
                           if k != "uniform_arrays"),
        "ms": sha["ms"],
        "host_ms": sha["host_ms"],
        "plain_ms": sha["plain_ms"],
        "bound_ms": sha["bound_ms"],
        "bound_by": sha["bound_by"],
        "library_ms": None,
        "lanes": sha["lanes"],
        "active_blocks": sha["active_blocks"],
        "ns_per_round": sha["ns_per_round"],
        "by_shape": sha_times,
        "path": "sha256_batch over the main block's preimages (one "
                "launch); the committer's verify_block launches K6 0 "
                "times, K7 hashing with its own one-thread body "
                "(csrc/block.cuh, sha::lane_digest). A CTA of a schedule "
                "warp and a rounds warp for every 32 lanes "
                "(csrc/sha256.cuh: schedule_block, rounds_block); ms a "
                "launch in a CUDA graph, host_ms from the host",
    })
    for curve_name in ("P-256", "secp256k1"):
        tm, ck = block_times[curve_name], checked[curve_name]
        kernels.append({
            "name": f"{bnames[curve_name]} + block_tally_kernel "
                    f"({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/block.cu",
            "replaces": "bdls_tpu/ops/block_verify.py:85",
            "launches": block_main["main" if curve_name == "P-256"
                                   else "secp256k1"]["launches"],
            "max_abs_err": ck["max_abs_err"],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"],
            "library_ms": None,
            "shape": ck["shape"],
            "path": ("TorchCSP.verify_block, the 1000-tx block"
                     if curve_name == "P-256" else
                     "TorchCSP.verify_block, a 50-tx secp256k1 block"),
        })
    lt = lat_times[128]
    kernels.append({
        "name": "K3: captured graph of copy, verify_kernel<CurveK256>, "
                "copy (secp256k1)",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/verify.cu",
        "graph": "bdls_tpu_torch/ops/ecdsa.py:LatencySlot",
        "replaces": "bdls_tpu/ops/ecdsa.py:244",
        "launches": lat_main[128]["launches"],
        "max_abs_err": lt["max_abs_err"],
        "ms": lt["replay_ms"],
        "plain_ms": results["secp256k1"]["plain_ms"],
        "bound_ms": lt["bound_ms"],
        "bound_by": lt["bound_by"],
        "library_ms": None,
        "bucket": 128,
        "by_bucket": {b: lat_times[b] for b in (85, 128, 171)},
        "quorum_on_ms_median": lat_times["quorum_on_ms"][4],
        "quorum_off_ms_median": lat_times["quorum_off_ms"][4],
        "path": "TorchCSP submit x 85 at quorum occupancy, 128-validator "
                "secp256k1 committee, key cache off (bucket 128; bucket 85 "
                "with VOTE_BUCKETS)",
    })
    et = ed_times[2048]
    kernels.append({
        "name": "ed25519_kernel",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/ed25519.cu",
        "body": "bdls_tpu_torch/csrc/edwards_group.cuh",
        "replaces": "bdls_tpu/ops/ed25519.py:494",
        "launches": ed_main[1024]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in ed_checked.values()),
        "ms": et["ms"],
        "plain_ms": ed_checked[2048]["plain_ms"],
        "bound_ms": et["bound_ms"],
        "bound_by": et["bound_by"],
        "library_ms": None,
        "bucket": 2048,
        "by_bucket": ed_times,
        "plain_ms_bucket128": ed_checked[128]["plain_ms"],
        "path": "TorchCSP submit + flush, the 683-vote quorum of a "
                "1024-validator committee (bucket 2048; the 85-vote quorum "
                "of 128 validators in bucket 128)",
    })
    for kern, replaces, plain in (
            ("miller", "bdls_tpu/ops/bls_kernel.py:498", "plain_miller_ms"),
            ("final", "bdls_tpu/ops/bls_kernel.py:519", "plain_final_ms")):
        at = bls_times[2]
        errs = bls_checked["max_abs_err"]
        dense = {k: v["miller_ms"] for k, v in bls_times.items()
                 if isinstance(k, str)} if kern == "miller" else None
        kernels.append({
            "name": f"bls_{kern}_kernel",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/bls.cu",
            "replaces": replaces,
            "launches": cert_main[1024]["launches"][kern],
            "max_abs_err": max(errs["n"], errs["d"]) if kern == "miller"
            else max(errs["fe"], bls_checked["max_abs_err_verdict"]),
            "ms": at[f"{kern}_ms"],
            "plain_ms": bls_checked[plain],
            "bound_ms": at[f"{kern}_bound_ms"],
            "bound_by": at[f"{kern}_bound_by"],
            "library_ms": None,
            "lanes": 2,
            "plain_lanes": bls_checked["lanes"],
            "by_lanes": {b: {k: v for k, v in r.items()
                             if k.startswith(kern) or k == "ms"}
                         for b, r in bls_times.items() if isinstance(b, int)},
            "all_dense_miller_ms": dense,
            "also_replaces": None if kern == "miller" else
            "bdls_tpu/ops/bls_kernel.py:552 (the compare)",
            "path": "TorchCSP.verify_certificates, 2 certificates a call, "
                    "committees of 128 and 1024 validators; a cross-round "
                    "batch of 64",
        })
    def main_launches(run, what, kern, curve):
        return run[what]["launches"].get(kern, {}).get(curve, 0)

    for curve_name, what in (("secp256k1", "vote round, 128 secp256k1 lanes"),
                             ("P-256", "block batch, 2000 P-256 lanes")):
        t = k4k5_times[f"K4 {curve_name}"][MAIN_BUCKET[curve_name]]
        kernels.append({
            "name": f"{mnames[curve_name]} ({curve_name})",
            "route": "cuda",
            "source": "bdls_tpu_torch/csrc/mont16.cu",
            "replaces": "bdls_tpu/ops/ecdsa.py:58",
            "launches": main_launches(main_mont16, what, "K4", curve_name),
            "max_abs_err": k4_checked[curve_name]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": k4_checked[curve_name]["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "bucket": MAIN_BUCKET[curve_name],
            "by_bucket": k4k5_times[f"K4 {curve_name}"],
            "path": f"TorchCSP(kernel_field=\"mont16\"): the {what}",
        })
    mxu_paths = (
        ("verify_kernel<CurveP256> [mxu] (P-256)", "verify.cu", "K1+K5",
         "P-256", "block batch, 2000 P-256 lanes", "K1 P-256",
         "K1+K5 P-256", 2048),
        ("K3: captured graph of copy, verify_kernel<CurveK256> [mxu], copy "
         "(secp256k1)", "verify.cu", "K3+K5", "secp256k1",
         "vote round, 128 secp256k1 lanes", "K1 secp256k1",
         "K3+K5 secp256k1", 128),
        ("pinned_kernel<CurveK256> [mxu] (secp256k1)", "pinned.cu", "K2+K5",
         "secp256k1", "vote round through the seam, 128 envelopes, one new "
         "key", "K2 secp256k1", "K2+K5 secp256k1", 128),
        ("pinned_kernel<CurveP256> [mxu] (P-256)", "pinned.cu", "K2+K5",
         "P-256", "pinned block batch, 2000 lanes from 16 endorsers",
         "K2 P-256", "K2+K5 P-256", 2048),
        ("block_lane_kernel<CurveP256> [mxu] + block_tally_kernel (P-256)",
         "block.cu", "K7+K5", "P-256", "verify_block, the 1000-tx block",
         "K7 P-256", "K7+K5 P-256", None),
        ("ed25519_kernel [mxu]", "ed25519.cu", "K8+K5", "ed25519",
         "Ed25519 round, 85 votes of 128", "K8 2048", "K8+K5", 2048),
    )
    k5_launches = 0
    for name, src, kern, curve_name, what, ck, tk, bucket in mxu_paths:
        t = k4k5_times[tk] if bucket is None else k4k5_times[tk][bucket]
        n = main_launches(main_mxu, what, kern, curve_name)
        k5_launches += n
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"bdls_tpu_torch/csrc/{src} with csrc/mxu.cuh "
                      f"(-DBDLS_MUL_MXU)",
            "replaces": "bdls_tpu/ops/mxu.py:98 (bound by "
                        "bdls_tpu/ops/fold.py:375-400)",
            "launches": n,
            "max_abs_err": mxu_checked[ck]["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": mxu_checked[ck]["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "bucket": bucket,
            "by_bucket": None if bucket is None else k4k5_times[tk],
            "path": f"TorchCSP(kernel_field=\"mxu\"): the {what}",
        })
    k5 = k4k5_times["K5 product"]
    kernels.append({
        "name": "mxu::warp_columns under mxu::mont_mul_warp and "
                "grp::mul_25519_warp (K5: a warp's 32 products, mma.sync "
                "m16n8k32 u8, in every mxu build)",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/mxu.cuh",
        "replaces": "bdls_tpu/ops/mxu.py:98",
        "launches": k5_launches,
        "max_abs_err": max(v["max_abs_err"]
                           for v in mxu_checked["product"].values()),
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
        "products": k5["products"],
        "cios_ms": k5["cios_ms"],
        "call_ns": k5["call_ns"],
        "path": "timed alone through bdls_field_mul (65,536 products mod "
                "the P-256 order) and bdls_field_chain (call_ns: one warp, "
                "4,096 dependent calls, beside the vpu bodies' product); "
                "launches: the mxu builds' launches on the "
                "kernel_field=\"mxu\" main path",
    })
    st = mesh_times["split"][2048]
    mesh_runs = {"K1": main_mesh["pjit: 2 shards, 2000 P-256 lanes"],
                 "K2": main_mesh["pjit: 2 shards, 2000 pinned lanes from "
                                 "16 endorsers"]}
    for prog, kern, src, replaces in (
            ("K1", "verify_kernel_count<CurveP256>", "verify.cu",
             "bdls_tpu/parallel/mesh.py:97"),
            ("K2", "pinned_kernel_count<CurveP256>", "pinned.cu",
             "bdls_tpu/parallel/mesh.py:134")):
        ct = mesh_times["count"][f"{prog} 1024"]
        kernels.append({
            "name": f"{kern} (K10's shard: {prog} + the count epilogue)",
            "route": "cuda",
            "source": f"bdls_tpu_torch/csrc/{src}, "
                      "bdls_tpu_torch/csrc/mesh.cuh",
            "replaces": replaces,
            "launches": mesh_runs[prog]["launches"]["K10"]["shards"],
            "max_abs_err": mesh_checked["count_max_abs_err"],
            "ms": ct["ms"],
            "plain_ms": ct["plain_ms"],
            "bound_ms": ct["bound_ms"],
            "bound_by": ct["bound_by"],
            "library_ms": None,
            "lanes": 1024,
            "without_count_ms": ct["without_count_ms"],
            "launch_and_sum_ms": ct["launch_and_sum_ms"],
            "count_library_call": "(ok & mask).sum()",
            "count_library_ms": ct["sum_ms"],
            "count_bound_ms": ct["count_bound_ms"],
            "by_lanes": {k: v for k, v in mesh_times["count"].items()
                         if k.startswith(prog)},
            "path": "TorchCSP(mesh_threshold=2048) over a two-shard mesh of "
                    "the card stood in for the device list: the 2000-lane "
                    "P-256 batch (K1) and the pinned 2000-lane block (K2), "
                    "one launch a shard of 1024 lanes",
        })
    kernels.append({
        "name": "K10: sharded_verify_masked over 2 shards of one card "
                "(verify_kernel_count<CurveP256> a shard)",
        "route": "cuda",
        "source": "bdls_tpu_torch/parallel/mesh.py, "
                  "bdls_tpu_torch/csrc/verify.cu",
        "replaces": "bdls_tpu/parallel/mesh.py:77",
        "also_replaces": "bdls_tpu/parallel/mesh.py:50, :113, :209, :247",
        "launches": mesh_runs["K1"]["launches"]["K10"]["shards"],
        "max_abs_err": mesh_checked["max_abs_err"],
        "ms": st["ms"],
        "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "library_ms": None,
        "lanes": 2048,
        "unsplit_ms": st["unsplit_ms"],
        "by_lanes": mesh_times["split"],
        "path": "TorchCSP(mesh_threshold=2048), shard modes pjit and "
                "shard_map, the 2000-lane P-256 batch (K1 a shard) and the "
                "pinned 2000-lane block (K2 a shard)",
    })
    kt = k11_times[2]
    kernels.append({
        "name": "bls_final_full_kernel (K11: the exact x-chain, a warp "
                "a side)",
        "route": "cuda",
        "source": "bdls_tpu_torch/csrc/bls.cu",
        "replaces": "bdls_tpu/ops/bls_kernel.py:456",
        "also_replaces": "bdls_tpu/ops/bls_kernel.py:508 "
                         "(_jitted_fe_product), composed by :609 "
                         "(verify_pipeline)",
        "launches": cert_full[1024]["launches"]["final_full"],
        "max_abs_err": k11_checked["max_abs_err"],
        "ms": kt["ms"],
        "plain_ms": k11_checked["plain_ms"],
        "bound_ms": kt["bound_ms"],
        "bound_by": kt["bound_by"],
        "library_ms": None,
        "lanes": 2,
        "plain_lanes": k11_checked["lanes"],
        "by_lanes": k11_times,
        "path": "TorchCSP.verify_certificates(backend=\"kernel\"), 2 "
                "certificates a call, committees of 128 and 1024 "
                "validators; a cross-round batch of 64",
    })
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise SystemExit(f"kernels the main path never launched: {idle}")
    report = {"card": card, "sm_clock_hz": sm_clock_hz,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": info["seconds"], "ptxas": regs,
              "bls_ptxas_functions": bls_funcs,
              "vote_round_ms": vote_s * 1e3,
              "block_batch_ms": block_s * 1e3,
              "vote_round_ms_runs": vote_ms, "block_batch_ms_runs": block_ms,
              "pinned_main_path": pinned_main,
              "block_main_path": block_main,
              "block_timing": block_times,
              "sha256_check": {k: v for k, v in sha_checked.items()
                               if k != "uniform_arrays"},
              "ed25519_main_path": ed_main,
              "ed25519_build": k8_build, "mont16_build": k4_build,
              "latency_main_path": lat_main,
              "latency_timing": {str(k): v for k, v in lat_times.items()},
              "cert_main_path": {str(k): v for k, v in cert_main.items()},
              "bls_timing": bls_times,
              "bls_check": {k: v for k, v in bls_checked.items()
                            if k != "args"},
              "k4_check": k4_checked, "mxu_check": mxu_checked,
              "mont16_main_path": main_mont16, "mxu_main_path": main_mxu,
              "k4k5_timing": k4k5_times,
              "mesh_check": mesh_checked, "mesh_main_path": main_mesh,
              "mesh_timing": mesh_times, "k11_check": k11_checked,
              "cert_kernel_path": {str(k): v for k, v in cert_full.items()},
              "k11_timing": k11_times,
              "static_counts": static_counts(),
              "provider_plane": plane,
              "sidecar": sidecar,
              "consensus": {str(k): v for k, v in consensus.items()},
              "txflow": txflow,
              "orderer": orderer,
              "peer_plane": peer_plane,
              "kernels": kernels}
    lap("8")
    report["phase_seconds"] = phase_s
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"chip_smoke: every phase in {report['seconds']:.1f} s; by phase "
        + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


PHASES_ALONE = {"6k": "drive_orderer", "6l": "drive_peer_plane"}


def main_phase(phase: str) -> int:
    """``python3 chip_smoke.py --phase 6k`` (or ``6l``): phase 1's card
    check, the kernels built (or loaded from ``build/``), then that phase
    alone; its row goes to ``build/chip_smoke_<phase>.json``."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = smi("name,power.limit")
    log(card)
    from bdls_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row = globals()[PHASES_ALONE[phase]](card)
    log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", f"chip_smoke_{phase}.json"), "w") as f:
        json.dump(row, f, indent=1)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--provider-child"]:
        sys.exit(provider_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:3] and \
            sys.argv[2] in PHASES_ALONE and len(sys.argv) == 3:
        sys.exit(main_phase(sys.argv[2]))
    sys.exit(main())

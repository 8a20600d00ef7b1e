"""The BDLS (Sperax) BFT consensus state machine — deterministic, IO-free.

Clean-room re-implementation of the protocol in
``vendor/github.com/BDLS-bft/bdls/consensus.go`` (same stage machine,
quorum rules, timeout schedule, dedup/OOM defenses, and error taxonomy),
re-designed around one structural change: **all signature verification goes
through a pluggable batch verifier** (``verifier.BatchVerifier``) so that a
<lock>/<select>/<decide> message's 2t+1 embedded proofs — the reference's
serial hot loop (consensus.go:549-584, 852-885) — become a single batched
TPU call, while the state machine itself stays pure ``y = f(x, t)``
(doc.go:4-12): no threads, no clocks, no IO; callers feed messages and
time.

The port's copy of ``bdls_tpu/consensus/engine.py``, with the
hand-written codec :mod:`bdls_tpu_torch.consensus.wire_codec` in place of
``wire_pb2`` (envelopes are :class:`~bdls_tpu_torch.consensus.identity.
SignedEnvelope`, messages :class:`~bdls_tpu_torch.consensus.wire_codec.
ConsensusMessage`; ``lock_release`` is ``None`` when absent) and the
same span and instrument names. One difference, on purpose: a
``Config`` without a ``verifier`` verifies on the card, through a
:class:`~bdls_tpu_torch.consensus.verifier.TorchBatchVerifier` on
``cuda``, and the engine raises at construction where there is no card;
the reference falls back to its serial CPU verifier. The host path is
the caller's explicit choice (``verifier=CpuBatchVerifier()``).

Stages (strictly ordered, consensus.go:49-55):
    ROUND_CHANGING -> LOCK -> COMMIT -> LOCK_RELEASE

Quorum: t = (n-1)//3, decisions need 2t+1 (consensus.go:1173).
Leader of round r = participants[r % n] (consensus.go:1148-1154).
Timeouts: 2·latency·2^round (4· for non-leader lock wait), capped at 10 s
(consensus.go:371-413).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from hashlib import blake2b
from typing import Callable, Optional, Protocol

from bdls_tpu_torch.consensus import errors as E
from bdls_tpu_torch.consensus import wire_codec as W
from bdls_tpu_torch.consensus.identity import (PROTOCOL_VERSION,
                                               SignedEnvelope, Signer,
                                               identity_of)
from bdls_tpu_torch.consensus.verifier import (BatchVerifier,
                                               TorchBatchVerifier)
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.device import resolve_device
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

DEFAULT_CONSENSUS_LATENCY = 0.3  # seconds (consensus.go:26)
MAX_CONSENSUS_LATENCY = 10.0  # seconds (consensus.go:29)
CONFIG_MINIMUM_PARTICIPANTS = 4  # config.go:10

MsgType = W.MsgType


class Stage(IntEnum):
    ROUND_CHANGING = 0
    LOCK = 1
    COMMIT = 2
    LOCK_RELEASE = 3


def state_hash(state: Optional[bytes]) -> bytes:
    """blake2b-256 of a state; None hashes like the empty state
    (consensus.go:41)."""
    return blake2b(state or b"", digest_size=32).digest()


class PeerInterface(Protocol):
    """The engine's only outbound dependency (reference peer.go)."""

    def remote_addr(self) -> str: ...
    def identity(self) -> Optional[bytes]: ...
    def send(self, data: bytes) -> None: ...


@dataclass
class Config:
    """Consensus parameters (reference config.go)."""

    epoch: float  # seconds; starting time point
    signer: Signer
    participants: list[bytes]  # 64-byte identities
    current_height: int = 0
    enable_commit_unicast: bool = False
    state_compare: Callable[[bytes, bytes], int] = None  # required
    # state_validate(state, height) -> bool. The height of the carrying
    # message is passed so the application can bind its own notion of
    # sequence (e.g. block number) to the consensus height — without the
    # binding, a byzantine leader can get an honest quorum to commit a
    # state whose embedded number doesn't match the height being decided.
    state_validate: Callable[[bytes, int], bool] = None  # required
    message_validator: Optional[Callable] = None
    message_out_callback: Optional[Callable] = None
    # None: a TorchBatchVerifier on the card (raises without one)
    verifier: Optional[BatchVerifier] = None
    latency: float = DEFAULT_CONSENSUS_LATENCY
    # observability: span tracer + metrics provider; both default to
    # process-local globals so tracing is on without any wiring
    tracer: Optional[tracing.Tracer] = None
    metrics: Optional[MetricsProvider] = None
    # aggregate-vote mode: "per_signature" keeps the reference protocol
    # (a <decide> embeds 2t+1 SignedEnvelope commit proofs, each
    # re-verified by every receiver); "aggregate" rides a BLS vote on
    # each <commit> and replaces the proof list with ONE threshold
    # certificate (consensus/threshold.py) whose verification is a
    # single pairing equation regardless of committee size (a host
    # pairing, as in the reference). Requires
    # vote_signer (this node's BLS key) and vote_aggregator (the
    # committee's registered BLS pubkeys, indexed like participants).
    vote_mode: str = "per_signature"
    vote_signer: Optional[object] = None
    vote_aggregator: Optional[object] = None

    def verify(self) -> None:
        if self.epoch is None:
            raise E.ErrConfigEpoch
        if self.state_compare is None:
            raise E.ErrConfigStateCompare
        if self.state_validate is None:
            raise E.ErrConfigStateValidate
        if self.signer is None:
            raise E.ErrConfigPrivateKey
        if len(self.participants) < CONFIG_MINIMUM_PARTICIPANTS:
            raise E.ErrConfigParticipants
        if self.vote_mode not in ("per_signature", "aggregate"):
            raise E.ErrConfigVoteMode
        if self.vote_mode == "aggregate" and (
                self.vote_signer is None or self.vote_aggregator is None):
            raise E.ErrConfigVoteMode


@dataclass
class _Tuple:
    state_hash: bytes
    message: W.ConsensusMessage
    signed: SignedEnvelope


class _Round:
    """Book-keeping for one consensus round (reference consensusRound)."""

    def __init__(self, number: int):
        self.number = number
        self.stage = Stage.ROUND_CHANGING
        self.locked_state: Optional[bytes] = None
        self.locked_state_hash: Optional[bytes] = None
        self.round_change_sent = False
        self.commit_sent = False
        self.round_changes: list[_Tuple] = []
        self.commits: list[_Tuple] = []
        self.commit_cert = None  # aggregate mode: threshold.QuorumCertificate
        self.max_proposed_state: Optional[bytes] = None
        self.max_proposed_count = 0

    def _sender(self, env: SignedEnvelope) -> bytes:
        return identity_of(env.pub_x, env.pub_y)

    def add_round_change(self, sp, m) -> bool:
        """One <roundchange> per sender (multiple-proposal defense)."""
        who = self._sender(sp)
        if any(self._sender(t.signed) == who for t in self.round_changes):
            return False
        self.round_changes.append(_Tuple(state_hash(m.state or None), m, sp))
        return True

    def find_round_change(self, who: bytes) -> int:
        for k, t in enumerate(self.round_changes):
            if self._sender(t.signed) == who:
                return k
        return -1

    def remove_round_change(self, idx: int) -> None:
        self.round_changes[idx] = self.round_changes[-1]
        self.round_changes.pop()

    def add_commit(self, sp, m) -> bool:
        who = self._sender(sp)
        if any(self._sender(t.signed) == who for t in self.commits):
            return False
        self.commits.append(_Tuple(state_hash(m.state or None), m, sp))
        return True

    def num_committed(self) -> int:
        return sum(
            1 for t in self.commits if t.state_hash == self.locked_state_hash
        )

    def signed_round_changes(self):
        return [t.signed for t in self.round_changes]

    def signed_commits(self):
        return [t.signed for t in self.commits]

    def round_change_states(self) -> list[bytes]:
        return [t.message.state for t in self.round_changes if t.message.state]

    def get_max_proposed(self) -> tuple[Optional[bytes], int]:
        """Most-agreed-on state among <roundchange>s; ties break toward the
        lexicographically smallest hash (matches the reference's
        sort-and-scan in consensus.go:197-239)."""
        if not self.round_changes:
            return None, 0
        groups: dict[bytes, list[_Tuple]] = {}
        for t in self.round_changes:
            groups.setdefault(t.state_hash, []).append(t)
        best_hash = min(groups, key=lambda h: (-len(groups[h]), h))
        winner = groups[best_hash][0]
        return (winner.message.state or None), len(groups[best_hash])


class Consensus:
    """Deterministic consensus automaton. Not thread-safe by design —
    thread-safety is the caller's job (reference doc.go:10-12)."""

    def __init__(self, config: Config):
        config.verify()
        self._cfg = config
        self.latest_state: Optional[bytes] = None
        self.latest_height: int = config.current_height
        self.latest_round: int = 0
        self.latest_proof: Optional[SignedEnvelope] = None

        self.unconfirmed: list[bytes] = []
        self.rounds: dict[int, _Round] = {}
        self.current_round: Optional[_Round] = None

        self.rc_timeout: Optional[float] = None
        self.lock_timeout: Optional[float] = None
        self.commit_timeout: Optional[float] = None
        self.lock_release_timeout: Optional[float] = None

        self.locks: list[_Tuple] = []

        self.signer = config.signer
        self.identity = config.signer.identity
        self.participants = list(config.participants)
        self.num_identities = len(set(self.participants))
        self.latency = config.latency
        self.enable_commit_unicast = config.enable_commit_unicast
        self.verifier: BatchVerifier = config.verifier or \
            TorchBatchVerifier(device=resolve_device(None))

        self.peers: list[PeerInterface] = []
        self.loopback: list[bytes] = []
        self.last_round_change_proof: Optional[list] = None
        self.fixed_leader: Optional[bytes] = None  # testing hook

        # observability: labeled message counters on the shared provider
        # (the old ad-hoc stats dict survives as a property view below)
        self._metrics = config.metrics or MetricsProvider()
        self._tracer = config.tracer or tracing.GLOBAL
        self._c_msgs = self._metrics.new_counter(MetricOpts(
            namespace="consensus", subsystem="engine", name="messages_total",
            help="Consensus messages by wire type and verify verdict.",
            label_names=("type", "verdict"),
        ))
        self._c_decided = self._metrics.new_counter(MetricOpts(
            namespace="consensus", subsystem="engine",
            name="heights_decided_total",
            help="Heights this engine has decided.",
        ))
        self._msg_type = "unknown"
        # span state: one root span per in-flight height, one child span
        # per protocol stage (the reference's docs/OBSERVABILITY.md)
        self._round_span: Optional[tracing.Span] = None
        self._phase_span: Optional[tracing.Span] = None

        self._switch_round(0)
        self._set_stage(Stage.ROUND_CHANGING)
        self._broadcast_round_change()
        self.rc_timeout = config.epoch + self._rc_duration(0)
        self._decide_resync_at = config.epoch

    @property
    def stats(self) -> dict:
        """Dict view over the counters (backward compatibility)."""
        by_verdict: dict[str, float] = {}
        for (_, verdict), v in self._c_msgs.values().items():
            by_verdict[verdict] = by_verdict.get(verdict, 0.0) + v
        return {
            "in": int(sum(by_verdict.values())),
            "verified": int(by_verdict.get("accepted", 0)),
            "rejected": int(by_verdict.get("rejected", 0)),
            "decided": int(self._c_decided.value()),
        }

    # ---- span plumbing (tracing.py) ------------------------------------
    def _ensure_round_span(self) -> None:
        """Open the per-height root span lazily. If the first activity
        for this height is processing a delivered message, the current
        context carries the sender's traceparent and this height's spans
        join the sender's trace (cross-node/process propagation)."""
        if self._round_span is None:
            self._round_span = self._tracer.start_span(
                "engine.height",
                parent=self._tracer.current(),
                attrs={"height": self.latest_height + 1,
                       "node": self.identity[:8].hex()},
            )

    def _end_phase_span(self) -> None:
        if self._phase_span is not None:
            self._phase_span.end()
            self._phase_span = None

    def _set_stage(self, stage: Stage) -> None:
        cr = self.current_round
        cr.stage = stage
        self._end_phase_span()
        self._ensure_round_span()
        self._phase_span = self._tracer.start_span(
            f"engine.phase.{stage.name.lower()}",
            parent=self._round_span,
            attrs={"round": cr.number, "height": self.latest_height + 1},
        )

    # ---- timing (consensus.go:371-413) --------------------------------
    def _capped(self, d: float) -> float:
        return min(d, MAX_CONSENSUS_LATENCY)

    def _rc_duration(self, rnd: int) -> float:
        return self._capped(2 * self.latency * (1 << min(rnd, 63)))

    _collect_duration = _rc_duration
    _commit_duration = _rc_duration
    _lock_release_duration = _rc_duration

    def _lock_duration(self, rnd: int) -> float:
        return self._capped(4 * self.latency * (1 << min(rnd, 63)))

    # ---- quorum & leadership ------------------------------------------
    def t(self) -> int:
        return (self.num_identities - 1) // 3

    def quorum(self) -> int:
        return 2 * self.t() + 1

    def round_leader(self, rnd: int) -> bytes:
        if self.fixed_leader is not None:
            return self.fixed_leader
        return self.participants[rnd % len(self.participants)]

    # ---- state selection ----------------------------------------------
    def _maximal_locked(self) -> Optional[bytes]:
        if not self.locks:
            return None
        best = self.locks[0].message.state
        for t in self.locks[1:]:
            if self._cfg.state_compare(best, t.message.state) < 0:
                best = t.message.state
        return best

    def _maximal_unconfirmed(self) -> Optional[bytes]:
        if not self.unconfirmed:
            return None
        best = self.unconfirmed[0]
        for s in self.unconfirmed[1:]:
            if self._cfg.state_compare(best, s) < 0:
                best = s
        return best

    # ---- verification --------------------------------------------------
    def _check_participant(self, env) -> bytes:
        coord = identity_of(env.pub_x, env.pub_y)
        if coord not in self.participants:
            raise E.ErrMessageUnknownParticipant
        return coord

    def _decode(self, env) -> W.ConsensusMessage:
        try:
            return W.decode_message(env.payload)
        except Exception as exc:
            raise E.ErrMessageDecode(str(exc))

    def _verify_message(self, env) -> W.ConsensusMessage:
        """participant check + signature + decode (consensus.go:449-493)."""
        if env is None or not env.payload:
            raise E.ErrMessageIsEmpty
        # strict 32-byte axes (reference PubKeyAxis.Unmarshal rejects
        # oversized axes, message.go:47-60) — also forecloses identity
        # confusion via a shifted X/Y split of the 64-byte concatenation
        if len(env.pub_x) != 32 or len(env.pub_y) != 32:
            raise E.ErrMessageDecode("public key axis must be 32 bytes")
        self._check_participant(env)
        if not self.verifier.verify_envelopes([env])[0]:
            raise E.ErrMessageSignature
        return self._decode(env)

    def _verify_proofs(
        self, m, proof_err_map
    ) -> list[tuple[bytes, W.ConsensusMessage]]:
        """Batch-verify all embedded proofs of a <lock>/<select>/<decide>.

        This is THE TPU seam: one verify_envelopes() call for the whole
        2t+1 proof list, replacing the reference's serial loop.
        Returns [(sender identity, decoded message)] in order.
        """
        envs = list(m.proof)
        senders = []
        for p in envs:
            coord = identity_of(p.pub_x, p.pub_y)
            if coord not in self.participants:
                raise proof_err_map["participant"]
            senders.append(coord)
        if envs:
            with self._tracer.span(
                "engine.verify_proofs", attrs={"n": len(envs)}
            ):
                oks = self.verifier.verify_envelopes(envs)
        else:
            oks = []
        decoded = []
        for p, coord, ok in zip(envs, senders, oks):
            if not ok:
                raise E.ErrMessageSignature
            decoded.append((coord, self._decode(p)))
        return decoded

    def _verify_round_change(self, m) -> None:
        if m.height != self.latest_height + 1:
            raise E.ErrRoundChangeHeightMismatch
        if m.round < self.current_round.number:
            raise E.ErrRoundChangeRoundLower
        if m.state and not self._cfg.state_validate(m.state, m.height):
            raise E.ErrRoundChangeStateValidation

    def _verify_lock(self, m, env) -> None:
        """<lock> must carry 2t+1 distinct <roundchange> proofs on its state
        (consensus.go:520-600)."""
        if m.height != self.latest_height + 1:
            raise E.ErrLockHeightMismatch
        if m.round < self.current_round.number:
            raise E.ErrLockRoundLower
        if not m.state:
            raise E.ErrLockEmptyState
        if not self._cfg.state_validate(m.state, m.height):
            raise E.ErrLockStateValidation
        if identity_of(env.pub_x, env.pub_y) != self.round_leader(m.round):
            raise E.ErrLockNotSignedByLeader

        rcs: dict[bytes, Optional[bytes]] = {}
        for coord, mp in self._verify_proofs(
            m, {"participant": E.ErrLockProofUnknownParticipant}
        ):
            if mp.type != MsgType.ROUND_CHANGE:
                raise E.ErrLockProofTypeMismatch
            if mp.height != m.height:
                raise E.ErrLockProofHeightMismatch
            if mp.round != m.round:
                raise E.ErrLockProofRoundMismatch
            if mp.state and not self._cfg.state_validate(mp.state, mp.height):
                raise E.ErrLockProofStateValidation
            rcs[coord] = mp.state or None

        m_hash = state_hash(m.state)
        n_valid = sum(1 for v in rcs.values() if state_hash(v) == m_hash)
        if n_valid < self.quorum():
            raise E.ErrLockProofInsufficient

    def _verify_lock_release(self, env) -> W.ConsensusMessage:
        if self.current_round.stage != Stage.LOCK_RELEASE:
            raise E.ErrLockReleaseStatus
        lockmsg = self._verify_message(env)
        self._verify_lock(lockmsg, env)
        return lockmsg

    def _verify_select(self, m, env) -> None:
        """<select> needs 2t+1 proofs overall but MUST NOT contain a 2t+1
        quorum on any single non-null state (consensus.go:628-728)."""
        if m.height != self.latest_height + 1:
            raise E.ErrSelectHeightMismatch
        if m.round < self.current_round.number:
            raise E.ErrSelectRoundLower
        if m.state and not self._cfg.state_validate(m.state, m.height):
            raise E.ErrSelectStateValidation
        if identity_of(env.pub_x, env.pub_y) != self.round_leader(m.round):
            raise E.ErrSelectNotSignedByLeader

        rcs: dict[bytes, Optional[bytes]] = {}
        for coord, mp in self._verify_proofs(
            m, {"participant": E.ErrSelectProofUnknownParticipant}
        ):
            if mp.type != MsgType.ROUND_CHANGE:
                raise E.ErrSelectProofTypeMismatch
            if mp.height != m.height:
                raise E.ErrSelectProofHeightMismatch
            if mp.round != m.round:
                raise E.ErrSelectProofRoundMismatch
            if mp.state and not self._cfg.state_validate(mp.state, mp.height):
                raise E.ErrSelectProofStateValidation
            if mp.state and m.state:
                if self._cfg.state_compare(m.state, mp.state) < 0:
                    raise E.ErrSelectProofNotTheMaximal
            rcs[coord] = mp.state or None

        if len(rcs) < self.quorum():
            raise E.ErrSelectProofInsufficient

        proposals: dict[bytes, int] = {}
        for v in rcs.values():
            if v is not None:
                h = state_hash(v)
                proposals[h] = proposals.get(h, 0) + 1
        if not m.state and proposals:
            raise E.ErrSelectStateMismatch
        if proposals and max(proposals.values()) >= self.quorum():
            raise E.ErrSelectProofExceeded

    def _verify_commit(self, m) -> None:
        if self.current_round.stage != Stage.COMMIT:
            raise E.ErrCommitStatus
        if not m.state:
            raise E.ErrCommitEmptyState
        if not self._cfg.state_validate(m.state, m.height):
            raise E.ErrCommitStateValidation
        if m.height != self.latest_height + 1:
            raise E.ErrCommitHeightMismatch
        if self.current_round.number != m.round:
            raise E.ErrCommitRoundMismatch
        if state_hash(m.state) != self.current_round.locked_state_hash:
            raise E.ErrCommitStateMismatch

    def _verify_decide(self, m, env, historical: bool = False) -> None:
        """<decide> must carry 2t+1 distinct <commit> proofs on its state
        (consensus.go:829-902). ``historical`` skips the height-advance
        check so committed blocks' proofs can be re-verified during
        catch-up (block-puller client)."""
        if not m.state:
            raise E.ErrDecideEmptyState
        if not historical and not self._cfg.state_validate(m.state, m.height):
            raise E.ErrDecideStateValidation
        if not historical and m.height <= self.latest_height:
            raise E.ErrDecideHeightLower
        if identity_of(env.pub_x, env.pub_y) != self.round_leader(m.round):
            raise E.ErrDecideNotSignedByLeader

        # aggregate mode: a commit certificate replaces the embedded
        # proof list — ONE pairing equation instead of 2t+1 signature
        # verifies. An invalid/mismatched certificate falls through to
        # the per-signature path, which rejects a proofless message
        # with ErrDecideProofInsufficient (a node without an aggregator
        # configured rejects cert-only decides the same way).
        if m.commit_cert and self._cfg.vote_aggregator is not None:
            from bdls_tpu_torch.consensus import threshold as TH

            cert = TH.deserialize_certificate(m.commit_cert)
            if (cert is not None
                    and cert.digest == state_hash(m.state)
                    and len(set(cert.signers)) >= self.quorum()
                    and self._cfg.vote_aggregator.verify_certificate(cert)):
                return

        commits: dict[bytes, Optional[bytes]] = {}
        for coord, mp in self._verify_proofs(
            m, {"participant": E.ErrDecideProofUnknownParticipant}
        ):
            if mp.type != MsgType.COMMIT:
                raise E.ErrDecideProofTypeMismatch
            if mp.height != m.height:
                raise E.ErrDecideProofHeightMismatch
            if mp.round != m.round:
                raise E.ErrDecideProofRoundMismatch
            if not self._cfg.state_validate(mp.state or b"", mp.height):
                raise E.ErrDecideProofStateValidation
            commits[coord] = mp.state or None

        m_hash = state_hash(m.state)
        n_valid = sum(1 for v in commits.values() if state_hash(v) == m_hash)
        if n_valid < self.quorum():
            raise E.ErrDecideProofInsufficient

    def validate_decide_message(self, data: bytes, target_state: bytes) -> None:
        """Validate a <decide> for non-participants (consensus.go:768-825)."""
        try:
            env = W.decode_envelope(data)
        except Exception as exc:
            raise E.ErrMessageDecode(str(exc))
        if env.version != PROTOCOL_VERSION:
            raise E.ErrMessageVersion
        m = self._verify_message(env)
        if (m.state or b"") != (target_state or b""):
            raise E.ErrMismatchedTargetState
        if m.type != MsgType.DECIDE:
            raise E.ErrMessageUnknownMessageType
        self._verify_decide(m, env)

    def verify_historical_decide(self, env, target_state: bytes) -> bool:
        """Full quorum verification of a <decide> for an already-committed
        height: leader signature + 2t+1 distinct valid <commit> proofs on
        ``target_state``. Used by the block-puller client so a single
        compromised consenter cannot forge catch-up blocks."""
        try:
            if env.version != PROTOCOL_VERSION:
                return False
            m = self._verify_message(env)
            if m.type != MsgType.DECIDE:
                return False
            if (m.state or b"") != (target_state or b""):
                return False
            self._verify_decide(m, env, historical=True)
            return True
        except E.ConsensusError:
            return False

    # ---- outbound ------------------------------------------------------
    def _make_message(self, mtype, state=None, proof=(), lock_release=None,
                      height=None, rnd=None) -> W.ConsensusMessage:
        m = W.ConsensusMessage(
            type=mtype,
            height=self.latest_height + 1 if height is None else height,
            round=self.current_round.number if rnd is None else rnd,
            proof=[W.copy_envelope(p) for p in proof])
        if state is not None:
            m.state = state
        if lock_release is not None:
            m.lock_release = W.copy_envelope(lock_release)
        return m

    def _sign(self, m) -> SignedEnvelope:
        env = self.signer.sign_payload(W.encode(m))
        if self._cfg.message_out_callback is not None:
            self._cfg.message_out_callback(m, env)
        return env

    def _broadcast(self, m) -> SignedEnvelope:
        """Sign & fan out to peers, and loop back to self
        (consensus.go:1023-1047)."""
        env = self._sign(m)
        out = W.encode(env)
        # outbound messages inherit the active span context (the recv
        # span while handling a message, else this height's round span)
        # so wire transports can stamp a traceparent on the frame
        with self._tracer.use(self._tracer.current() or self._round_span):
            for peer in self.peers:
                try:
                    peer.send(out)
                except Exception:
                    pass
        self.loopback.append(out)
        return env

    def _send_to(self, m, target: bytes) -> None:
        env = self._sign(m)
        out = W.encode(env)
        if target == self.identity:
            self.loopback.append(out)
            return
        with self._tracer.use(self._tracer.current() or self._round_span):
            for peer in self.peers:
                pid = peer.identity()
                if pid is not None and pid == target:
                    try:
                        peer.send(out)
                    except Exception:
                        pass

    def _propagate(self, data: bytes) -> None:
        with self._tracer.use(self._tracer.current() or self._round_span):
            for peer in self.peers:
                try:
                    peer.send(data)
                except Exception:
                    pass

    def _broadcast_round_change(self) -> None:
        cr = self.current_round
        if cr.round_change_sent and cr.stage != Stage.ROUND_CHANGING:
            return
        data = self._maximal_locked()
        if data is None:
            data = self._maximal_unconfirmed()
            if data is None:
                return
        self._broadcast(self._make_message(MsgType.ROUND_CHANGE, state=data))
        cr.round_change_sent = True

    def _broadcast_lock(self) -> None:
        cr = self.current_round
        self._broadcast(
            self._make_message(
                MsgType.LOCK, state=cr.locked_state, proof=cr.signed_round_changes()
            )
        )

    def _broadcast_lock_release(self, signed) -> None:
        self._broadcast(
            self._make_message(MsgType.LOCK_RELEASE, lock_release=signed)
        )

    def _broadcast_select(self) -> None:
        cr = self.current_round
        self._broadcast(
            self._make_message(
                MsgType.SELECT,
                state=self._maximal_unconfirmed(),
                proof=cr.signed_round_changes(),
            )
        )

    def _broadcast_decide(self) -> SignedEnvelope:
        cr = self.current_round
        cert = cr.commit_cert
        if (self._aggregate_votes() and cert is not None
                and cert.digest == state_hash(cr.locked_state)):
            # the certificate IS the proof: no embedded envelopes at
            # all, so the decide stays ~1.2 KB at any committee size
            from bdls_tpu_torch.consensus import threshold as TH

            m = self._make_message(MsgType.DECIDE, state=cr.locked_state)
            m.commit_cert = TH.serialize_certificate(cert)
            return self._broadcast(m)
        return self._broadcast(
            self._make_message(
                MsgType.DECIDE, state=cr.locked_state, proof=cr.signed_commits()
            )
        )

    def _broadcast_resync(self) -> None:
        """Re-broadcast last round-change proof for stragglers
        (consensus.go:988-999). Decide retransmission is the separate,
        event-driven :meth:`_maybe_resync_decide` — bundling the decide
        here would pay its signature verifications on every idle
        rc_timeout forever."""
        if not self.last_round_change_proof:
            return
        self._broadcast(
            self._make_message(MsgType.RESYNC, proof=self.last_round_change_proof)
        )

    def _maybe_resync_decide(self, now: float) -> None:
        """Retransmit the latest <decide> when a straggler is heard.

        ``_height_sync`` clears ``last_round_change_proof``, so after
        deciding height h a node in a lossy 2/2 split has nothing to
        resync with and — since nothing else in the protocol ever
        retransmits a decide — no way to lift the stragglers past h
        (the stall the reference's docs/ROBUSTNESS.md documented from
        its chaos suite).
        A message at or below our decided height is the tell: its
        sender missed the decide. Reply with a <resync> carrying the
        decide envelope, rate-limited per rc window so straggler
        chatter cannot turn the fleet into a signature storm; receivers
        already at the height reject the replay harmlessly
        (ErrDecideHeightLower)."""
        if self.latest_proof is None or now < self._decide_resync_at:
            return
        self._decide_resync_at = now + self._rc_duration(0)
        self._broadcast(
            self._make_message(MsgType.RESYNC, proof=[self.latest_proof])
        )

    def _aggregate_votes(self) -> bool:
        return (self._cfg.vote_mode == "aggregate"
                and self._cfg.vote_signer is not None
                and self._cfg.vote_aggregator is not None)

    def _send_commit(self, lock_msg) -> None:
        if self.current_round.commit_sent:
            return
        m = self._make_message(
            MsgType.COMMIT,
            state=lock_msg.state,
            height=lock_msg.height,
            rnd=lock_msg.round,
        )
        if self._aggregate_votes():
            # BLS vote over the locked state's digest rides the commit;
            # the leader aggregates 2t+1 of these into the certificate
            from bdls_tpu_torch.consensus import threshold as TH

            vote = self._cfg.vote_signer.sign_vote(state_hash(m.state or None))
            m.vote_sig = TH.serialize_point(vote)
        if self.enable_commit_unicast:
            self._send_to(m, self.round_leader(m.round))
        else:
            self._broadcast(m)
        self.current_round.commit_sent = True

    # ---- round management ---------------------------------------------
    def _get_round(self, idx: int, purge_lower: bool) -> _Round:
        if purge_lower:
            for k in [k for k in self.rounds if k < idx]:
                del self.rounds[k]
        if idx not in self.rounds:
            self.rounds[idx] = _Round(idx)
        return self.rounds[idx]

    def _switch_round(self, rnd: int) -> None:
        self.current_round = self._get_round(rnd, purge_lower=True)

    def _lock_release(self) -> None:
        """Keep only the max-round lock and broadcast it
        (consensus.go:1127-1140)."""
        if not self.locks:
            return
        best = self.locks[0]
        for t in self.locks[1:]:
            if best.message.round < t.message.round:
                best = t
        self.locks = [best]
        self._broadcast_lock_release(best.signed)

    def _height_sync(self, height: int, rnd: int, s: Optional[bytes]) -> None:
        self.latest_height = height
        self.latest_round = rnd
        self.latest_state = s
        self.last_round_change_proof = None
        self.rounds.clear()
        self.locks = []
        self.unconfirmed = []
        # close out this height's trace: the round root span ending is
        # what finalizes the trace into the /debug/traces ring
        self._end_phase_span()
        if self._round_span is not None:
            self._round_span.set_attr("decided_height", height)
            self._round_span.set_attr("decided_round", rnd)
            self._round_span.end()
            self._round_span = None
        self._c_decided.add()
        self._switch_round(0)
        # the next height starts a FRESH trace: chaining it to the decide
        # message's context would hold the finished round's trace open
        # (a trace finalizes only when its last span ends)
        self._round_span = self._tracer.start_span(
            "engine.height", parent=None,
            attrs={"height": self.latest_height + 1,
                   "node": self.identity[:8].hex()},
        )
        self._set_stage(Stage.ROUND_CHANGING)

    # ---- public API -----------------------------------------------------
    def propose(self, s: Optional[bytes]) -> None:
        """Queue state for the next height, deduplicated by hash
        (consensus.go:1177-1189)."""
        if not s:
            return
        h = state_hash(s)
        if any(state_hash(u) == h for u in self.unconfirmed):
            return
        self.unconfirmed.append(s)

    def has_proposed(self, s: bytes) -> bool:
        h = state_hash(s)
        for r in self.rounds.values():
            if any(t.state_hash == h for t in r.round_changes):
                return True
        if any(t.state_hash == h for t in self.locks):
            return True
        return any(state_hash(u) == h for u in self.unconfirmed)

    def receive_message(self, data: bytes, now: float) -> None:
        """Feed one wire message; raises a ``ConsensusError`` subclass on
        rejection (the exact taxonomy in
        :mod:`bdls_tpu_torch.consensus.errors`).

        Loopback messages queued while processing are drained afterwards,
        mirroring consensus.go:1193-1207 — errors on self-directed
        messages are ignored.
        """
        try:
            self._receive(data, now)
        finally:
            self._drain_loopback(now)

    submit_request = receive_message  # consensus.go:1638 alias

    def _drain_loopback(self, now: float) -> None:
        while self.loopback:
            data = self.loopback.pop(0)
            try:
                self._receive(data, now)
            except E.ConsensusError:
                pass

    def _receive(self, data: bytes, now: float) -> None:
        try:
            env = W.decode_envelope(data)
        except Exception as exc:
            self._c_msgs.add(labels=("decode", "rejected"))
            raise E.ErrMessageDecode(str(exc))
        # the span is a child of this engine's round span; if the message
        # arrived under a delivery span (ipc/cluster), record the sender's
        # context as a link attribute
        self._ensure_round_span()
        remote = self._tracer.current_traceparent()
        span = self._tracer.start_span("engine.recv", parent=self._round_span)
        if remote is not None and span.trace_id not in remote:
            span.set_attr("remote", remote)
        self._msg_type = "unknown"
        accepted = False
        with span:
            try:
                self._dispatch(env, data, now)
                accepted = True
            finally:
                span.name = f"engine.recv.{self._msg_type}"
                self._c_msgs.add(labels=(
                    self._msg_type, "accepted" if accepted else "rejected"
                ))

    def _dispatch(self, env, raw: bytes, now: float) -> None:
        if env.version != PROTOCOL_VERSION:
            raise E.ErrMessageVersion
        m = self._verify_message(env)
        try:
            self._msg_type = MsgType.Name(m.type).lower()
        except ValueError:
            self._msg_type = str(int(m.type))
        if self._cfg.message_validator is not None:
            if not self._cfg.message_validator(self, m, env):
                raise E.ErrMessageValidator

        # straggler detection: active-protocol traffic at or below our
        # decided height means its sender missed the <decide>
        if (m.height and m.height <= self.latest_height
                and m.type in (MsgType.ROUND_CHANGE, MsgType.SELECT,
                               MsgType.LOCK, MsgType.COMMIT)):
            self._maybe_resync_decide(now)

        if m.type == MsgType.NOP:
            return
        elif m.type == MsgType.ROUND_CHANGE:
            self._on_round_change(env, m, now)
        elif m.type == MsgType.SELECT:
            self._on_select(env, m, now)
        elif m.type == MsgType.LOCK:
            self._on_lock(env, m, now)
        elif m.type == MsgType.LOCK_RELEASE:
            self._on_lock_release(env, m, now)
        elif m.type == MsgType.COMMIT:
            self._on_commit(env, m, now)
        elif m.type == MsgType.DECIDE:
            self._on_decide(env, m, raw, now)
        elif m.type == MsgType.RESYNC:
            self._on_resync(env, m, now)
        else:
            raise E.ErrMessageUnknownMessageType

    # ---- per-type handlers (consensus.go:1236-1497) --------------------
    def _on_round_change(self, env, m, now: float) -> None:
        self._verify_round_change(m)
        sender = identity_of(env.pub_x, env.pub_y)

        # keep only this sender's highest-round <roundchange> across rounds
        # (OOM defense, consensus.go:1246-1280); never touch current round.
        for num in list(self.rounds):
            cr = self.rounds[num]
            idx = cr.find_round_change(sender)
            if idx == -1:
                continue
            if m.round == self.current_round.number:
                continue
            if cr.number > m.round:
                return  # already have a higher-round message from sender
            if cr.number < m.round:
                cr.remove_round_change(idx)
                if not cr.round_changes and cr is not self.current_round:
                    del self.rounds[num]

        round_ = self._get_round(m.round, purge_lower=False)
        if not round_.add_round_change(env, m):
            return

        # exactly-2t+1 trigger, once per round (consensus.go:1300-1323)
        if len(round_.round_changes) == self.quorum() and round_.stage < Stage.LOCK:
            self._switch_round(m.round)
            self.last_round_change_proof = self.current_round.signed_round_changes()
            self._broadcast_round_change()
            if self.round_leader(m.round) == self.identity:
                self.lock_timeout = now + self._collect_duration(m.round)
            else:
                self.lock_timeout = now + self._lock_duration(m.round)
            self._set_stage(Stage.LOCK)

        # leader tracks the max proposed state (consensus.go:1327-1332)
        if (
            round_ is self.current_round
            and len(round_.round_changes) >= self.quorum()
            and self.round_leader(m.round) == self.identity
        ):
            (
                round_.max_proposed_state,
                round_.max_proposed_count,
            ) = round_.get_max_proposed()

    def _on_select(self, env, m, now: float) -> None:
        self._verify_select(m, env)
        if m.round > self.current_round.number:
            self._switch_round(m.round)
            self.last_round_change_proof = [env]
        if self.current_round.stage < Stage.LOCK_RELEASE:
            self._set_stage(Stage.LOCK_RELEASE)
            self.lock_release_timeout = now + self._commit_duration(m.round)
            self._lock_release()
            self.propose(m.state or None)

    def _on_lock(self, env, m, now: float) -> None:
        self._verify_lock(m, env)
        if m.round > self.current_round.number:
            self._switch_round(m.round)
            self.last_round_change_proof = [env]
        if self.current_round.stage < Stage.COMMIT:
            self._set_stage(Stage.COMMIT)
            self.commit_timeout = now + self._commit_duration(m.round)
            m_hash = state_hash(m.state)
            # replace any lock on the same state (consensus.go:1377-1389)
            self.locks = [t for t in self.locks if t.state_hash != m_hash]
            self.locks.append(_Tuple(m_hash, m, env))
        self._send_commit(m)

    def _on_lock_release(self, env, m, now: float) -> None:
        lockmsg = self._verify_lock_release(m.lock_release)
        tup = _Tuple(state_hash(lockmsg.state), lockmsg, m.lock_release)
        if not self.locks:
            self.locks.append(tup)
            return
        kept = [t for t in self.locks if not (lockmsg.round > t.message.round)]
        if len(kept) < len(self.locks):
            self.locks = kept + [tup]

    def _on_commit(self, env, m, now: float) -> None:
        # only the round leader processes commits (consensus.go:1427-1462)
        if self.round_leader(m.round) != self.identity:
            return
        self._verify_commit(m)
        cr = self.current_round
        if not cr.add_commit(env, m):
            return
        if self._aggregate_votes() and m.vote_sig:
            self._absorb_vote(cr, env, m)
        if cr.num_committed() >= self.quorum():
            self.latest_proof = self._broadcast_decide()
            self._height_sync(self.latest_height + 1, cr.number, cr.locked_state)
            # leader waits one extra latency (consensus.go:1457)
            self.rc_timeout = now + self._rc_duration(0) + self.latency
            self._broadcast_round_change()

    def _absorb_vote(self, cr, env, m) -> None:
        """Leader-side vote ingestion: map the (already envelope-
        verified) commit sender to its validator index and feed the BLS
        vote to the aggregator. Malformed vote bytes read as no vote —
        the per-signature proof path still certifies the round, so a
        byzantine voter only loses the bandwidth win, never liveness."""
        from bdls_tpu_torch.consensus import threshold as TH

        sender = identity_of(env.pub_x, env.pub_y)
        try:
            idx = self._cfg.participants.index(sender)
        except ValueError:
            return
        try:
            sig = TH.deserialize_point(m.vote_sig)
        except ValueError:
            return
        cert = self._cfg.vote_aggregator.add_vote(
            state_hash(m.state or None), idx, sig)
        if cert is not None:
            cr.commit_cert = cert

    def _on_decide(self, env, m, raw: bytes, now: float) -> None:
        self._verify_decide(m, env)
        self.latest_proof = env
        self._propagate(raw)  # neighbours; verify stops broadcast storms
        self._height_sync(m.height, m.round, m.state)
        self.rc_timeout = now + self._rc_duration(0)
        self._broadcast_round_change()

    def _on_resync(self, env, m, now: float) -> None:
        # replay the proofs through loopback (consensus.go:1483-1492)
        for p in m.proof:
            self.loopback.append(W.encode(p))

    # ---- timeout automaton (consensus.go:1502-1594) --------------------
    def update(self, now: float) -> None:
        try:
            self._update(now)
        finally:
            self._drain_loopback(now)

    def _update(self, now: float) -> None:
        cr = self.current_round
        if cr.stage == Stage.ROUND_CHANGING:
            if now > self.rc_timeout:
                self._broadcast_round_change()
                self._broadcast_resync()
                self.rc_timeout = now + self._rc_duration(cr.number)
        elif cr.stage == Stage.LOCK:
            if self.round_leader(cr.number) == self.identity:
                if cr.max_proposed_count >= self.quorum():
                    cr.locked_state = cr.max_proposed_state
                    cr.locked_state_hash = state_hash(cr.max_proposed_state)
                    self._broadcast_lock()
                    self._set_stage(Stage.COMMIT)
                    self.commit_timeout = (
                        now + self._commit_duration(cr.number) + self.latency
                    )
                elif (
                    len(cr.round_changes) == len(self.participants)
                    or now > self.lock_timeout
                ):
                    for s in cr.round_change_states():
                        self.propose(s)
                    self._broadcast_select()
                    self._set_stage(Stage.LOCK_RELEASE)
                    self.lock_release_timeout = (
                        now + self._lock_release_duration(cr.number) + self.latency
                    )
                    self._lock_release()
            elif now > self.lock_timeout:
                self._set_stage(Stage.COMMIT)
                self.commit_timeout = now + self._commit_duration(cr.number)
        elif cr.stage == Stage.COMMIT:
            if now > self.commit_timeout:
                self._set_stage(Stage.LOCK_RELEASE)
                self.lock_release_timeout = now + self._lock_release_duration(
                    cr.number
                )
                self._lock_release()
        elif cr.stage == Stage.LOCK_RELEASE:
            if now > self.lock_release_timeout:
                self._switch_round(cr.number + 1)
                self._set_stage(Stage.ROUND_CHANGING)
                self._broadcast_round_change()
                self.rc_timeout = now + self._rc_duration(self.current_round.number)

    # ---- introspection --------------------------------------------------
    def current_state(self) -> tuple[int, int, Optional[bytes]]:
        return self.latest_height, self.latest_round, self.latest_state

    def current_proof(self) -> Optional[SignedEnvelope]:
        return self.latest_proof

    def set_latency(self, latency: float) -> None:
        self.latency = latency

    def join(self, peer: PeerInterface) -> bool:
        if any(p.remote_addr() == peer.remote_addr() for p in self.peers):
            return False
        self.peers.append(peer)
        return True

    def leave(self, addr: str) -> bool:
        for k, p in enumerate(self.peers):
            if p.remote_addr() == addr:
                self.peers.pop(k)
                return True
        return False

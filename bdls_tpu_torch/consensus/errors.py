"""The complete BDLS protocol-rejection taxonomy.

The port's copy of ``bdls_tpu/consensus/errors.py``, with the same class
names and hierarchy: the reference's 50+ sentinel errors
(``vendor/github.com/BDLS-bft/bdls/errors.go``) as a typed exception
hierarchy so conformance tests can assert exact rejection reasons.
"""


class ConsensusError(Exception):
    """Base class for every protocol rejection."""


class ConfigError(ConsensusError):
    pass


class ErrConfigEpoch(ConfigError): pass
class ErrConfigStateCompare(ConfigError): pass
class ErrConfigStateValidate(ConfigError): pass
class ErrConfigPrivateKey(ConfigError): pass
class ErrConfigParticipants(ConfigError): pass
class ErrConfigVoteMode(ConfigError): pass


class MessageError(ConsensusError):
    pass


class ErrMessageVersion(MessageError): pass
class ErrMessageValidator(MessageError): pass
class ErrMessageIsEmpty(MessageError): pass
class ErrMessageUnknownMessageType(MessageError): pass
class ErrMessageSignature(MessageError): pass
class ErrMessageUnknownParticipant(MessageError): pass
class ErrMessageDecode(MessageError): pass


class RoundChangeError(ConsensusError):
    pass


class ErrRoundChangeHeightMismatch(RoundChangeError): pass
class ErrRoundChangeRoundLower(RoundChangeError): pass
class ErrRoundChangeStateValidation(RoundChangeError): pass


class LockError(ConsensusError):
    pass


class ErrLockEmptyState(LockError): pass
class ErrLockStateValidation(LockError): pass
class ErrLockHeightMismatch(LockError): pass
class ErrLockRoundLower(LockError): pass
class ErrLockNotSignedByLeader(LockError): pass
class ErrLockProofUnknownParticipant(LockError): pass
class ErrLockProofTypeMismatch(LockError): pass
class ErrLockProofHeightMismatch(LockError): pass
class ErrLockProofRoundMismatch(LockError): pass
class ErrLockProofStateValidation(LockError): pass
class ErrLockProofInsufficient(LockError): pass


class SelectError(ConsensusError):
    pass


class ErrSelectStateValidation(SelectError): pass
class ErrSelectHeightMismatch(SelectError): pass
class ErrSelectRoundLower(SelectError): pass
class ErrSelectNotSignedByLeader(SelectError): pass
class ErrSelectStateMismatch(SelectError): pass
class ErrSelectProofUnknownParticipant(SelectError): pass
class ErrSelectProofTypeMismatch(SelectError): pass
class ErrSelectProofHeightMismatch(SelectError): pass
class ErrSelectProofRoundMismatch(SelectError): pass
class ErrSelectProofStateValidation(SelectError): pass
class ErrSelectProofNotTheMaximal(SelectError): pass
class ErrSelectProofInsufficient(SelectError): pass
class ErrSelectProofExceeded(SelectError): pass


class DecideError(ConsensusError):
    pass


class ErrDecideHeightLower(DecideError): pass
class ErrDecideEmptyState(DecideError): pass
class ErrDecideStateValidation(DecideError): pass
class ErrDecideNotSignedByLeader(DecideError): pass
class ErrDecideProofUnknownParticipant(DecideError): pass
class ErrDecideProofTypeMismatch(DecideError): pass
class ErrDecideProofHeightMismatch(DecideError): pass
class ErrDecideProofRoundMismatch(DecideError): pass
class ErrDecideProofStateValidation(DecideError): pass
class ErrDecideProofInsufficient(DecideError): pass


class LockReleaseError(ConsensusError):
    pass


class ErrLockReleaseStatus(LockReleaseError): pass


class CommitError(ConsensusError):
    pass


class ErrCommitEmptyState(CommitError): pass
class ErrCommitStateMismatch(CommitError): pass
class ErrCommitStateValidation(CommitError): pass
class ErrCommitStatus(CommitError): pass
class ErrCommitHeightMismatch(CommitError): pass
class ErrCommitRoundMismatch(CommitError): pass


class ErrMismatchedTargetState(ConsensusError):
    pass

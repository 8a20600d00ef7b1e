"""The ordering wire format, encoded and decoded without protobuf.

The counterpart of ``bdls_tpu/ordering/fabric_pb2.py`` (the schema
``bdls_tpu/ordering/fabric.proto``): the enum ``TxType`` and its 17
messages, declared as tables of fields on
:mod:`bdls_tpu_torch.utils.proto3_message`, which writes the bytes
protobuf writes and accepts and refuses what protobuf's parser accepts
and refuses (:class:`DecodeError`). ``TxType`` is an open enum, an
int32 on the wire: a value the schema does not name is kept.
"""

from __future__ import annotations

from bdls_tpu_torch.utils.proto3_message import (BOOL, BYTES, DOUBLE, ENUM,
                                                 INT64, MESSAGE, STRING,
                                                 UINT32, UINT64, DecodeError,
                                                 Message, enum, message)

__all__ = [
    "DecodeError", "Message", "TxType", "TX_NORMAL", "TX_CONFIG",
    "TxHeader", "TxEnvelope", "BlockHeader", "BlockData", "BlockMetadata",
    "Block", "BlockSignature", "LastConfig", "Consenter", "ChannelConfig",
    "KVWrite", "WriteSet", "KVRead", "ReadSet", "Endorsement",
    "ProposalMsg", "EndorsedAction",
]


TxType = enum("TxType", {"TX_NORMAL": 0, "TX_CONFIG": 1}, __name__)

TX_NORMAL = TxType.TX_NORMAL
TX_CONFIG = TxType.TX_CONFIG


def _message(name: str, fields: list) -> type:
    return message(name, fields, __name__)


TxHeader = _message("TxHeader", [
    ("type", 1, ENUM), ("channel_id", 2, STRING), ("tx_id", 3, STRING),
    ("creator_x", 4, BYTES), ("creator_y", 5, BYTES),
    ("creator_org", 6, STRING), ("timestamp_unix_ms", 7, INT64)])
TxEnvelope = _message("TxEnvelope", [
    ("header", 1, MESSAGE, False, TxHeader), ("payload", 2, BYTES),
    ("sig_r", 3, BYTES), ("sig_s", 4, BYTES)])
BlockHeader = _message("BlockHeader", [
    ("number", 1, UINT64), ("previous_hash", 2, BYTES),
    ("data_hash", 3, BYTES)])
BlockData = _message("BlockData", [("transactions", 1, BYTES, True)])
BlockMetadata = _message("BlockMetadata", [("entries", 1, BYTES, True)])
Block = _message("Block", [
    ("header", 1, MESSAGE, False, BlockHeader),
    ("data", 2, MESSAGE, False, BlockData),
    ("metadata", 3, MESSAGE, False, BlockMetadata)])
BlockSignature = _message("BlockSignature", [
    ("signer_x", 1, BYTES), ("signer_y", 2, BYTES), ("sig_r", 3, BYTES),
    ("sig_s", 4, BYTES)])
LastConfig = _message("LastConfig", [("index", 1, UINT64)])
Consenter = _message("Consenter", [
    ("identity", 1, BYTES), ("host", 2, STRING), ("port", 3, UINT32)])
ChannelConfig = _message("ChannelConfig", [
    ("channel_id", 1, STRING),
    ("consenters", 2, MESSAGE, True, Consenter),
    ("max_message_count", 3, UINT32), ("preferred_max_bytes", 4, UINT64),
    ("absolute_max_bytes", 5, UINT64), ("batch_timeout_s", 6, DOUBLE),
    ("writer_orgs", 7, STRING, True), ("config_seq", 8, UINT64),
    ("consensus_latency_s", 9, DOUBLE), ("reader_orgs", 10, STRING, True),
    ("consensus_type", 11, STRING), ("capability_level", 12, UINT32)])
KVWrite = _message("KVWrite", [
    ("key", 1, STRING), ("value", 2, BYTES), ("is_delete", 3, BOOL),
    ("collection", 4, STRING), ("value_hash", 5, BYTES)])
WriteSet = _message("WriteSet", [("writes", 1, MESSAGE, True, KVWrite)])
KVRead = _message("KVRead", [
    ("key", 1, STRING), ("exists", 2, BOOL), ("version_block", 3, UINT64),
    ("version_tx", 4, UINT64)])
ReadSet = _message("ReadSet", [("reads", 1, MESSAGE, True, KVRead)])
Endorsement = _message("Endorsement", [
    ("endorser_x", 1, BYTES), ("endorser_y", 2, BYTES), ("org", 3, STRING),
    ("sig_r", 4, BYTES), ("sig_s", 5, BYTES)])
ProposalMsg = _message("ProposalMsg", [
    ("channel_id", 1, STRING), ("contract", 2, STRING),
    ("args", 3, BYTES, True), ("creator_x", 4, BYTES),
    ("creator_y", 5, BYTES), ("creator_org", 6, STRING),
    ("sig_r", 7, BYTES), ("sig_s", 8, BYTES)])
EndorsedAction = _message("EndorsedAction", [
    ("proposal_hash", 1, BYTES),
    ("write_set", 2, MESSAGE, False, WriteSet),
    ("endorsements", 3, MESSAGE, True, Endorsement),
    ("read_set", 4, MESSAGE, False, ReadSet),
    ("contract", 5, STRING)])

MESSAGES = (TxHeader, TxEnvelope, BlockHeader, BlockData, BlockMetadata,
            Block, BlockSignature, LastConfig, Consenter, ChannelConfig,
            KVWrite, WriteSet, KVRead, ReadSet, Endorsement, ProposalMsg,
            EndorsedAction)

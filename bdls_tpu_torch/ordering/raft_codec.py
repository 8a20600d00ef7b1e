"""The Raft chain's wire format, encoded and decoded without protobuf.

The counterpart of ``bdls_tpu/ordering/raft_pb2.py`` (the schema
``bdls_tpu/ordering/raft.proto``): ``RaftEntry`` and ``RaftMessage``
with its nested enum ``Type``, as tables of fields on
:mod:`bdls_tpu_torch.utils.proto3_message`, byte for byte protobuf's.
The field ``from`` is a Python keyword: read and set it with
``getattr``/``setattr``, as with protobuf.
"""

from __future__ import annotations

from bdls_tpu_torch.utils.proto3_message import (BOOL, BYTES, ENUM, MESSAGE,
                                                 UINT64, DecodeError,
                                                 Message, enum, message)

__all__ = ["DecodeError", "Message", "RaftEntry", "RaftMessage"]

RaftEntry = message("RaftEntry", [
    ("term", 1, UINT64), ("index", 2, UINT64), ("data", 3, BYTES)],
    __name__)
RaftMessage = message("RaftMessage", [
    ("type", 1, ENUM), ("term", 2, UINT64), ("from", 3, BYTES),
    ("last_log_index", 4, UINT64), ("last_log_term", 5, UINT64),
    ("granted", 6, BOOL), ("prev_index", 7, UINT64),
    ("prev_term", 8, UINT64),
    ("entries", 9, MESSAGE, True, RaftEntry), ("commit", 10, UINT64),
    ("success", 11, BOOL), ("match_index", 12, UINT64)], __name__,
    enums=(enum("Type", {"VOTE_REQ": 0, "VOTE_RESP": 1, "APPEND_REQ": 2,
                         "APPEND_RESP": 3}, __name__),))

MESSAGES = (RaftEntry, RaftMessage)

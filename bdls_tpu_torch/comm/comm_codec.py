"""The cluster transport's wire format, encoded and decoded without
protobuf.

The counterpart of ``bdls_tpu/comm/comm_pb2.py`` (the schema
``bdls_tpu/comm/comm.proto``): its 7 messages as tables of fields on
:mod:`bdls_tpu_torch.utils.proto3_message`, byte for byte protobuf's.
``ClusterFrame``'s members form the ``oneof`` group ``kind``.
"""

from __future__ import annotations

from bdls_tpu_torch.utils.proto3_message import (BOOL, BYTES, INT64,
                                                 MESSAGE, STRING, UINT32,
                                                 UINT64, DecodeError,
                                                 Message, message)

__all__ = [
    "DecodeError", "Message", "AuthChallenge", "AuthRequest",
    "AuthResponse", "StepFrame", "PullRequest", "PullResponse",
    "ClusterFrame",
]


def _message(name: str, fields: list) -> type:
    return message(name, fields, __name__)


AuthChallenge = _message("AuthChallenge", [
    ("nonce", 1, BYTES), ("eph_pub", 2, BYTES), ("sig_r", 3, BYTES),
    ("sig_s", 4, BYTES)])
AuthRequest = _message("AuthRequest", [
    ("version", 1, UINT32), ("timestamp_unix_ms", 2, INT64),
    ("from_id", 3, BYTES), ("to_id", 4, BYTES),
    ("session_nonce", 5, BYTES), ("sig_r", 6, BYTES), ("sig_s", 7, BYTES),
    ("eph_pub", 8, BYTES)])
AuthResponse = _message("AuthResponse", [
    ("ok", 1, BOOL), ("error", 2, STRING)])
StepFrame = _message("StepFrame", [
    ("channel", 1, STRING), ("payload", 2, BYTES),
    ("traceparent", 3, STRING)])
PullRequest = _message("PullRequest", [
    ("channel", 1, STRING), ("start", 2, UINT64), ("end", 3, UINT64)])
PullResponse = _message("PullResponse", [
    ("channel", 1, STRING), ("number", 2, UINT64), ("block", 3, BYTES)])
ClusterFrame = _message("ClusterFrame", [
    ("auth", 1, MESSAGE, False, AuthRequest, "kind"),
    ("auth_resp", 2, MESSAGE, False, AuthResponse, "kind"),
    ("step", 3, MESSAGE, False, StepFrame, "kind"),
    ("pull_req", 4, MESSAGE, False, PullRequest, "kind"),
    ("pull_resp", 5, MESSAGE, False, PullResponse, "kind"),
    ("auth_challenge", 6, MESSAGE, False, AuthChallenge, "kind")])

MESSAGES = (AuthChallenge, AuthRequest, AuthResponse, StepFrame,
            PullRequest, PullResponse, ClusterFrame)

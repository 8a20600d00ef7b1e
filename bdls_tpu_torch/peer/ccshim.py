"""Chaincode shim: the child-process side of the external contract
runtime.

Reference parity: ``core/chaincode/shim`` — the process that hosts user
contract code, speaking a framed request/response protocol with the
peer. Transport here is stdin/stdout with 4-byte length-framed JSON
messages (the reference uses gRPC to a docker/external container; the
protocol shape — Init, Invoke with GetState/PutState round trips — is
the same).

Child protocol (each line a framed JSON object):
  peer -> shim: {"op": "init", "path": <contract .py file>, "name": <fn>}
  peer -> shim: {"op": "invoke", "args": [<hex>, ...]}
  shim -> peer: {"op": "get", "key": <str>}          (mid-simulation)
  peer -> shim: {"op": "value", "value": <hex|null>}
  shim -> peer: {"op": "result", "writes": [[key, <hex|null>], ...]}
  shim -> peer: {"op": "error", "error": <str>}

Run: ``python -m bdls_tpu_torch.peer.ccshim``.

The port's copy of ``bdls_tpu/peer/ccshim.py``, whole. It imports the
standard library only, and ``bdls_tpu_torch`` and ``bdls_tpu_torch.peer``
import nothing, so the child starts without torch.
"""

from __future__ import annotations

import json
import struct
import sys


def _read_msg(stream) -> dict:
    hdr = stream.read(4)
    if len(hdr) < 4:
        raise EOFError
    (n,) = struct.unpack("<I", hdr)
    return json.loads(stream.read(n))


def _write_msg(stream, obj: dict) -> None:
    payload = json.dumps(obj).encode()
    stream.write(struct.pack("<I", len(payload)) + payload)
    stream.flush()


def main() -> None:
    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    contract = None
    while True:
        try:
            msg = _read_msg(stdin)
        except EOFError:
            return
        op = msg.get("op")
        if op == "init":
            namespace: dict = {}
            try:
                with open(msg["path"]) as fh:
                    code = fh.read()
                exec(compile(code, msg["path"], "exec"), namespace)  # noqa: S102
                contract = namespace[msg["name"]]
                _write_msg(stdout, {"op": "ready"})
            except Exception as exc:  # noqa: BLE001
                _write_msg(stdout, {"op": "error", "error": repr(exc)})
        elif op == "invoke":
            if contract is None:
                _write_msg(stdout, {"op": "error", "error": "not initialized"})
                continue

            def read(key: str):
                _write_msg(stdout, {"op": "get", "key": key})
                resp = _read_msg(stdin)
                value = resp.get("value")
                return bytes.fromhex(value) if value is not None else None

            try:
                args = [bytes.fromhex(a) for a in msg["args"]]
                writes = contract(read, args)
                _write_msg(stdout, {
                    "op": "result",
                    "writes": [
                        [k, v.hex() if v is not None else None]
                        for k, v in writes
                    ],
                })
            except Exception as exc:  # noqa: BLE001
                _write_msg(stdout, {"op": "error", "error": repr(exc)})
        elif op == "exit":
            return


if __name__ == "__main__":
    main()

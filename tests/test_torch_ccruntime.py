"""The port's out-of-process contract runtime
(``bdls_tpu_torch/peer/ccruntime.py`` and ``ccshim.py``), on the CPU.

- The reference's six scenarios (``tests/test_ccruntime.py``) on the
  port: an invoke in another process, state reads round-tripping, a
  contract's exception surfacing with the process kept, a hung contract
  killed and relaunched, an import that hangs failing the launch within
  its timeout, and an ``Endorser`` over an ``ExternalContract``.
- The same invokes through the reference's runtime and the port's: the
  frames each writes to its child are byte-equal, and so are the
  results and ``stats``.
"""

from __future__ import annotations

import os
import time

import pytest

from bdls_tpu.peer import ccruntime as JR
from bdls_tpu_torch.crypto.sw import SwCSP
from bdls_tpu_torch.peer import ccruntime as R
from bdls_tpu_torch.peer.ccruntime import ContractRuntimeError, ExternalContract
from bdls_tpu_torch.peer.committer import KVState
from bdls_tpu_torch.peer.endorser import (Endorser, ErrSimulationFailed,
                                          Proposal, sign_proposal)

CSP = SwCSP()

CONTRACT_SRC = '''
def kv_contract(read, args):
    """args: op, key[, value]"""
    op = args[0].decode()
    key = args[1].decode()
    if op == "put":
        return [(key, args[2])]
    if op == "incr":
        cur = read(key)
        return [(key, str(int(cur or b"0") + 1).encode())]
    if op == "del":
        return [(key, None)]
    if op == "boom":
        raise RuntimeError("contract exploded")
    if op == "hang":
        import time
        time.sleep(60)
    return []
'''


@pytest.fixture()
def path(tmp_path):
    p = tmp_path / "contract.py"
    p.write_text(CONTRACT_SRC)
    return str(p)


@pytest.fixture()
def contract(path):
    ext = ExternalContract(path, "kv_contract", timeout=3.0)
    yield ext
    ext.close()


def test_invoke_runs_out_of_process(contract):
    assert contract(lambda k: None, [b"put", b"color", b"blue"]) == \
        [("color", b"blue")]
    assert contract._proc.pid not in (None, os.getpid())


def test_state_reads_round_trip(contract):
    state = {"counter": b"41"}
    assert contract(lambda k: state.get(k), [b"incr", b"counter"]) == \
        [("counter", b"42")]
    assert contract(lambda k: None, [b"del", b"counter"]) == \
        [("counter", None)]


def test_contract_exception_surfaces_and_process_survives(contract):
    with pytest.raises(ContractRuntimeError, match="exploded"):
        contract(lambda k: None, [b"boom", b"x"])
    assert contract(lambda k: None, [b"put", b"a", b"1"]) == [("a", b"1")]
    assert contract.stats == {"launches": 1, "invokes": 2, "crashes": 0}


def test_hung_contract_killed_and_restarted(contract):
    with pytest.raises(ContractRuntimeError):
        contract(lambda k: None, [b"hang", b"x"])
    assert contract(lambda k: None, [b"put", b"b", b"2"]) == [("b", b"2")]
    assert contract.stats["launches"] == 2


def test_import_hang_does_not_deadlock(tmp_path):
    p = tmp_path / "hangs.py"
    p.write_text("import time\ntime.sleep(60)\n"
                 "def c(read, args):\n    return []\n")
    ext = ExternalContract(str(p), "c", timeout=2.0)
    t0 = time.monotonic()
    try:
        with pytest.raises(ContractRuntimeError, match="init"):
            ext(lambda k: None, [b"x"])
        assert time.monotonic() - t0 < 10.0
    finally:
        ext.close()


def test_endorser_uses_external_contract(contract):
    endorser = Endorser(CSP, CSP.key_from_scalar("P-256", 0xCC01), "org1",
                        KVState())
    endorser.register_contract("extkv", contract)
    client = CSP.key_from_scalar("P-256", 0xCC02)

    def prop(args):
        return sign_proposal(CSP, client, Proposal(
            channel_id="cc", contract="extkv", args=args, creator_x=b"",
            creator_y=b"", creator_org="org1"))

    action = endorser.process_proposal(prop([b"put", b"k", b"v"]))
    assert (action.write_set.writes[0].key,
            action.write_set.writes[0].value) == ("k", b"v")
    assert len(action.endorsements) == 1
    with pytest.raises(ErrSimulationFailed):
        endorser.process_proposal(prop([b"boom", b"k"]))


def test_frames_and_results_match_reference(path, monkeypatch):
    state = {"n": b"7"}
    invokes = [[b"put", b"a", b"\x00\xff"], [b"incr", b"n"],
               [b"incr", b"missing"], [b"del", b"a"], [b"boom", b"x"],
               [b"noop", b"x"]]
    got = {}
    for name, mod in (("reference", JR), ("port", R)):
        frames = []
        real = mod.ExternalContract._send

        def send(self, obj, _real=real, _frames=frames):
            w = self._proc.stdin.write
            self._proc.stdin.write = lambda b, _w=w: (_frames.append(b),
                                                      _w(b))[1]
            try:
                _real(self, obj)
            finally:
                self._proc.stdin.write = w

        monkeypatch.setattr(mod.ExternalContract, "_send", send)
        ext = mod.ExternalContract(path, "kv_contract", timeout=5.0)
        results = []
        try:
            for args in invokes:
                try:
                    results.append(ext(state.get, args))
                except mod.ContractRuntimeError as exc:
                    results.append(str(exc))
            stats = dict(ext.stats)
        finally:
            ext.close()
        got[name] = (frames, results, stats)
    assert got["port"] == got["reference"]
    assert got["port"][2] == {"launches": 1, "invokes": 6, "crashes": 0}
    assert got["port"][0][0].endswith(b'"op": "init", "path": "' +
                                      path.encode() +
                                      b'", "name": "kv_contract"}')

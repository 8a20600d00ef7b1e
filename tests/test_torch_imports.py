"""The port stands alone: no jax, no bdls_tpu, no cryptography, no
protobuf, no grpc.

``bdls_tpu_torch``, ``chip_smoke.py`` and
``tools/torch_verify_group_probe.py`` run on a machine that has none
of them, so a subprocess imports every module of the port and
checks ``sys.modules``, a second one imports them with ``google.protobuf``
and ``grpc`` blocked and runs a verifyd round trip, and a source scan
checks every import statement.
Entry points called without a device run on the card and raise where
there is none.
"""

from __future__ import annotations

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bdls_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "bdls_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "bdls_tpu", "cryptography", "google.protobuf",
             "grpc")


def _forbidden(module: str) -> bool:
    """A module of a forbidden package, or generated protobuf code."""
    return module.endswith("_pb2") or any(
        module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        bdls_tpu_torch.__path__, prefix="bdls_tpu_torch."))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("bdls_tpu_torch.crypto.torch_provider",
                 "bdls_tpu_torch.crypto.key_cache",
                 "bdls_tpu_torch.consensus.identity",
                 "bdls_tpu_torch.consensus.verifier",
                 "bdls_tpu_torch.ops.ecdsa", "bdls_tpu_torch.ops._build",
                 "bdls_tpu_torch.ops.glv",
                 "bdls_tpu_torch.ops.verify_fold",
                 "bdls_tpu_torch.ops.aot_cache",
                 "bdls_tpu_torch.ops.table_snapshot",
                 "bdls_tpu_torch.ops.sha256",
                 "bdls_tpu_torch.ops.block_verify",
                 "bdls_tpu_torch.ops.ed25519",
                 "bdls_tpu_torch.ops.curves",
                 "bdls_tpu_torch.crypto.vectors",
                 "bdls_tpu_torch.crypto.blocklane",
                 "bdls_tpu_torch.utils.device",
                 "bdls_tpu_torch.ops.bls_host",
                 "bdls_tpu_torch.ops.fp381",
                 "bdls_tpu_torch.ops.bls_kernel",
                 "bdls_tpu_torch.consensus.threshold",
                 "bdls_tpu_torch.ops.mont",
                 "bdls_tpu_torch.ops.jacobian",
                 "bdls_tpu_torch.ops.mxu",
                 "bdls_tpu_torch.parallel",
                 "bdls_tpu_torch.parallel.mesh",
                 "bdls_tpu_torch.sidecar",
                 "bdls_tpu_torch.sidecar.verifyd_codec",
                 "bdls_tpu_torch.sidecar.wire",
                 "bdls_tpu_torch.sidecar.router",
                 "bdls_tpu_torch.sidecar.coalescer",
                 "bdls_tpu_torch.sidecar.verifyd",
                 "bdls_tpu_torch.sidecar.remote_csp",
                 "bdls_tpu_torch.cli",
                 "bdls_tpu_torch.cli.main",
                 "bdls_tpu_torch.consensus.errors",
                 "bdls_tpu_torch.consensus.wire_codec",
                 "bdls_tpu_torch.consensus.engine",
                 "bdls_tpu_torch.consensus.ipc",
                 "bdls_tpu_torch.consensus.rounds",
                 "bdls_tpu_torch.utils.proto3",
                 "bdls_tpu_torch.utils.proto3_message",
                 "bdls_tpu_torch.utils.flog",
                 "bdls_tpu_torch.utils.slo",
                 "bdls_tpu_torch.utils.operations",
                 "bdls_tpu_torch.obs",
                 "bdls_tpu_torch.obs.tsdb",
                 "bdls_tpu_torch.ordering",
                 "bdls_tpu_torch.ordering.fabric_codec",
                 "bdls_tpu_torch.ordering.block",
                 "bdls_tpu_torch.ordering.blockcutter",
                 "bdls_tpu_torch.ordering.ledger",
                 "bdls_tpu_torch.ordering.chain",
                 "bdls_tpu_torch.utils.frames",
                 "bdls_tpu_torch.crypto.framing",
                 "bdls_tpu_torch.crypto.msp",
                 "bdls_tpu_torch.peer",
                 "bdls_tpu_torch.peer.lifecycle",
                 "bdls_tpu_torch.peer.privdata",
                 "bdls_tpu_torch.peer.validator",
                 "bdls_tpu_torch.peer.committer",
                 "bdls_tpu_torch.peer.endorser",
                 "bdls_tpu_torch.peer.deliverclient",
                 "bdls_tpu_torch.models",
                 "bdls_tpu_torch.models.peer",
                 "bdls_tpu_torch.models.txflow",
                 "bdls_tpu_torch.comm",
                 "bdls_tpu_torch.comm.comm_codec",
                 "bdls_tpu_torch.comm.aead",
                 "bdls_tpu_torch.comm.cluster",
                 "bdls_tpu_torch.ordering.raft_codec",
                 "bdls_tpu_torch.ordering.msgprocessor",
                 "bdls_tpu_torch.ordering.follower",
                 "bdls_tpu_torch.ordering.raft",
                 "bdls_tpu_torch.ordering.registrar",
                 "bdls_tpu_torch.models.orderer",
                 "bdls_tpu_torch.crypto.policy",
                 "bdls_tpu_torch.peer.gossip",
                 "bdls_tpu_torch.peer.membership",
                 "bdls_tpu_torch.peer.discovery",
                 "bdls_tpu_torch.peer.snapshot",
                 "bdls_tpu_torch.peer.ccruntime",
                 "bdls_tpu_torch.peer.ccshim"):
        assert name in mods


def test_the_contract_child_loads_no_torch(tmp_path):
    """``ExternalContract``'s child (``python -S -m
    bdls_tpu_torch.peer.ccshim``) imports the standard library only: a
    contract there reports which of the port's heavy imports are
    loaded, and none is."""
    from bdls_tpu_torch.peer.ccruntime import ExternalContract

    src = tmp_path / "probe.py"
    src.write_text(
        "import sys\n"
        "def probe(read, args):\n"
        "    names = ('torch', 'numpy', 'jax', 'bdls_tpu', 'bdls_tpu_torch',\n"
        "             'bdls_tpu_torch.peer', 'bdls_tpu_torch.peer.ccshim')\n"
        "    return [(n, b'1' if n in sys.modules else b'0') for n in names]\n")
    ext = ExternalContract(str(src), "probe", timeout=30.0)
    try:
        loaded = dict(ext(lambda key: None, []))
    finally:
        ext.close()
    assert loaded == {"torch": b"0", "numpy": b"0", "jax": b"0",
                      "bdls_tpu": b"0", "bdls_tpu_torch": b"1",
                      "bdls_tpu_torch.peer": b"1",
                      "bdls_tpu_torch.peer.ccshim": b"0"}


def test_import_loads_no_forbidden_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []


def test_sidecar_runs_with_protobuf_and_grpc_blocked():
    """The card's machine has neither: with both made unimportable, every
    module imports and a daemon answers a client over the socket tier."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'grpc' or name.startswith(\n"
        "                'google.protobuf'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from bdls_tpu_torch.crypto.sw import SwCSP\n"
        "from bdls_tpu_torch.crypto.csp import VerifyRequest\n"
        "from bdls_tpu_torch.crypto.torch_provider import TorchCSP\n"
        "from bdls_tpu_torch.sidecar.verifyd import VerifydServer\n"
        "from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP\n"
        "sw = SwCSP(); k = sw.key_from_scalar('P-256', 7)\n"
        "d = sw.hash(b'm'); r, s = sw.sign(k, d)\n"
        "reqs = [VerifyRequest(k.public_key(), d, r, s),\n"
        "        VerifyRequest(k.public_key(), sw.hash(b'x'), r, s)]\n"
        "srv = VerifydServer(csp=TorchCSP(device='cpu', kernel_field='sw',\n"
        "                                 key_cache_size=0)).start()\n"
        "c = RemoteCSP(f'127.0.0.1:{srv.port}')\n"
        "print(c.verify_batch(reqs), int(c._c_remote.value()))\n"
        "c.close(); srv.stop(); srv.close_csp()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'grpc'\n"
        "             or m.startswith('google.protobuf')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[True, False] 1", "[]"]


def test_transaction_flow_runs_with_protobuf_and_grpc_blocked():
    """The ordering codec stands in for ``fabric_pb2``: with protobuf
    and grpc unimportable, four validators order a gateway's
    transactions and both peers commit them."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'grpc' or name.startswith(\n"
        "                'google.protobuf'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from bdls_tpu_torch.consensus import CpuBatchVerifier\n"
        "from bdls_tpu_torch.crypto.sw import SwCSP\n"
        "from bdls_tpu_torch.models import txflow as F\n"
        "sys.path.insert(0, 'tests')\n"
        "import _txflow_workload as W\n"
        "st = F.build_stack(SwCSP(), CpuBatchVerifier())\n"
        "sub = W.submit_plan(st, W.plan(10, 10, hostile_every=5, offset=2))\n"
        "assert F.drive_until(st, 2, 30.0)\n"
        "print([list(p.block_store.get(1).metadata.entries[0])\n"
        "       for p in st.peers], len(st.peers[0].state.keys()))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'grpc'\n"
        "             or m.startswith('google.protobuf')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    flags = [0, 0, 2, 0, 0, 0, 0, 2, 0, 0]
    assert out.stdout.split("\n")[:2] == [f"{[flags, flags]} 8", "[]"]


def test_orderer_nodes_run_with_protobuf_grpc_and_cryptography_blocked():
    """The cluster's handshake, ECDH and AES-256-GCM and the registrar's
    codecs need none of the three: with them unimportable, four nodes
    over loopback TCP order broadcast transactions."""
    code = (
        "import importlib, importlib.abc, sys, time, tempfile\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('grpc', 'cryptography') or \\\n"
        "                name.startswith('google.protobuf'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from bdls_tpu_torch.consensus import CpuBatchVerifier, Signer\n"
        "from bdls_tpu_torch.crypto.sw import SwCSP\n"
        "from bdls_tpu_torch.models.orderer import OrdererNode\n"
        "from bdls_tpu_torch.ordering.registrar import (\n"
        "    make_channel_config, make_genesis)\n"
        "sys.path.insert(0, 'chip_smoke_dir')\n"
        "import chip_smoke as C\n"
        "txs = C.orderer_txs(8, 'blk')\n"
        "tmp = tempfile.mkdtemp()\n"
        "ss = [Signer.from_scalar(0x5100 + i) for i in range(4)]\n"
        "ns = [OrdererNode(s, base_dir=f'{tmp}/n{i}', csp=SwCSP(),\n"
        "                  verifier=CpuBatchVerifier())\n"
        "      for i, s in enumerate(ss)]\n"
        "try:\n"
        "    for a in ns:\n"
        "        for b in ns:\n"
        "            if a is not b:\n"
        "                a.set_endpoint(b.identity, *b.address)\n"
        "    g = make_genesis(make_channel_config(\n"
        "        'blk', [s.identity for s in ss], max_message_count=8,\n"
        "        batch_timeout_s=0.2, writer_orgs=('org1',)))\n"
        "    for n in ns:\n"
        "        n.join_channel(g)\n"
        "        n.start()\n"
        "    end = time.time() + 30\n"
        "    while time.time() < end and not all(\n"
        "            len(n.cluster.connected_peers()) == 3 for n in ns):\n"
        "        time.sleep(0.2)\n"
        "    time.sleep(1.0)\n"
        "    for i, (raw, kind) in enumerate(txs):\n"
        "        ns[i % 4].broadcast(raw)\n"
        "    while time.time() < end and min(\n"
        "            n.channel_height('blk') for n in ns) < 2:\n"
        "        time.sleep(0.1)\n"
        "    print([n.channel_height('blk') for n in ns],\n"
        "          len(list(ns[0].deliver('blk', 1, 1))[0].data.transactions))\n"
        "finally:\n"
        "    for n in ns:\n"
        "        n.stop()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('grpc', 'cryptography') or\n"
        "             m.startswith('google.protobuf')))\n")
    code = code.replace("'chip_smoke_dir'", repr(str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[2, 2, 2, 2] 8", "[]"]


def test_the_default_provider_and_a_node_without_one_need_a_card(
        monkeypatch):
    """``get_default()`` builds the card provider when nothing was
    initialized (the reference's quietly falls back to SW), so an
    ``OrdererNode`` made without a ``csp`` needs a card too."""
    from bdls_tpu_torch.consensus import Signer
    from bdls_tpu_torch.crypto import factory
    from bdls_tpu_torch.crypto.sw import SwCSP
    from bdls_tpu_torch.models.orderer import OrdererNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    factory.reset_default()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            factory.get_default()
        with pytest.raises(RuntimeError, match="CUDA"):
            OrdererNode(Signer.from_scalar(0x5200))
        sw = factory.init_default(factory.FactoryOpts(default="SW"))
        assert isinstance(sw, SwCSP)
        assert factory.get_default() is sw
        assert factory.init_default(factory.FactoryOpts(default="TORCH")) \
            is sw
    finally:
        factory.reset_default()


def _imported(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    return mods


@pytest.mark.parametrize("rel", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + [
        "chip_smoke.py", "tools/torch_verify_group_probe.py",
        "tests/_txflow_workload.py"])
def test_source_imports_nothing_forbidden(rel):
    bad = sorted(m for m in _imported(ROOT / rel) if _forbidden(m))
    assert not bad, (rel, bad)


def test_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import P256
    from bdls_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchCSP()
    with pytest.raises(RuntimeError, match="CUDA"):
        ecdsa.verify_batch(P256, [1], [1], [1], [1], [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_default_provider_pins_keys_like_the_reference():
    from bdls_tpu_torch.crypto.key_cache import DEFAULT_KEY_CACHE_SIZE
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP

    assert DEFAULT_KEY_CACHE_SIZE == 256
    for csp in (TorchCSP(device="cpu"), TorchCSP(device="cpu",
                                                  key_cache_size=256)):
        try:
            assert csp.key_cache is not None
            assert csp.key_cache.capacity == 256
            assert csp.key_cache.device.type == "cpu"
            assert csp.stats["key_cache"]["capacity"] == 256
        finally:
            csp.close()
    off = TorchCSP(device="cpu", key_cache_size=0)
    try:
        assert off.key_cache is None and "key_cache" not in off.stats
        off.warm_keys([])                 # a no-op without a cache
    finally:
        off.close()


def test_pinned_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.consensus.verifier import TorchBatchVerifier
    from bdls_tpu_torch.consensus.identity import SignedEnvelope
    from bdls_tpu_torch.crypto.key_cache import KeyTableCache
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import SECP256K1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KeyTableCache()
    with pytest.raises(RuntimeError, match="CUDA"):
        ecdsa.launch_verify_pinned(SECP256K1, [[[1]]] * 3, [0], {})
    env = SignedEnvelope(1, b"", b"\1" * 32, b"\1" * 32, b"\1", b"\1")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchVerifier().verify_envelopes([env])


def test_block_lane_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import block_verify, sha256
    from bdls_tpu_torch.ops.curves import P256

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sha256.sha256_batch([b"abc"])
    words, nblocks = sha256.pad_messages([b"abc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        sha256.launch_sha256(words, nblocks)
    req = vectors.block_request("P-256", np.random.default_rng(1), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        block_verify.launch_block(P256, block_verify.pack_block_request(req))
    with pytest.raises(RuntimeError, match="CUDA"):
        block_verify.verify_block_fused(req)


def test_vote_lane_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.crypto import vectors
    from bdls_tpu_torch.ops import ecdsa, ed25519
    from bdls_tpu_torch.ops.curves import SECP256K1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lane = vectors.rfc8032_lanes()[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        ed25519.verify_batch([b"\0" * 32], [b"\0" * 64], [b""])
    rows = ed25519.lanes_to_limbs(vectors.ed25519_rows([lane]))
    with pytest.raises(RuntimeError, match="CUDA"):
        ed25519.launch_verify(rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        ecdsa.LatencySlot(SECP256K1, 9)


def test_certificate_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.consensus import threshold
    from bdls_tpu_torch.ops import bls_host, bls_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BDLS_CERT_BACKEND", raising=False)
    arrs = [a for _ in range(4) for a in bls_kernel.pt_batch([bls_host.G1])]
    with pytest.raises(RuntimeError, match="CUDA"):
        bls_kernel.launch_verify(arrs)
    with pytest.raises(RuntimeError, match="CUDA"):
        bls_kernel.verify_limbs(arrs)
    agg = threshold.ThresholdAggregator([bls_host.G1], quorum=1)
    cert = threshold.QuorumCertificate(b"d", (0,), bls_host.G2)
    with pytest.raises(RuntimeError, match="CUDA"):
        bls_kernel.verify_certificates([cert], [agg])
    # the kernel's wrappers launch or raise: never the plain twin
    cpu = [torch.from_numpy(a.view(np.int32)) for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):
        bls_kernel.verify_bls_cuda(*cpu)
    with pytest.raises(ValueError, match="CUDA"):
        bls_kernel.miller_cuda(*cpu[:4])


def test_mesh_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.ops import bls_kernel
    from bdls_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.get_sharded_verify("P-256", "fold", ndev=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.get_pjit_verify_pinned("secp256k1")
    # the kernels' wrappers launch or raise: never the plain twin (the
    # count is the card's shard launch; a CPU launch asked for it raises)
    from bdls_tpu_torch.crypto.marshal import ints_to_limbs
    from bdls_tpu_torch.ops import ecdsa
    from bdls_tpu_torch.ops.curves import P256

    ok = torch.ones(4, dtype=torch.bool)
    arrs = [ints_to_limbs([1, 2, 3, 4])] * 5
    with pytest.raises(ValueError, match="card"):
        ecdsa.launch_verify(P256, arrs, device="cpu", mask=ok)
    n = torch.zeros((12, 12, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bls_kernel.final_full_cuda(n, n)
    with pytest.raises(ValueError, match="CUDA"):
        bls_kernel.verify_bls_full_cuda(*[n[..., :1].contiguous()] * 8)


def test_engine_entry_points_need_a_card_by_default(monkeypatch):
    from bdls_tpu_torch.consensus import Config, Consensus, Signer
    from bdls_tpu_torch.sidecar.verifyd import VerifydServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = Signer.from_scalar(9)
    with pytest.raises(RuntimeError, match="CUDA"):
        Consensus(Config(epoch=0.0, signer=s, participants=[s.identity] * 4,
                         state_compare=lambda a, b: 0,
                         state_validate=lambda x, h: True))
    with pytest.raises(RuntimeError, match="CUDA"):
        VerifydServer(ops_port=None)

"""External (out-of-process) chaincode runtime — the peer side.

Reference parity: ``core/chaincode/`` + ``core/container/`` — contracts
run isolated in their own process with a lifecycle (launch, ready
handshake, invoke round trips, crash restart), not in the peer's
address space. The launcher here is a plain subprocess running
:mod:`bdls_tpu_torch.peer.ccshim` (the reference launches docker/external
builders; the shim protocol shape is the same). An
:class:`ExternalContract` satisfies the in-process ``Contract`` callable
signature, so it registers with the existing Endorser unchanged —
simulation state reads round-trip to the peer (GetState), writes come
back as the write-set.

The port's copy of ``bdls_tpu/peer/ccruntime.py``, whole: the same
frames, the child ``python -S -m bdls_tpu_torch.peer.ccshim``.
"""

from __future__ import annotations

import json
import os
import site
import struct
import subprocess
import sys
import threading
from typing import Callable, Optional


def _shim_env() -> dict:
    """Environment for the shim child.

    A site's ``sitecustomize`` may import heavy packages (seconds) into
    every Python process; the shim is launched with ``-S`` to skip it,
    so interpreter start-up stays in the tens of milliseconds and does
    not eat into the contract's invoke/init watchdog. ``-S`` also drops
    site-packages from ``sys.path``, so re-add it (plus the repo root)
    via ``PYTHONPATH`` for contracts that import third-party libraries.

    Ordering: site-packages entries are APPENDED after the propagated
    ``sys.path`` so a site-packages module can never shadow a stdlib or
    repo module inside contract processes (the parent's resolution
    order is preserved). User-site installs (``pip install --user``)
    are included when enabled. Limitation: ``-S`` skips ``.pth``
    processing, so editable installs relying on import hooks are not
    importable from contracts.
    """
    paths = [p for p in sys.path if p]
    site_paths: list = []
    try:
        site_paths += site.getsitepackages()
    except Exception:
        pass
    try:
        if site.ENABLE_USER_SITE:
            site_paths.append(site.getusersitepackages())
    except Exception:
        pass
    env = dict(os.environ)
    prev = env.get("PYTHONPATH")
    env["PYTHONPATH"] = os.pathsep.join(
        dict.fromkeys(paths + site_paths + ([prev] if prev else [])))
    return env


class ContractRuntimeError(Exception):
    pass


class ExternalContract:
    """A contract hosted in a separate OS process.

    Callable as ``(reader, args) -> writes`` — the Endorser's Contract
    protocol. The child is launched lazily, re-launched after a crash,
    and each invoke is bounded by ``timeout`` seconds.
    """

    def __init__(self, path: str, name: str, timeout: float = 10.0):
        self.path = path
        self.name = name
        self.timeout = timeout
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self.stats = {"launches": 0, "invokes": 0, "crashes": 0}

    # ---- lifecycle (core/container launcher role) -------------------------
    def _launch(self) -> None:
        self._proc = subprocess.Popen(
            [sys.executable, "-S", "-m", "bdls_tpu_torch.peer.ccshim"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            env=_shim_env(),
        )
        self.stats["launches"] += 1
        # the handshake is under the same watchdog as invokes: a contract
        # whose import blocks must not hang the endorser thread forever
        proc = self._proc
        timer = threading.Timer(self.timeout, proc.kill)
        timer.start()
        try:
            self._send({"op": "init", "path": self.path, "name": self.name})
            resp = self._recv()
        except Exception as exc:
            self.close()
            raise ContractRuntimeError(f"contract init hung/crashed: {exc!r}")
        finally:
            timer.cancel()
        if resp.get("op") != "ready":
            err = resp.get("error", "no ready handshake")
            self.close()
            raise ContractRuntimeError(f"contract init failed: {err}")

    def close(self) -> None:
        if self._proc is not None:
            try:
                self._send({"op": "exit"})
            except Exception:
                pass
            self._proc.kill()
            self._proc.wait(timeout=2.0)
            self._proc = None

    def _ensure(self) -> None:
        if self._proc is None or self._proc.poll() is not None:
            if self._proc is not None:
                self.stats["crashes"] += 1
                self._proc = None
            self._launch()

    # ---- framed transport --------------------------------------------------
    def _send(self, obj: dict) -> None:
        payload = json.dumps(obj).encode()
        self._proc.stdin.write(struct.pack("<I", len(payload)) + payload)
        self._proc.stdin.flush()

    def _recv(self) -> dict:
        hdr = self._proc.stdout.read(4)
        if len(hdr) < 4:
            raise ContractRuntimeError("contract process died")
        (n,) = struct.unpack("<I", hdr)
        return json.loads(self._proc.stdout.read(n))

    # ---- the Contract callable ----------------------------------------------
    def __call__(self, read: Callable[[str], Optional[bytes]], args: list):
        with self._lock:
            self._ensure()
            self.stats["invokes"] += 1
            proc = self._proc
            timed_out = []
            timer = threading.Timer(
                self.timeout, lambda: (timed_out.append(1), proc.kill())
            )
            timer.start()
            try:
                self._send({"op": "invoke", "args": [a.hex() for a in args]})
                while True:
                    msg = self._recv()
                    op = msg.get("op")
                    if op == "get":
                        try:
                            value = read(msg["key"])
                        except Exception as exc:
                            # the shim is mid-invoke awaiting a value: the
                            # stream would desynchronize (next invoke's
                            # frames consumed as this one's) — kill it
                            proc.kill()
                            raise ContractRuntimeError(
                                f"state read failed: {exc!r}")
                        self._send({
                            "op": "value",
                            "value": value.hex() if value is not None else None,
                        })
                    elif op == "result":
                        return [
                            (k, bytes.fromhex(v) if v is not None else None)
                            for k, v in msg["writes"]
                        ]
                    elif op == "error":
                        raise ContractRuntimeError(msg["error"])
                    else:
                        raise ContractRuntimeError(f"bad shim message {op!r}")
            except ContractRuntimeError:
                raise
            except Exception as exc:
                # dead pipe / timeout kill: surface as a simulation failure
                raise ContractRuntimeError(f"contract crashed: {exc!r}")
            finally:
                timer.cancel()
                if timed_out:
                    proc.wait(timeout=2.0)
                if proc.poll() is not None:
                    # child is gone (timeout kill or crash): next invoke
                    # relaunches cleanly
                    self.stats["crashes"] += 1
                    self._proc = None

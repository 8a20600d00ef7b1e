"""Versioned snapshots of host G tables and pinned-key pools.

The counterpart of ``bdls_tpu/ops/table_snapshot.py``, in the port's
layouts. Where :mod:`bdls_tpu_torch.ops.aot_cache` stores the built
kernel libraries, this module stores tables that every process
otherwise rebuilds in Python:

- the per-curve G tables of :mod:`bdls_tpu_torch.ops.verify_fold`
  (``g_table_8bit``, family ``"g"``, and ``g32_tables``, family
  ``"g32"``), deterministic per curve, memoized under ``<root>/tables``
  and held bit-identical to a fresh build in tests;
- :class:`~bdls_tpu_torch.crypto.key_cache.KeyTableCache` pools, one
  entry a pinned key in the pool's layout (``(npos, 9, 8)`` int32
  Montgomery words a coordinate), snapshotted by ``snapshot_to`` and
  restored at start-up as one bulk copy to the device instead of a
  rebuild.

Format: one ``.npz`` a snapshot with a ``__meta__`` JSON blob (format
version, payload digest and, for pinned snapshots, each key's curve,
SKI and coordinates). Loads check the digest; pinned loads also check
every key (in range, on the curve, not infinity), every shape, and the
position-0, digit-1 entry against the claimed Q, so a tampered or
corrupted snapshot is rejected, counted through ``on_reject``
(``tpu_aot_cache_rejects_total{reason}``), and never pins a bad key.
Like the reference's, the screen is one against corruption and key
substitution inside the node's trust boundary, not a cryptographic
seal.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import types
import weakref
from typing import Callable, Optional

import numpy as np

SNAPSHOT_VERSION = 1

REJECT_TRUNCATED = "truncated"
REJECT_CORRUPT = "corrupt"
REJECT_BAD_KEY = "bad_key"

# who hears of a host table's reject: each provider that watches a store
# (a host table is loaded once a process, by whichever caller needs it
# first, so no caller can pass a hook of its own)
_listeners: list = []


def add_reject_listener(fn: Callable[[str], None]) -> None:
    """Report every later host-table reject of this process to ``fn``
    (held weakly when it is a bound method)."""
    ref = (weakref.WeakMethod(fn) if isinstance(fn, types.MethodType)
           else (lambda: fn))
    _listeners.append(ref)


def _report_host_reject(reason: str) -> None:
    for ref in list(_listeners):
        fn = ref()
        if fn is None:
            _listeners.remove(ref)
            continue
        try:
            fn(reason)
        except Exception:  # noqa: BLE001 — metrics must not break loads
            pass


def _digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def save_arrays(path: str, arrays: dict[str, np.ndarray],
                meta: Optional[dict] = None) -> str:
    """Write one versioned snapshot atomically (temp file + rename)."""
    meta = dict(meta or {})
    meta["version"] = SNAPSHOT_VERSION
    meta["sha256"] = _digest(arrays)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def _call(on_reject, reason: str) -> None:
    if on_reject is not None:
        try:
            on_reject(reason)
        except Exception:  # noqa: BLE001 — metrics must not break loads
            pass


def load_arrays(path: str,
                on_reject: Optional[Callable[[str], None]] = None
                ) -> Optional[tuple[dict[str, np.ndarray], dict]]:
    """Load and check one snapshot. Returns ``(arrays, meta)`` or None;
    every malformed file is classified and counted, never raised."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            raw_meta = z["__meta__"] if "__meta__" in z.files else None
    except (OSError, ValueError, KeyError, EOFError) as exc:
        # zipfile raises plain OSError subclasses on truncation
        _call(on_reject, REJECT_TRUNCATED if "truncat" in str(exc).lower()
              else REJECT_CORRUPT)
        return None
    except Exception:  # noqa: BLE001 — any other decode failure
        _call(on_reject, REJECT_CORRUPT)
        return None
    if raw_meta is None:
        _call(on_reject, REJECT_CORRUPT)
        return None
    try:
        meta = json.loads(bytes(raw_meta.tobytes()).decode())
    except (ValueError, UnicodeDecodeError):
        _call(on_reject, REJECT_CORRUPT)
        return None
    if (not isinstance(meta, dict) or meta.get("version") != SNAPSHOT_VERSION
            or _digest(arrays) != meta.get("sha256")):
        _call(on_reject, REJECT_CORRUPT)
        return None
    return arrays, meta


# ------------------------------------------------------- host G tables

def _tables_root() -> Optional[str]:
    from bdls_tpu_torch.ops import aot_cache

    root = aot_cache.cache_root()
    return os.path.join(root, "tables") if root else None


def host_table_path(curve_name: str, family: str) -> Optional[str]:
    root = _tables_root()
    if root is None:
        return None
    return os.path.join(root, f"{family}_{curve_name}.npz")


def load_host_tables(curve_name: str, family: str, count: int,
                     shapes: Optional[list[tuple]] = None,
                     ) -> Optional[tuple[np.ndarray, ...]]:
    """Memoized host tables (``family`` ∈ g | g32) from the snapshot
    store; None when the store is off, on a miss, and on a reject (the
    caller rebuilds and saves). A file of the wrong family, curve, count
    or shapes (``shapes``: one per table, uint32) is rejected as
    corrupt. Rejects go to :func:`add_reject_listener`'s listeners."""
    path = host_table_path(curve_name, family)
    if path is None:
        return None
    got = load_arrays(path, on_reject=_report_host_reject)
    if got is None:
        return None
    arrays, meta = got
    tabs = tuple(arrays.get(f"t{i}") for i in range(count))
    if (meta.get("family") != family or meta.get("curve") != curve_name
            or len(arrays) != count or any(t is None for t in tabs)
            or (shapes is not None and any(
                t.shape != tuple(sh) or t.dtype != np.uint32
                for t, sh in zip(tabs, shapes)))):
        _report_host_reject(REJECT_CORRUPT)
        return None
    return tabs


def save_host_tables(curve_name: str, family: str, tabs) -> None:
    """Best-effort save: an unwritable store never fails a build."""
    path = host_table_path(curve_name, family)
    if path is None:
        return
    try:
        save_arrays(path, {f"t{i}": t for i, t in enumerate(tabs)},
                    {"family": family, "curve": curve_name})
    except OSError:
        pass


# ------------------------------------------------------ pinned-key pools

def _ski(x: int, y: int) -> bytes:
    """``PublicKey.ski()``: sha256 of the uncompressed point."""
    try:
        raw = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    except OverflowError:
        return b""
    return hashlib.sha256(raw).digest()


def validate_pinned_entry(curve_name: str, x: int, y: int,
                          tabs: dict[str, np.ndarray]) -> bool:
    """Load-time screen for one snapshotted key in the port's pool
    layout: Q in range, on the curve and not infinity (the checks of
    ``verify_fold.build_pinned_tables``); one ``(npos, 9, 8)`` int32
    array of Montgomery words for each coordinate, shapes exact; and the
    position-0, digit-1 entry equal to Q's encoding, so a substituted
    table cannot claim another key than its metadata."""
    from bdls_tpu_torch.ops import verify_fold as vf
    from bdls_tpu_torch.ops.curves import CURVES

    if curve_name not in CURVES:
        return False
    curve = CURVES[curve_name]
    p = curve.fp.modulus
    if not (0 <= x < p and 0 <= y < p) or (x == 0 and y == 0):
        return False
    if (y * y - (x * x * x + curve.a * x + curve.b)) % p:
        return False
    names = vf.PINNED_COORDS[curve_name]
    if set(tabs) != set(names):
        return False
    shape = (vf.pinned_positions(curve_name), 9, 8)
    if any(tabs[nm].shape != shape or tabs[nm].dtype != np.int32
           for nm in names):
        return False
    want = vf.mont_words(curve_name, [x, y])
    return (np.array_equal(tabs["x"][0][1], want[0])
            and np.array_equal(tabs["y"][0][1], want[1]))


def save_pinned_snapshot(path: str, entries: list[dict]) -> str:
    """``entries``: dicts of curve, ski (bytes), x, y (ints), tabs
    (coordinate name → ``(npos, 9, 8)`` int32 Montgomery words). One
    file, restorable in bulk."""
    arrays: dict[str, np.ndarray] = {}
    meta_entries = []
    for i, e in enumerate(entries):
        for nm, t in e["tabs"].items():
            arrays[f"e{i}:{nm}"] = np.asarray(t)
        meta_entries.append({
            "curve": e["curve"],
            "ski": e["ski"].hex(),
            "x": hex(e["x"]),
            "y": hex(e["y"]),
            "coords": sorted(e["tabs"]),
        })
    return save_arrays(path, arrays, {"kind": "pinned_pools",
                                      "entries": meta_entries})


def load_pinned_snapshot(path: str,
                         on_reject: Optional[Callable[[str], None]] = None
                         ) -> list[dict]:
    """Checked entries of a pinned-pool snapshot; an empty list on a
    reject of the file. An entry that fails :func:`validate_pinned_entry`
    is dropped alone (counted ``bad_key``), its neighbours kept, and so
    is one whose SKI is not its point's."""
    got = load_arrays(path, on_reject=on_reject)
    if got is None:
        return []
    arrays, meta = got
    if meta.get("kind") != "pinned_pools":
        _call(on_reject, REJECT_CORRUPT)
        return []
    out: list[dict] = []
    for i, ent in enumerate(meta.get("entries", [])):
        try:
            curve = ent["curve"]
            ski = bytes.fromhex(ent["ski"])
            x, y = int(ent["x"], 16), int(ent["y"], 16)
            tabs = {nm: arrays[f"e{i}:{nm}"] for nm in ent["coords"]}
        except (KeyError, ValueError, TypeError):
            _call(on_reject, REJECT_CORRUPT)
            continue
        # the SKI must name the claimed point: the reference takes it as
        # written, so a snapshot could file one key's tables under
        # another key's identifier
        if (ski != _ski(x, y)
                or not validate_pinned_entry(curve, x, y, tabs)):
            _call(on_reject, REJECT_BAD_KEY)
            continue
        out.append({"curve": curve, "ski": ski, "x": x, "y": y,
                    "tabs": tabs})
    return out

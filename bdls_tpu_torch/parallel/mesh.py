"""The verify batch split across devices (K10) — the port of
``bdls_tpu/parallel/mesh.py``.

The reference splits a verify batch over a 1-D ``batch`` mesh of chips:
``shard_map`` (or pjit with regex partition rules) gives every chip its
lanes, each chip runs the field's verify program, and the valid count
of the unmasked lanes is a ``psum`` over ICI. Here a :class:`Mesh` is a
tuple of torch devices, which may name one device more than once (so
one card, or the CPU in the tests, holds several shards), and a call:

- gives shard i the lanes [i·L, (i+1)·L) of every limbs-first ``(16,
  B)`` array, a contiguous int32 tensor on its device
  (:func:`shard_batch`); replicated arguments (a pinned pool) are copied
  to each distinct device once a pool snapshot (:func:`replicate`);
- runs each shard on its own CUDA stream, forked from the caller's
  stream of the shard's device, as one launch: the counting build of the
  field's program through :mod:`bdls_tpu_torch.ops.ecdsa`'s launch
  wrappers (K1 under ``fold``, K1 + K5 under ``mxu``, K4 under
  ``mont16``; K2, or K2 + K5, for pinned lanes), whose epilogue
  (``csrc/mesh.cuh:count_epilogue``) writes each block's count of
  valid, real lanes beside the verdicts;
- joins on the caller's stream of the first shard's device, which waits
  for every shard: the verdicts concatenated in shard order, the blocks'
  counts summed (a handful of scalars, plain torch).

The result is ``(ok (B,) bool, n_valid)``, not yet synchronised on the
card. On the CPU (a mesh of CPU devices) each shard runs the plain
twins, one after another, and the count is the epilogue's plain twin,
``(ok & mask).sum()`` (:func:`masked_count`). :data:`LAUNCHES_MESH`
counts the shards launched on the card; a count has no launch of its
own.

``sharded_*`` place arguments by hand; ``pjit_*`` place every argument
through :data:`VERIFY_PARTITION_RULES` (the reference's regexes: first
match wins, an unmatched name raises), whose two placements are
:data:`REPLICATE` and :data:`SPLIT` (the lane axis, the last one). The
two run the same shards and stay differentially equal.

Left out, as JAX plumbing: ``_field_consts`` and
``_pinned_field_consts`` (the port's constants live in its kernels and
the launch wrappers' device tables), ``_named_shardings`` and
``_donate`` (no compiled program to place or donate into).
"""

from __future__ import annotations

import functools
import re
import threading
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from bdls_tpu_torch.ops import _build, ecdsa
from bdls_tpu_torch.ops.curves import CURVES, Curve
from bdls_tpu_torch.utils.device import resolve_device

BATCH_AXIS = "batch"
# the two placements the partition rules give: every shard gets the
# whole argument, or its own lanes of the last (lane) axis
REPLICATE = "replicate"
SPLIT = "split"
LAUNCHES_MESH = {"shards": 0}


def reset_launches() -> None:
    """Set K10's launch counts to 0."""
    with _build.count_lock:
        for k in LAUNCHES_MESH:
            LAUNCHES_MESH[k] = 0


class Mesh:
    """A 1-D mesh: ``devices`` (a shard each, repeats allowed) over the
    ``batch`` axis. On the card each shard has its own CUDA stream."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        self.axis_names = (BATCH_AXIS,)
        self._streams: Optional[list] = None
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def streams(self) -> list:
        """One ``torch.cuda.Stream`` a shard, made on first use."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(d) for d in self.devices]
            return self._streams


class Sharded(list):
    """Per-shard tensors of one argument, in shard order, each on its
    shard's device: what :func:`shard_batch` and :func:`replicate` give,
    and what a program takes in place of a whole array."""


def mesh_devices() -> list[torch.device]:
    """The devices a default mesh spans: every visible CUDA device (none
    without a card)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_device_count() -> int:
    """Shards a default mesh has: the visible CUDA devices, 1 on the CPU
    (callers gate on > 1 and on bucket divisibility before splitting)."""
    return len(mesh_devices()) or 1


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (``None``: :func:`mesh_devices`, which
    raises without a card, as ``resolve_device`` does). A list may name a
    device more than once; all must be CUDA devices or all the CPU."""
    if devices is None:
        devices = mesh_devices()
        if not devices:
            resolve_device("cuda")          # raises: no CUDA device
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if not devs or len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh takes one or more devices of one type, "
                         f"got {devices!r}")
    return Mesh(devs)


# ---- placement --------------------------------------------------------------

def _host_tensor(arr) -> torch.Tensor:
    """A numpy array or tensor as a tensor; uint32 words become int32
    with the same bits (what every C entry takes)."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def shard_batch(mesh: Mesh, arr) -> Sharded:
    """Per-shard lane slices of ``arr`` (a limbs-first ``(16, B)`` array,
    a ``(B,)`` mask or slot vector; numpy or a tensor): shard i gets lanes
    [i·L, (i+1)·L) of the last axis, L = B / the mesh size, as a
    contiguous tensor on its device (copied on that device's current
    stream). A :class:`Sharded` argument passes through, checked."""
    if isinstance(arr, Sharded):
        if len(arr) != mesh.size or any(
                t.device != d for t, d in zip(arr, mesh.devices)):
            raise ValueError("a sharded argument must have one tensor a "
                             "shard, on the shard's device")
        return arr
    t = _host_tensor(arr)
    B = t.shape[-1]
    if B % mesh.size:
        raise ValueError(f"{B} lanes do not split over {mesh.size} shards")
    L = B // mesh.size
    return Sharded(t[..., i * L:(i + 1) * L].contiguous().to(dev)
                   for i, dev in enumerate(mesh.devices))


# copies of a pool tensor on other devices, keyed by the tensor's id and
# dropped with it: a published pool is never written, so a copy always
# holds its snapshot's tables, and never outlives it
_REPLICAS: dict[int, dict[torch.device, torch.Tensor]] = {}
_replica_lock = threading.Lock()


def _replica(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if t.device == dev:
        return t
    key = id(t)
    with _replica_lock:
        copies = _REPLICAS.get(key)
        if copies is None:
            copies = _REPLICAS[key] = {}
            weakref.finalize(t, _REPLICAS.pop, key, None)
        if dev not in copies:
            copies[dev] = t.to(dev)
        return copies[dev]


def replicate(mesh: Mesh, tree) -> Sharded:
    """``tree`` (a tensor, or a dict of them: a pool snapshot) on every
    shard's device: the tensor itself where it already lies, else a copy
    made once a tensor and device."""
    def on(dev):
        if isinstance(tree, dict):
            return {k: _replica(v, dev) for k, v in tree.items()}
        return _replica(_host_tensor(tree), dev)

    return Sharded(on(dev) for dev in mesh.devices)


def place(mesh: Mesh, arg, placement: str) -> Sharded:
    """Place one argument by its :data:`VERIFY_PARTITION_RULES`
    placement."""
    if placement == SPLIT:
        return shard_batch(mesh, arg)
    if placement == REPLICATE:
        return replicate(mesh, arg)
    raise ValueError(f"unknown placement {placement!r}")


# ---- K10's count ------------------------------------------------------------

def masked_count_plain(ok: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The plain twin of the shard kernels' count epilogue: sum(ok &
    mask), int64."""
    return (ok.to(torch.bool) & mask.to(torch.bool)).sum()


def masked_count(ok: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One shard's valid count where the shard ran its plain twin (the
    CPU). On the card the shard's own launch counts (``mask=`` of the
    :mod:`~bdls_tpu_torch.ops.ecdsa` wrappers), so a CUDA tensor
    raises."""
    if ok.device.type == "cuda":
        raise ValueError("on the card a shard's count comes from its "
                         "verify launch")
    return masked_count_plain(ok, mask)


# ---- the shards -------------------------------------------------------------

def shard_verify(curve: Curve, arrs, device: torch.device, field: str,
                 mask=None):
    """One shard's generic verify: the field's program through
    :func:`bdls_tpu_torch.ops.ecdsa.launch_verify`; with ``mask`` (the
    card) its counting build, ``(ok, partial)``."""
    return ecdsa.launch_verify(curve, arrs, device=device, field=field,
                               mask=mask)


def shard_verify_pinned(curve: Curve, arrs_rse, slot, pools: dict,
                        device: torch.device, field: str, mask=None):
    """One shard's pinned-key verify, through
    :func:`bdls_tpu_torch.ops.ecdsa.launch_verify_pinned`; ``mask`` as in
    :func:`shard_verify`."""
    return ecdsa.launch_verify_pinned(curve, arrs_rse, slot, pools,
                                      device=device, field=field, mask=mask)


def _launch_shards(mesh: Mesh, mask: Sharded, split: Sequence[Sharded],
                   body) -> tuple[torch.Tensor, torch.Tensor]:
    """Run every shard, each on its own stream on the card, and join on
    the first device: on the card ``body(i, *split_i, mask=mask_i)`` is
    shard i's one launch, ``(ok, partial)``; on the CPU ``body(i,
    *split_i)`` gives its ``(L,)`` bool verdicts and :func:`masked_count`
    its count. Returns ``(ok (B,) bool, n_valid)``, ``n_valid`` a 0-d
    int64 tensor."""
    first = mesh.devices[0]
    oks, counts = [], []
    if first.type != "cuda":
        for i in range(mesh.size):
            oks.append(body(i, *(a[i] for a in split)))
            counts.append(masked_count(oks[-1], mask[i]))
        return (torch.cat(oks),
                torch.stack(counts).to(torch.int64).sum())
    streams = mesh.streams()
    for i, (dev, st) in enumerate(zip(mesh.devices, streams)):
        # the shard's inputs were copied on its device's current stream
        st.wait_stream(torch.cuda.current_stream(dev))
        ins = [a[i] for a in split] + [mask[i]]
        with torch.cuda.device(dev), torch.cuda.stream(st):
            for t in ins:
                t.record_stream(st)
            ok, partial = body(i, *ins[:-1], mask=mask[i])
        oks.append(ok)
        counts.append(partial)
        with _build.count_lock:
            LAUNCHES_MESH["shards"] += 1
    for dev, st, ok, cnt in zip(mesh.devices, streams, oks, counts):
        cur = torch.cuda.current_stream(dev)
        cur.wait_stream(st)
        ok.record_stream(cur)
        cnt.record_stream(cur)
    with torch.cuda.device(first):
        ok = torch.cat([o.to(first, non_blocking=True) for o in oks])
        n_valid = torch.cat([c.to(first, non_blocking=True)
                             for c in counts]).to(torch.int64).sum()
    return ok, n_valid


def _generic(curve: Curve, mesh: Mesh, field: str, placements=None):
    """The masked generic program: ``fn(mask, qx, qy, r, s, e)``; by
    hand (``placements`` None) or through the rule placements."""
    if field != "mont16":                       # K4 has no fold engine
        ecdsa.engine_for(field, ecdsa.FOLD_FIELDS)

    def fn(mask, qx, qy, r, s, e):
        args = (mask, qx, qy, r, s, e)
        placed = ([shard_batch(mesh, a) for a in args] if placements is None
                  else [place(mesh, a, p) for a, p in zip(args, placements)])
        return _launch_shards(
            mesh, placed[0], placed[1:],
            lambda i, *ts, **kw: shard_verify(curve, ts, mesh.devices[i],
                                              field, **kw))

    fn.mesh, fn.field = mesh, field
    return fn


def _pinned(curve: Curve, mesh: Mesh, field: str, placements=None):
    """The masked pinned program: ``fn(pools, mask, slot, r, s, e)``."""
    ecdsa.engine_for(field, ecdsa.PINNED_FIELDS)

    def fn(pools, mask, slot, r, s, e):
        if placements is None:
            pools_sh = replicate(mesh, pools)
            placed = [shard_batch(mesh, a) for a in (mask, slot, r, s, e)]
        else:
            pools_sh = Sharded({} for _ in mesh.devices)
            for nm, pl in placements[0].items():
                for d, t in zip(pools_sh, place(mesh, pools[nm], pl)):
                    d[nm] = t
            placed = [place(mesh, a, p)
                      for a, p in zip((mask, slot, r, s, e), placements[1:])]

        def body(i, sl, r_, s_, e_, **kw):
            dev = mesh.devices[i]
            if dev.type == "cuda":
                for t in pools_sh[i].values():
                    t.record_stream(torch.cuda.current_stream(dev))
            return shard_verify_pinned(curve, (r_, s_, e_), sl, pools_sh[i],
                                       dev, field, **kw)

        return _launch_shards(mesh, placed[0], placed[1:], body)

    fn.mesh, fn.field = mesh, field
    return fn


def sharded_verify(curve: Curve, mesh: Mesh):
    """A verify over a batch split on ``mesh``: ``fn(qx, qy, r, s, e)``,
    limbs-first ``(16, B)`` with B divisible by the mesh size ->
    ``(ok (B,), n_valid)``, every lane counted. The program is the port's
    default field (``ecdsa.DEFAULT_FIELD``, K1: the reference's default
    is ``mont16``, ROADMAP.md Queue C)."""
    masked = sharded_verify_masked(curve, mesh, field=ecdsa.DEFAULT_FIELD)

    def fn(qx, qy, r, s, e):
        B = (sum(t.shape[-1] for t in qx) if isinstance(qx, Sharded)
             else np.shape(qx)[-1])
        return masked(np.ones(B, dtype=bool), qx, qy, r, s, e)

    fn.mesh, fn.field = mesh, ecdsa.DEFAULT_FIELD
    return fn


def sharded_verify_masked(curve: Curve, mesh: Mesh, field: str = "mont16"):
    """The split verify for padded batches: ``fn(mask, qx, qy, r, s, e)``
    -> ``(ok (B,), n_valid)``, n_valid counting only the lanes ``mask``
    marks real. Each shard runs ``field``'s program (K1, K1 + K5 or K4).
    Arguments are placed by hand."""
    return _generic(curve, mesh, field)


def sharded_verify_pinned(curve: Curve, mesh: Mesh, field: str = "fold"):
    """The split pinned-key verify: ``fn(pools, mask, slot, r16, s16,
    e16)`` -> ``(ok (B,), n_valid)``. The pool snapshot is replicated to
    every shard's device (copied once a snapshot and device), the slots
    and limb arrays split on the lane axis; each shard runs K2 (K2 + K5
    under ``mxu``)."""
    return _pinned(curve, mesh, field)


# ---- the partition-rule path ------------------------------------------------

VERIFY_PARTITION_RULES = (
    # replicated everywhere: pinned table pools (and the reference's
    # constant trees)
    (r"^(consts|pools)", REPLICATE),
    # per-lane vectors: validity mask, pinned slot indices
    (r"^(mask|slot)$", SPLIT),
    # limbs-first (16, B) arrays: split the lane axis
    (r"^(qx|qy|sig_r|sig_s|digest)$", SPLIT),
)


def _name_tree(name: str, tree):
    """Replace each leaf of ``tree`` (nested dicts, lists, tuples) with
    its path string rooted at ``name`` (``consts['p']``-style, as JAX's
    ``keystr``), for rule matching."""
    if isinstance(tree, dict):
        return {k: _name_tree(f"{name}[{k!r}]", v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_name_tree(f"{name}[{i}]", v)
                          for i, v in enumerate(tree))
    return name


def match_partition_rules(rules, names):
    """Map a tree of leaf-path names to placements: the first
    ``re.search`` match wins; no match raises (a new argument must be
    placed deliberately, never defaulted)."""
    if isinstance(names, dict):
        return {k: match_partition_rules(rules, v) for k, v in names.items()}
    if isinstance(names, (list, tuple)):
        return type(names)(match_partition_rules(rules, v) for v in names)
    for pat, placement in rules:
        if re.search(pat, names):
            return placement
    raise ValueError(f"no partition rule matches {names!r}")


def pjit_verify_masked(curve: Curve, mesh: Mesh, field: str = "mont16"):
    """The rule-placed twin of :func:`sharded_verify_masked`: every
    argument is named and placed through :data:`VERIFY_PARTITION_RULES`.
    Same caller signature ``fn(mask, qx, qy, r, s, e)``."""
    names = ("mask", "qx", "qy", "sig_r", "sig_s", "digest")
    return _generic(curve, mesh, field,
                    match_partition_rules(VERIFY_PARTITION_RULES, names))


def pjit_verify_pinned(curve: Curve, mesh: Mesh, field: str = "fold"):
    """The rule-placed twin of :func:`sharded_verify_pinned`; caller
    signature ``fn(pools, mask, slot, r16, s16, e16)``. The pool's
    coordinates are named ``pools['x']`` … as in the reference."""
    from bdls_tpu_torch.ops.verify_fold import PINNED_COORDS

    pools_names = {nm: f"pools[{nm!r}]" for nm in PINNED_COORDS[curve.name]}
    names = (pools_names, "mask", "slot", "sig_r", "sig_s", "digest")
    return _pinned(curve, mesh, field,
                   match_partition_rules(VERIFY_PARTITION_RULES, names))


# ---- the provider's getters -------------------------------------------------

def _devices(ndev: int) -> tuple:
    devs = mesh_devices()
    return tuple(devs[:ndev] if ndev else devs)


@functools.lru_cache(maxsize=None)
def _program(builder, curve_name: str, field: str, ndev: int,
             devices: tuple):
    return builder(CURVES[curve_name], make_mesh(list(devices) or None),
                   field=field)


def get_sharded_verify(curve_name: str, field: str = "mont16",
                       ndev: int = 0):
    """The process-cached masked split verify over the default mesh
    (:func:`mesh_devices`; ``ndev`` > 0 takes the first ``ndev``). The
    key holds the curve, the field, ``ndev`` and the device list, so a
    test (or a check) that stands another device list in gets a fresh
    mesh."""
    return _program(sharded_verify_masked, curve_name, field, ndev,
                    _devices(ndev))


def get_sharded_verify_pinned(curve_name: str, field: str = "fold",
                              ndev: int = 0):
    """The process-cached pinned split verify (see
    :func:`get_sharded_verify`)."""
    return _program(sharded_verify_pinned, curve_name, field, ndev,
                    _devices(ndev))


def get_pjit_verify(curve_name: str, field: str = "mont16", ndev: int = 0):
    """The process-cached rule-placed masked verify (see
    :func:`get_sharded_verify`)."""
    return _program(pjit_verify_masked, curve_name, field, ndev,
                    _devices(ndev))


def get_pjit_verify_pinned(curve_name: str, field: str = "fold",
                           ndev: int = 0):
    """The process-cached rule-placed pinned verify (see
    :func:`get_sharded_verify`)."""
    return _program(pjit_verify_pinned, curve_name, field, ndev,
                    _devices(ndev))


def pad_and_mask(arrs, n_real: int, total: int):
    """Pad five (16, n) limb arrays to ``total`` lanes with zero lanes
    (structurally invalid signatures) and build the validity mask."""
    out = []
    for a in arrs:
        pad = np.zeros((a.shape[0], total - a.shape[1]), dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=1))
    mask = np.arange(total) < n_real
    return tuple(out), mask

"""The PyTorch/CUDA crypto provider — ``TpuCSP``'s counterpart on the H100.

The port of ``bdls_tpu/crypto/tpu_provider.py:TpuCSP`` with its device
programs: the generic verify (K1), the pinned-key verify (K2), the
latency tier's captured form of K1 (K3), the gen-1 ``mont16`` verify
(K4), the tensor-core limb product (K5, inside the mxu builds of K1, K2,
K7 and K8), the fused block program (K7, SHA-256 → verify → policy
tally behind :meth:`TorchCSP.verify_block`), the Ed25519 verify (K8),
the BLS12-381 certificate check (K9 and its full-exponent final
exponentiation K11, behind :meth:`TorchCSP.verify_certificates`) and the
batch split across devices (K10, :mod:`bdls_tpu_torch.parallel.mesh`).
It keeps the reference's dispatcher:

- **kernel field** — ``kernel_field=`` (or ``BDLS_TPU_KERNEL``; an
  unknown value there gives ``"fold"``, an unknown argument raises)
  picks the kernel generation, as the reference's does:

  ============  ==========  ==========================  ======  =======  ==============
  field         generic     latency (<= max lanes)      pinned  Ed25519  ``verify_block``
  ============  ==========  ==========================  ======  =======  ==============
  ``fold``      K1          K3 (K1's graph)             K2      K8       K7
  ``mont16``    K4          a counted cold fallback,    K2      K8       K7
                            then K4 eagerly
  ``mxu``       K1 + K5     K3 over K1 + K5             K2+K5   K8+K5    K7 + K5
  ``sw``        the pure-Python ``SwCSP`` (host path), for every kind;
                ``verify_block`` answers through ``verify_block_host``,
                not counted as a fallback
  ============  ==========  ==========================  ======  =======  ==============

  ``verify_certificates`` (K9) does not read it. Metric labels
  (``kernel``), span attributes and ``stats["kernel"]`` carry the field;
  :attr:`TorchCSP.kernel` says whether a launch runs the CUDA kernel or
  the plain twin;

- **accumulator with deadline-or-size flush** — :meth:`TorchCSP.submit`
  enqueues a request and returns a future; a background flusher
  launches when ``max_pending`` requests wait or the oldest has waited
  ``flush_interval``; :meth:`TorchCSP.verify_batch` is the synchronous
  form of the same path;
- **host screen** — the low-S policy for P-256 (``bccsp/sw``), the
  256-bit range of every field and oversized digests, before padding;
- **pinned-key partition** — with ``key_cache_size`` > 0 (``None``, the
  default, reads ``BDLS_TPU_KEY_CACHE_SIZE``: 256 when unset, a bad value
  256, a negative one 0, as the reference) each curve's group splits
  into cache-hit
  lanes, which run the pinned-key kernel over the
  :class:`~bdls_tpu_torch.crypto.key_cache.KeyTableCache` pool, and miss
  lanes, which run the generic kernel; a miss schedules a background
  table build, so the next flush hits. :meth:`TorchCSP.warm_keys`
  (and ``warmup(keys=...)``) pins a known key set ahead of time;
- **mesh** — a generic or pinned bucket of at least ``mesh_threshold``
  lanes (``BDLS_TPU_MESH_THRESHOLD``, 2048 by default; 0 turns the mesh
  off) splits across the devices of
  :func:`bdls_tpu_torch.parallel.mesh.mesh_devices` when there is more
  than one and the bucket divides among them (K10): each shard runs the
  field's program on its own stream, and the mask ``arange(size) <
  len(reqs)`` keeps padded lanes out of the count. ``shard_mode`` (or
  ``BDLS_TPU_SHARD_MODE``: ``"pjit"``, the default, places arguments by
  the partition rules, ``"shard_map"`` by hand; an unknown value there
  gives ``"pjit"``, an unknown argument raises) picks the program. On
  the card each shard is staged from one page-locked buffer and the
  joined verdict read back behind an event, as a single launch is.
  Ed25519 and the latency tier never reach the mesh;
- **padded buckets** — per-curve groups padded (by replicating lane 0,
  slot included) to ``DEFAULT_BUCKETS`` plus the opt-in vote buckets
  (``vote_buckets=`` or ``BDLS_TPU_VOTE_BUCKETS``: the 2t+1 quorums
  ``VOTE_BUCKETS``); groups above the largest bucket split into
  max-bucket chunks, each its own launch;
- **latency tier** — unpinned buckets up to ``latency_max_lanes``
  (``BDLS_TPU_LATENCY_MAX_LANES``, 256 by default) are tagged
  ``latency`` (their submit-to-verdict time lands on
  ``tpu_vote_rtt_seconds``), the rest and every pinned group
  ``throughput``. :meth:`TorchCSP.warmup` gives every latency-eligible
  (curve, bucket) a ring of at least two
  :class:`~bdls_tpu_torch.ops.ecdsa.LatencySlot` (K3: on the card a
  captured CUDA graph of staging copy → K1 → verdict copy). A generic
  latency group takes a free slot under the provider's lock, stages
  into it and replays; the drainer gives the slot back only after that
  launch's event completed and its verdict was read, so a slot is never
  refilled while a launch may still read it. A group whose bucket has no
  ring counts ``tpu_latency_cold_fallbacks_total`` and launches K1
  eagerly; a group that finds every slot busy launches K1 eagerly from
  its own staging buffer and counts nothing. Ed25519 groups carry the
  tag but launch K8; pinned groups never take K3;
- **speculative flush** — :meth:`TorchCSP.set_quorum_hint` (set by
  ``CspBatchVerifier`` to the committee's 2t+1) arms the flusher: once
  that many requests are pending it launches at once instead of waiting
  out ``flush_interval`` (``tpu_dispatch_speculative_flushes_total``);
- **Ed25519** — curve ``"ed25519"`` groups skip the key cache and run
  K8 (:mod:`bdls_tpu_torch.ops.ed25519`). The host screen is the
  reference's, the ECDSA digest rule included: a request whose digest
  (for Ed25519, the whole message) is longer than 32 bytes with a
  nonzero byte before the last 32 is rejected, as ``TpuCSP`` rejects it
  (ROADMAP.md, Queue C);
- **async launch** — on the card each launch copies its marshaled limbs
  to the device on the provider's own CUDA stream, launches the verify
  kernel (:func:`bdls_tpu_torch.ops.ecdsa.launch_verify` or
  :func:`~bdls_tpu_torch.ops.ecdsa.launch_verify_pinned`), copies the
  verdict back into page-locked memory and records a CUDA event; a
  drainer thread waits on the event and resolves the futures, so the
  flush thread marshals batch N+1 while batch N runs. A pinned launch
  keeps the pool snapshot it looked its slots up in until its verdict
  is back;
- **no fallback on the card** — on a CUDA device a launch or in-flight
  failure fails that batch's futures, and a kernel that does not build
  raises from the constructor (or from :meth:`TorchCSP.warmup`). The
  counted fallback of the reference (``use_cpu_fallback``: re-verify
  the batch on the pure-Python ``sw`` provider and count
  ``tpu_verify_fallbacks_total``) exists only for ``device="cpu"``;
  asking for it on the card raises.
- **block lane** — :meth:`TorchCSP.verify_block` runs a whole block's
  endorsements as one K7 launch (the plain twin on the CPU), returning
  per-tx flags. A request beyond the largest bucket answers through the
  host reference path (``blocklane.verify_block_host`` over
  :meth:`TorchCSP.verify_batch`) and counts
  ``tpu_block_fallbacks_total``, as the reference does; a build or
  launch error raises.

- **bounded accumulator** — ``pending_cap`` > 0 bounds :meth:`TorchCSP.submit`'s
  queue, as the reference's: ``pending_policy="reject"`` raises
  :class:`AccumulatorSaturated` at once, ``"block"`` (the default) parks
  the submitter until a flush drains room and raises after
  ``dispatch_timeout``; 0 (the default) leaves it unbounded;
- **warm-up** — :meth:`TorchCSP.warmup` warms each (curve, bucket) once
  behind its compile lock, so a racing second warm-up counts a
  ``warmed`` cache hit, and an eager first launch of a bucket not yet
  warmed waits for that lock;
- **cold start** — with ``BDLS_TPU_AOT_CACHE`` set, the kernel libraries
  come from the store of :mod:`bdls_tpu_torch.ops.aot_cache` (a process
  without nvcc loads them; a rejected entry is rebuilt with nvcc, or
  raises without it), the G tables from the snapshot store, and
  ``key_cache.snapshot_to``/``restore_from`` carry the pinned keys
  across a restart. ``tpu_compile_cache_hits_total{kind="persistent"}``
  counts the libraries this provider loaded from the store,
  ``tpu_compile_seconds``/``tpu_compile_programs_total`` (``kernel`` the
  build key, e.g. ``verify.cu:mxu``) the nvcc builds it ran, and
  ``tpu_aot_cache_rejects_total{reason}`` every rejected entry;
- **chaos seam** — ``chaos_stall_s`` > 0 makes the drainer read each
  launch's verdict that many seconds late (the reference's
  ``device.stall`` fault), while the flush thread keeps launching;
- **profile capture** — with ``BDLS_TPU_PROFILE_DIR`` set, one dispatch
  (or ``verify_block``) at a time runs under ``torch.profiler`` and
  writes a Chrome trace there (``tpu_profile_captures_total``); on the
  card the capture synchronises the provider's stream before it stops,
  so the kernels' records are in the trace.

Instrument and span names are the reference's (``tpu_verify_*``,
``tpu.marshal``, ``tpu.kernel`` …), so its SLO and incident judges read
the port unchanged.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bdls_tpu_torch.crypto import blocklane, marshal
from bdls_tpu_torch.crypto.csp import CSP, DEFAULT_VOTE_CLASS_MAX_LANES, \
    PublicKey, VerifyRequest, WireVerifyRequest
from bdls_tpu_torch.crypto.key_cache import DEFAULT_KEY_CACHE_SIZE, \
    KeyTableCache
from bdls_tpu_torch.crypto.sw import LOW_S_CURVES, SwCSP, is_low_s
from bdls_tpu_torch.ops import _build, aot_cache, bls_kernel, \
    block_verify, ecdsa, table_snapshot
from bdls_tpu_torch.ops import ed25519 as ed_ops
from bdls_tpu_torch.ops.curves import CURVES, EDWARDS_CURVES
from bdls_tpu_torch.parallel import mesh as pmesh
from bdls_tpu_torch.utils import tracing
from bdls_tpu_torch.utils.device import DeviceLike, resolve_device
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider

DEFAULT_BUCKETS = (8, 32, 128, 512, 2048, 8192)
# the kernel generations (the reference's KERNEL_FIELDS)
KERNEL_FIELDS = ("fold", "mxu", "mont16", "sw")
WARMUP_CURVES = ("P-256", "secp256k1")
# vote-shaped bucket sizes: 2t+1 quorums at n in {13, 49, 128, 256}
# validators — opt-in via BDLS_TPU_VOTE_BUCKETS so quorum batches stop
# padding to the next power-of-two bucket
VOTE_BUCKETS = (9, 33, 85, 171)
# buckets at/below this lane count are latency-tier (the vote-class
# bound shared with the reference's coalescer, crypto/csp.py)
DEFAULT_LATENCY_MAX_LANES = DEFAULT_VOTE_CLASS_MAX_LANES
# K3 slots per latency-eligible (curve, bucket): two, so one flush can
# stage while the previous launch of the same shape is in flight
RING_SLOTS = 2
# buckets of at least this many lanes split across the mesh (K10) when
# more than one device is attached
DEFAULT_MESH_THRESHOLD = 2048
# how a split bucket's program places its arguments (the reference's
# names): by the partition rules, or by hand
SHARD_MODES = ("pjit", "shard_map")


def default_kernel_field() -> str:
    """The process default kernel generation: ``fold`` unless
    ``BDLS_TPU_KERNEL`` names another of :data:`KERNEL_FIELDS` (an
    unknown value gives ``fold``)."""
    field = os.environ.get("BDLS_TPU_KERNEL", "fold")
    return field if field in KERNEL_FIELDS else "fold"


def default_mesh_threshold() -> int:
    """The smallest bucket the mesh takes (``BDLS_TPU_MESH_THRESHOLD``;
    :data:`DEFAULT_MESH_THRESHOLD` when unset or not an integer); 0
    turns the mesh off."""
    try:
        return int(os.environ.get(
            "BDLS_TPU_MESH_THRESHOLD", DEFAULT_MESH_THRESHOLD))
    except ValueError:
        return DEFAULT_MESH_THRESHOLD


def default_shard_mode() -> str:
    """How split buckets place their arguments (``BDLS_TPU_SHARD_MODE``):
    ``pjit`` (the default) through the partition rules of
    :mod:`bdls_tpu_torch.parallel.mesh`, ``shard_map`` by hand; an
    unknown value gives ``pjit``. The two are differentially equal."""
    mode = os.environ.get("BDLS_TPU_SHARD_MODE", "pjit")
    return mode if mode in SHARD_MODES else "pjit"


def default_key_cache_size() -> int:
    """Pinned-key cache capacity (keys per curve) from
    ``BDLS_TPU_KEY_CACHE_SIZE``: 256 when unset or not an integer, a
    negative value 0; 0 disables pinning."""
    try:
        return max(0, int(os.environ.get(
            "BDLS_TPU_KEY_CACHE_SIZE", DEFAULT_KEY_CACHE_SIZE)))
    except ValueError:
        return DEFAULT_KEY_CACHE_SIZE


def default_vote_buckets() -> tuple[int, ...]:
    """Opt-in vote-shaped bucket sizes (``BDLS_TPU_VOTE_BUCKETS``):
    unset/``0``/``off`` disables, ``1``/``on``/``default`` selects
    :data:`VOTE_BUCKETS`, a comma list pins explicit sizes."""
    raw = os.environ.get("BDLS_TPU_VOTE_BUCKETS", "").strip().lower()
    if raw in ("", "0", "off", "false", "no"):
        return ()
    if raw in ("1", "on", "true", "default"):
        return VOTE_BUCKETS
    try:
        vals = tuple(sorted({int(v) for v in raw.split(",") if v.strip()}))
    except ValueError:
        return VOTE_BUCKETS
    return tuple(v for v in vals if v > 0) or VOTE_BUCKETS


def default_latency_max_lanes() -> int:
    """Largest bucket the latency tier serves; 0 disables the tier."""
    try:
        return max(0, int(os.environ.get(
            "BDLS_TPU_LATENCY_MAX_LANES", DEFAULT_LATENCY_MAX_LANES)))
    except ValueError:
        return DEFAULT_LATENCY_MAX_LANES


def block_lane_screen(curve: str):
    """The host lane screen :meth:`TorchCSP.verify_block` packs with: the
    wire screen, plus the low-S policy on ``LOW_S_CURVES`` (``None``
    means the packer's default, the wire screen alone). A lane it rejects
    packs as filler and never hits."""
    if curve not in LOW_S_CURVES:
        return None

    def lane_ok(ln) -> bool:
        return (blocklane.lane_screened(ln)
                and is_low_s(curve, int.from_bytes(ln.s, "big")))

    return lane_ok


class _Launch:
    """One in-flight kernel launch riding the async dispatch pipeline."""

    __slots__ = ("curve", "size", "n", "dev", "reqs", "futs", "parent",
                 "t_launch", "tier", "t_submit")

    def __init__(self, curve, size, n, dev, reqs, futs, parent,
                 tier="throughput", t_submit=None):
        self.curve = curve
        self.size = size
        self.n = n
        self.dev = dev          # _Inflight (card) or bool tensor (CPU),
        #                         either maybe in a _Stalled
        self.reqs = reqs
        self.futs = futs
        self.parent = parent    # SpanContext of the dispatching span
        self.t_launch = time.perf_counter()
        self.tier = tier        # "latency" or "throughput"
        self.t_submit = self.t_launch if t_submit is None else t_submit


class AccumulatorSaturated(Exception):
    """The bounded pending queue is full and the policy is ``reject``
    (or a ``block`` wait ran out of ``dispatch_timeout``): the caller
    should apply its own backpressure instead of buffering more."""


class _Stalled:
    """A launch handle whose verdict the drainer reads ``stall_s`` late
    (:func:`_stalled_handle`)."""

    __slots__ = ("dev", "stall_s")

    def __init__(self, dev, stall_s: float):
        self.dev = dev
        self.stall_s = stall_s


def _stalled_handle(dev, stall_s: float) -> _Stalled:
    """Chaos: wrap an in-flight launch handle so that its verdict is read
    ``stall_s`` seconds late. The sleep runs in the drainer, below the
    dispatcher, never in the flush thread: launches keep pipelining
    while the device lags, as a slow card's would."""
    return _Stalled(dev, stall_s)


class _Inflight:
    """A launch in flight: the verdict buffer (page-locked on the card),
    the event recorded after its copy (None on the CPU), the host limbs
    the copy reads from, for a pinned launch the pool snapshot its slots
    index (held until the verdict is back, so no re-pin can free or
    change what it reads), and for a K3 launch its ring slot (given back
    by the drainer once the verdict is read)."""

    __slots__ = ("out", "event", "staged", "pools", "slot")

    def __init__(self, out, event, staged, pools=None, slot=None):
        self.out = out
        self.event = event
        self.staged = staged
        self.pools = pools
        self.slot = slot

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        out = self.out.numpy()
        # a slot's buffer is refilled by its next launch: copy it out
        return out.copy() if self.slot is not None else out


class TorchCSP(CSP):
    """Batched-verify CSP on the card. Key management, hashing and
    signing delegate to the ``sw`` provider; only Verify is offloaded."""

    def __init__(
        self,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        flush_interval: float = 0.002,
        max_pending: int = 8192,
        use_cpu_fallback: bool = False,
        metrics: Optional[MetricsProvider] = None,
        tracer: Optional[tracing.Tracer] = None,
        device: DeviceLike = None,
        dispatch_timeout: float = 600.0,
        key_cache_size: Optional[int] = None,
        vote_buckets: Optional[Sequence[int]] = None,
        latency_max_lanes: Optional[int] = None,
        kernel_field: Optional[str] = None,
        mesh_threshold: Optional[int] = None,
        shard_mode: Optional[str] = None,
        pending_cap: int = 0,
        pending_policy: str = "block",
    ):
        if pending_policy not in ("block", "reject"):
            raise ValueError(f"unknown pending policy {pending_policy!r}")
        self.kernel_field = kernel_field or default_kernel_field()
        if self.kernel_field not in KERNEL_FIELDS:
            raise ValueError(f"unknown kernel field: {self.kernel_field}")
        self.mesh_threshold = (default_mesh_threshold()
                               if mesh_threshold is None else mesh_threshold)
        self.shard_mode = shard_mode or default_shard_mode()
        if self.shard_mode not in SHARD_MODES:
            raise ValueError(f"unknown shard mode: {self.shard_mode}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and use_cpu_fallback:
            raise ValueError(
                "use_cpu_fallback is for device='cpu' only: on the card a "
                "failed launch fails its futures")
        self._sw = SwCSP()
        # pinned-key table cache: every flushed group partitions into
        # cache-hit lanes (pinned kernel) and miss lanes (generic
        # kernel); 0 disables partitioning entirely, and so does "sw"
        cache_size = (default_key_cache_size() if key_cache_size is None
                      else max(0, int(key_cache_size)))
        self.key_cache = (KeyTableCache(cache_size, self.device)
                          if cache_size > 0 else None)
        vb = (default_vote_buckets() if vote_buckets is None
              else tuple(int(v) for v in vote_buckets if int(v) > 0))
        self.vote_buckets = tuple(sorted(set(vb)))
        self.buckets = tuple(sorted(set(int(b) for b in buckets)
                                    | set(self.vote_buckets)))
        self.latency_max_lanes = (
            default_latency_max_lanes() if latency_max_lanes is None
            else max(0, int(latency_max_lanes)))
        self.flush_interval = flush_interval
        self.max_pending = max_pending
        self.use_cpu_fallback = use_cpu_fallback
        self.dispatch_timeout = dispatch_timeout
        self.pending_cap = max(0, int(pending_cap))
        self.pending_policy = pending_policy
        # a Condition, so capped submitters can park until a flush
        # drains room; `with self._lock:` sections are unchanged
        self._lock = threading.Condition(threading.Lock())
        # per-(curve, bucket) locks: one warm-up of a pair at a time, and
        # an eager first launch of a pair waits for its warm-up
        self._compile_locks: dict[tuple[str, int], threading.Lock] = {}
        # chaos seam (bdls_tpu/chaos device.stall): the drainer reads each
        # launch's verdict this many seconds late
        self.chaos_stall_s = 0.0
        # opt-in profiling: one dispatch at a time under torch.profiler
        self._profile_dir = os.environ.get("BDLS_TPU_PROFILE_DIR") or None
        self._profile_lock = threading.Lock()
        self._pending: list[tuple[VerifyRequest, "_Future", float]] = []
        self._runner: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._inflight: "queue.Queue[Optional[_Launch]]" = queue.Queue()
        self._inflight_n = 0
        self._max_inflight = 0
        self._drainer: Optional[threading.Thread] = None
        self._warmed: set[tuple[str, int]] = set()
        # latency tier: submit() arms _speculative at quorum occupancy;
        # _rings holds each latency-eligible (curve, bucket)'s K3 slots
        # and _ring_free the ones no launch holds
        self.quorum_lanes = 0
        self._speculative = False
        self._rings: dict[tuple[str, int], list] = {}
        self._ring_free: dict[tuple[str, int], list] = {}
        self._ring_allocs = 0
        self._ring_reuses = 0
        self.metrics = metrics or MetricsProvider()
        self.tracer = tracer or tracing.GLOBAL
        self._c_batches = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="verify", name="batches_total",
            help="Kernel launches (one per curve/bucket group)."))
        self._c_verified = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="verify", name="requests_total",
            help="Signature-verify requests processed."))
        self._c_fallbacks = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="verify", name="fallbacks_total",
            help="Batches re-verified on the CPU sw provider."))
        self._c_padded = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="verify", name="padded_lanes_total",
            help="Wasted lanes added to reach a bucket size."))
        self._h_queue_wait = self.metrics.new_histogram(MetricOpts(
            namespace="tpu", subsystem="verify", name="queue_wait_seconds",
            help="Time requests spent in the accumulator before a flush."))
        self._h_marshal = self.metrics.new_histogram(MetricOpts(
            namespace="tpu", subsystem="verify", name="marshal_seconds",
            help="Host numpy marshal+pad time per kernel launch."))
        self._g_inflight = self.metrics.new_gauge(MetricOpts(
            namespace="tpu", subsystem="dispatch", name="inflight_batches",
            help="Kernel launches currently in flight (pipeline depth)."))
        self._g_compile = self.metrics.new_gauge(MetricOpts(
            namespace="tpu", subsystem="compile", name="seconds",
            label_names=("kernel", "curve", "bucket"),
            help="Last warmup (first launch) wall seconds per "
                 "(kernel, curve, bucket), and nvcc wall seconds per "
                 "library build (kernel = the build, e.g. verify.cu:mxu; "
                 "curve and bucket empty)."))
        self._c_compile = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="compile", name="programs_total",
            label_names=("kernel", "curve", "bucket"),
            help="Warmup launches performed per (kernel, curve, bucket), "
                 "and nvcc library builds this provider ran."))
        self._c_compile_cache = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="compile", name="cache_hits_total",
            label_names=("kind",),
            help="Work skipped: kind=warmed (a warm-up of a pair already "
                 "warmed by this provider) or kind=persistent (a library "
                 "loaded from the on-disk store, BDLS_TPU_AOT_CACHE)."))
        self._c_aot_rejects = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="aot_cache", name="rejects_total",
            label_names=("reason",),
            help="Store and snapshot entries rejected at load (truncated "
                 "| fingerprint | corrupt | bad_key); each reject is a "
                 "rebuild with nvcc or of the table."))
        self._c_profiles = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="profile", name="captures_total",
            help="Dispatches captured under torch.profiler "
                 "(BDLS_TPU_PROFILE_DIR)."))
        self._h_vote_rtt = self.metrics.new_histogram(MetricOpts(
            namespace="tpu", subsystem="vote", name="rtt_seconds",
            help="Submit-to-verdict wall time for latency-tier "
                 "(vote-lane) launches."))
        self._c_spec = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="dispatch",
            name="speculative_flushes_total",
            help="Flushes launched at quorum-size occupancy instead of "
                 "waiting out the deadline."))
        self._c_lat_launch = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="latency", name="launches_total",
            help="Launches through a latency-tier slot (K3: a captured "
                 "CUDA graph on the card)."))
        self._c_lat_cold = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="latency",
            name="cold_fallbacks_total",
            help="Latency-tier launches served by the eager generic "
                 "kernel because their bucket had no captured slots."))
        self._c_pinned = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="verify", name="pinned_lanes_total",
            help="Lanes verified through the pinned-key kernel."))
        self._g_cache_keys = self.metrics.new_gauge(MetricOpts(
            namespace="tpu", subsystem="key_cache", name="keys",
            help="Public keys resident in the pinned-table cache."))
        self._c_cache_hits = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="key_cache", name="hits_total",
            help="Dispatch-path key-cache lookups that found resident "
                 "tables."))
        self._c_cache_lookups = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="key_cache", name="lookups_total",
            help="Dispatch-path key-cache lookups (hits + misses)."))
        # block-lane instruments, the reference's names
        self._h_block_rtt = self.metrics.new_histogram(MetricOpts(
            namespace="tpu", subsystem="block", name="rtt_seconds",
            help="Submit-to-flags wall time for fused block-pipeline "
                 "verifications (hash → verify → policy, one program)."))
        self._c_block_blocks = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="block", name="blocks_total",
            help="Whole-block requests answered by verify_block."))
        self._c_block_lanes = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="block", name="lanes_total",
            help="Endorsement lanes carried by block requests."))
        self._c_block_fallbacks = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="block", name="fallbacks_total",
            help="Block requests beyond the largest bucket, answered by "
                 "the host reference path (hash-on-host + verify_batch + "
                 "Python policy)."))
        # the certificate (pairing) lane
        self._c_certs = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="certs", name="certificates_total",
            help="Quorum certificates answered by verify_certificates."))
        self._c_cert_host = self.metrics.new_counter(MetricOpts(
            namespace="tpu", subsystem="certs", name="host_total",
            help="Certificates answered by the host oracle (backend "
                 "\"host\", asked for by the caller or "
                 "BDLS_CERT_BACKEND)."))
        # the persistent warmth plane: with BDLS_TPU_AOT_CACHE set, the
        # libraries come from the store and the host tables from its
        # snapshots, their rejects counted here; unset, _aot_store is
        # None and nothing changes
        self._aot_store = aot_cache.from_env(on_reject=self._count_reject)
        if self._aot_store is not None:
            table_snapshot.add_reject_listener(self._count_reject)
        # the library build this provider triggered (_build.build's
        # report), None when it triggered none
        self.build_report: Optional[dict] = None
        self._stream = None
        if self.device.type == "cuda":
            if self.kernel_field != "sw":
                # build (or load) now: a broken kernel raises
                self.build_report = _build.load(store=self._aot_store)
                self._count_build(self.build_report)
            self._stream = torch.cuda.Stream(self.device)

    def _count_reject(self, reason: str) -> None:
        """The ``on_reject`` hook of the store and the snapshots."""
        self._c_aot_rejects.add(1.0, (reason,))

    def _count_build(self, info: Optional[dict]) -> None:
        """Count what a library build this provider triggered did: each
        library from the store a ``persistent`` hit, each nvcc run a
        program with its seconds (``None``: bound already, nothing)."""
        if info is None:
            return
        if info["from_store"]:
            self._c_compile_cache.add(float(len(info["from_store"])),
                                      ("persistent",))
        for key, secs in info["nvcc_seconds"].items():
            labels = (key, "", "")
            self._g_compile.set(round(secs, 3), labels)
            self._c_compile.add(1.0, labels)

    @property
    def kernel(self) -> str:
        """What runs a launch: the CUDA kernel or the plain version."""
        return "cuda" if self.device.type == "cuda" else "plain"

    @property
    def stats(self) -> dict:
        out = {
            "batches": int(self._c_batches.value()),
            "verified": int(self._c_verified.value()),
            "fallbacks": int(self._c_fallbacks.value()),
            "padded": int(self._c_padded.value()),
            "pinned_lanes": int(self._c_pinned.value()),
            "inflight": self._inflight_n,
            "max_inflight": self._max_inflight,
            "kernel": self.kernel_field,
            "runs": self.kernel,
            "device": str(self.device),
            "warmed": len(self._warmed),
            "speculative_flushes": int(self._c_spec.value()),
            "latency_launches": int(self._c_lat_launch.value()),
            "latency_cold_fallbacks": int(self._c_lat_cold.value()),
            "donation_allocs": self._ring_allocs,
            "donation_reuses": self._ring_reuses,
            "quorum_lanes": self.quorum_lanes,
            "latency_max_lanes": self.latency_max_lanes,
            "vote_buckets": list(self.vote_buckets),
        }
        if self.key_cache is not None:
            out["key_cache"] = self.key_cache.stats
        return out

    # ---- delegation ------------------------------------------------------
    def key_gen(self, curve: str, rng=None):
        return self._sw.key_gen(curve, rng)

    def key_from_scalar(self, curve: str, d: int):
        return self._sw.key_from_scalar(curve, d)

    def key_import(self, curve: str, x: int, y: int) -> PublicKey:
        return self._sw.key_import(curve, x, y)

    def hash(self, data: bytes, algo: str = "sha256") -> bytes:
        return self._sw.hash(data, algo)

    def sign(self, key_handle, digest: bytes):
        return self._sw.sign(key_handle, digest)

    # ---- warmup ----------------------------------------------------------
    def warmup(self, pairs: Optional[Sequence[tuple[str, int]]] = None,
               strict: bool = True,
               keys: Optional[Sequence[PublicKey]] = None) -> None:
        """Launch every (curve, bucket) once, through the generic kernel
        and (with the key cache on) the pinned-key kernel, so no
        production flush pays first-launch cost (module load, allocator
        growth), and give every latency-eligible bucket its ring of K3
        slots (captured graphs on the card, each replayed once).
        ``("ed25519", bucket)`` pairs launch K8. ``pairs`` defaults to
        every bucket of both ECDSA curves. ``keys`` (e.g. the channel's
        consenters) are pinned in the background. A failure raises;
        ``strict=False`` swallows it (the warm-up is then best
        effort)."""
        if keys:
            self.warm_keys(keys, wait=False)
        if pairs is None:
            pairs = [(c, b) for c in WARMUP_CURVES for b in self.buckets]
        already = sum(1 for p in pairs if p in self._warmed)
        if already:
            self._c_compile_cache.add(already, ("warmed",))
        for curve, bucket in pairs:
            if (curve, bucket) in self._warmed:
                continue
            try:
                self._warm_one(curve, bucket)
            except Exception:
                if strict:
                    raise

    def _compile_lock(self, curve: str, bucket: int) -> threading.Lock:
        key = (curve, bucket)
        with self._lock:
            lock = self._compile_locks.get(key)
            if lock is None:
                lock = self._compile_locks[key] = threading.Lock()
            return lock

    def _warm_one(self, curve: str, bucket: int) -> None:
        """Warm one (curve, bucket) behind its compile lock: a second
        thread that warms the same pair waits, then finds it warmed and
        counts a ``warmed`` cache hit instead of warming it again."""
        with self._compile_lock(curve, bucket):
            if (curve, bucket) in self._warmed:
                self._c_compile_cache.add(1.0, ("warmed",))
                return
            self._warm_one_locked(curve, bucket)

    def _warm_one_locked(self, curve: str, bucket: int) -> None:
        t0 = time.perf_counter()
        with self.tracer.span("tpu.warmup", attrs={
                "curve": curve, "bucket": bucket,
                "kernel": self.kernel_field}):
            req = VerifyRequest(key=PublicKey(curve, 1, 1),
                                digest=b"\x01" * 32, r=1, s=1)
            arrs = marshal.pad_lanes(marshal.marshal_requests([req]), bucket)
            if curve in EDWARDS_CURVES or self.kernel_field == "sw":
                # K8 (or the host path) only: no pinned or latency variant
                self._materialize(self._launch_kernel(curve, bucket, arrs,
                                                      reqs=[req]))
            else:
                self._warm_ecdsa(curve, bucket, arrs)
        self._warmed.add((curve, bucket))
        labels = (self.kernel_field, curve, str(bucket))
        self._g_compile.set(round(time.perf_counter() - t0, 3), labels)
        self._c_compile.add(1.0, labels)

    def _warm_ecdsa(self, curve: str, bucket: int, arrs) -> None:
        self._materialize(self._throughput_launch(curve, bucket, arrs))
        if self.key_cache is not None:
            # the pinned kernel too: pin the curve's generator (a valid
            # point; one reusable slot), as the reference does
            cv = CURVES[curve]
            gkey = PublicKey(curve, cv.gx, cv.gy)
            slot = self.key_cache.pin(gkey)
            _, pools = self.key_cache.lookup_batch(curve, [gkey])
            self._materialize(self._throughput_launch(
                curve, bucket, arrs, slots=[slot], pools=pools))
        if (self._latency_eligible(bucket)
                and self.kernel_field in ecdsa.FOLD_FIELDS
                and (curve, bucket) not in self._rings):
            # the K3 ring, over the field's build of K1 (mont16 has no
            # latency program): each slot captured (on the card) and
            # replayed once on the warm-up request; a failure raises
            ring = [ecdsa.LatencySlot(CURVES[curve], bucket,
                                      device=self.device,
                                      stream=self._stream,
                                      field=self.kernel_field)
                    for _ in range(RING_SLOTS)]
            if self._stream is not None:
                for sl in ring:
                    sl.stage(arrs)
                    sl.launch().synchronize()
            with self._lock:
                self._rings[(curve, bucket)] = ring
                self._ring_free[(curve, bucket)] = list(ring)
                self._ring_allocs += len(ring)

    def set_quorum_hint(self, lanes: int) -> None:
        """Arm the speculative flush: once the accumulator holds
        ``lanes`` pending requests, the flusher launches at once instead
        of waiting out ``flush_interval``. 0 disarms.
        ``CspBatchVerifier.pin_consenters`` sets this to the committee's
        2t+1 quorum, so a full vote bucket never ages in the window."""
        self.quorum_lanes = max(0, int(lanes or 0))

    def _latency_eligible(self, size: int) -> bool:
        return bool(self.latency_max_lanes
                    and size <= self.latency_max_lanes)

    def warm_keys(self, keys: Sequence[PublicKey],
                  wait: bool = False) -> None:
        """Pin a known key set (channel consenters or endorsers).
        ``wait=False`` builds in the background. No-op without a cache."""
        if self.key_cache is not None:
            self.key_cache.warm(keys, wait=wait)

    # ---- the batched verify path ----------------------------------------
    def verify(self, req: VerifyRequest) -> bool:
        return self.verify_batch([req])[0]

    def verify_batch(self, reqs: Sequence[VerifyRequest]) -> list[bool]:
        """Synchronous batched verify through the pipelined path."""
        if not reqs:
            return []
        reqs = list(reqs)
        futs = [_Future() for _ in reqs]
        with self.tracer.span(
            "tpu.verify_batch", attrs={"n": len(reqs)}
        ) as vspan:
            self._dispatch(reqs, futs, None, vspan)
            return [f.result(self.dispatch_timeout) for f in futs]

    def _maybe_profile(self):
        """With ``BDLS_TPU_PROFILE_DIR`` set, a capture of what runs
        inside (:class:`_ProfileCapture`); a no-op otherwise and under
        ``kernel_field="sw"``."""
        if not self._profile_dir or self.kernel_field == "sw":
            return contextlib.nullcontext()
        return _ProfileCapture(self)

    def _dispatch(self, reqs: list[VerifyRequest], futs: list["_Future"],
                  queue_wait: Optional[float], vspan) -> None:
        """Screen, group, marshal and launch — never blocks on device
        results (the drainer resolves futures)."""
        with self._maybe_profile():
            self._dispatch_inner(reqs, futs, queue_wait, vspan)

    def _dispatch_inner(self, reqs: list[VerifyRequest],
                        futs: list["_Future"], queue_wait: Optional[float],
                        vspan) -> None:
        qw = self.tracer.start_span("tpu.queue_wait", parent=vspan)
        qw.end(duration=queue_wait or 0.0)
        self._h_queue_wait.observe(queue_wait or 0.0)
        limit = 1 << 256
        by_curve: dict[str, list[int]] = {}
        for i, r in enumerate(reqs):
            # host-side policy screen (low-S, 256-bit range) before
            # padding; wire-backed requests are 32-byte-exact by
            # construction (marshal.from_wire_fields screened them)
            wire = isinstance(r, WireVerifyRequest)
            curve = r.curve if wire else r.key.curve
            if curve not in CURVES and curve not in EDWARDS_CURVES:
                futs[i].fail(ValueError(f"unsupported curve {curve!r}"))
            elif curve in LOW_S_CURVES and not is_low_s(curve, r.s):
                futs[i].set(False)
            elif not wire and (
                max(r.key.x, r.key.y, r.r, r.s) >= limit
                or min(r.key.x, r.key.y, r.r, r.s) < 0
            ):
                futs[i].set(False)
            elif not wire and len(r.digest) > 32 and any(r.digest[:-32]):
                # digest integer >= 2^256: never a valid 256-bit e. The
                # reference applies this ECDSA rule to Ed25519 requests
                # too, whose digest is the whole message, and the port
                # keeps its verdicts (ROADMAP.md, Queue C)
                futs[i].set(False)
            else:
                by_curve.setdefault(curve, []).append(i)
        self._c_verified.add(len(reqs))
        cap = self.buckets[-1]
        for curve, idxs in by_curve.items():
            # pinned-key partition: cache-hit lanes ride the pinned
            # kernel, misses the generic one; per-request futures make
            # the merge free. A miss schedules a background table build,
            # so the NEXT flush hits.
            partitions: list[tuple[list[int], Optional[list[int]], object]]
            if (self.key_cache is not None and curve not in EDWARDS_CURVES
                    and self.kernel_field != "sw"):
                # the requests themselves: a wire request's ski hashes
                # its key bytes, no PublicKey is made for a hit
                slots, pools = self.key_cache.lookup_batch(
                    curve, [reqs[i] for i in idxs])
                self._g_cache_keys.set(len(self.key_cache))
                self._c_cache_lookups.add(len(slots))
                nhits = sum(1 for s in slots if s is not None)
                if nhits:
                    self._c_cache_hits.add(nhits)
                pinned = [(i, s) for i, s in zip(idxs, slots) if s is not None]
                generic = [i for i, s in zip(idxs, slots) if s is None]
                partitions = []
                if pinned:
                    partitions.append(([i for i, _ in pinned],
                                       [s for _, s in pinned], pools))
                if generic:
                    partitions.append((generic, None, None))
            else:
                partitions = [(idxs, None, None)]
            # oversized groups split into max-bucket chunks; every chunk
            # is its own launch, so they overlap in the pipeline
            for part_idxs, part_slots, pools in partitions:
                for off in range(0, len(part_idxs), cap):
                    chunk = part_idxs[off:off + cap]
                    self._dispatch_group(
                        curve, [reqs[i] for i in chunk],
                        [futs[i] for i in chunk], vspan, queue_wait or 0.0,
                        slots=(None if part_slots is None
                               else part_slots[off:off + cap]),
                        pools=pools)

    def _dispatch_group(self, curve: str, reqs: list[VerifyRequest],
                        futs: list["_Future"], vspan, queue_wait: float,
                        slots: Optional[list[int]] = None,
                        pools: Optional[dict] = None) -> None:
        n = len(reqs)
        size = next(b for b in self.buckets if b >= n)
        pad = size - n
        # pinned groups are always throughput-tier, as in the reference
        tier = ("latency" if slots is None and self._latency_eligible(size)
                else "throughput")
        try:
            with self.tracer.span("tpu.marshal", attrs={
                    "curve": curve, "bucket": size, "n": n, "pad": pad,
                    "tier": tier}):
                t0 = time.perf_counter()
                arrs = marshal.pad_lanes(marshal.marshal_requests(reqs), size)
                self._h_marshal.observe(time.perf_counter() - t0)
            if pad:
                self._c_padded.add(pad)
            # the kernel span covers the launch only; device time shows
            # up as tpu.dispatch_inflight on the drainer
            with self.tracer.span("tpu.kernel", attrs={
                    "curve": curve, "bucket": size,
                    "kernel": self.kernel_field, "runs": self.kernel,
                    "tier": tier, "pinned": slots is not None}):
                if (curve, size) in self._warmed:
                    dev = self._launch_kernel(curve, size, arrs, slots=slots,
                                              pools=pools, reqs=reqs)
                else:
                    # a pair not warmed yet: wait for a warm-up of it
                    # that is running, as the reference's first flush does
                    with self._compile_lock(curve, size):
                        dev = self._launch_kernel(curve, size, arrs,
                                                  slots=slots, pools=pools,
                                                  reqs=reqs)
            stall = self.chaos_stall_s
            if stall > 0.0:
                dev = _stalled_handle(dev, stall)
            self._c_batches.add()
            if slots is not None:
                self._c_pinned.add(n)
        except Exception as exc:
            self._fallback(reqs, futs, exc, parent=self.tracer.current())
            return
        self._enqueue(_Launch(curve, size, n, dev, reqs, futs,
                              vspan.context if vspan is not None else None,
                              tier=tier,
                              t_submit=time.perf_counter() - queue_wait))

    def _launch_kernel(self, curve: str, size: int, arrs, slots=None,
                       pools=None, reqs=None):
        """Start one bucket's verify and return an in-flight handle, by
        the kernel field's table (module docstring). ``slots``/``pools``
        select the pinned-key kernel: per-lane slots into the key
        cache's pool snapshot (padded lanes repeat lane 0's slot, as
        ``pad_lanes`` repeats its limbs). Ed25519 runs K8. An unpinned
        latency-eligible bucket takes a free K3 slot of its ring; with no
        ring (every bucket under ``mont16``) it counts a cold fallback,
        with every slot busy it does not, and both launch the generic
        program eagerly. ``"sw"`` verifies ``reqs`` on the host."""
        if self.kernel_field == "sw":
            oks = self._sw.verify_batch(reqs)
            return torch.tensor(oks + [False] * (size - len(oks)))
        if curve in EDWARDS_CURVES:
            return self._launch_ed25519(arrs)
        if slots is None and self._latency_eligible(size):
            slot = self._take_slot(curve, size)
            if slot is not None:
                return self._launch_slot(slot, arrs)
        return self._throughput_launch(curve, size, arrs, slots, pools,
                                       n=len(reqs))

    def _take_slot(self, curve: str, size: int):
        """A free K3 slot of (curve, size), taken under the provider's
        lock; None when there is no ring (counted as a cold fallback)
        or every slot is busy (not counted)."""
        key = (curve, size)
        with self._lock:
            free = self._ring_free.get(key)
            slot = free.pop() if free else None
        if free is None:
            self._c_lat_cold.add()
        return slot

    def _give_slot(self, slot) -> None:
        with self._lock:
            self._ring_free[(slot.curve.name, slot.size)].append(slot)

    def _launch_slot(self, slot, arrs) -> _Inflight:
        """Stage into the slot and launch it (a graph replay on the
        card, the plain version on the CPU); the slot rides the handle
        until the drainer has read the verdict."""
        try:
            slot.stage(arrs)
            res = slot.launch()
        except BaseException:
            self._give_slot(slot)
            raise
        self._c_lat_launch.add()
        with self._lock:
            self._ring_reuses += 1
        if self._stream is None:
            return _Inflight(res, None, None, slot=slot)
        return _Inflight(slot.out, res, None, slot=slot)

    def _staged_launch(self, host: np.ndarray, launch) -> _Inflight:
        """On the card: copy ``host`` (int32) to the device as one
        page-locked buffer, run ``launch(buf)``, copy the verdict back
        and record an event, all on the provider's stream."""
        staged = torch.from_numpy(host).pin_memory()
        with torch.cuda.stream(self._stream):
            buf = staged.to(self.device, non_blocking=True)
            ok = launch(buf)
            out = torch.empty(ok.shape[0], dtype=torch.bool,
                              pin_memory=True)
            out.copy_(ok, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Inflight(out, event, staged)

    def _field_kw(self) -> dict:
        """``field=`` for the launch wrappers, given only when it is not
        their default ("fold"), so the wrappers' plain call form stays
        what every earlier caller and stand-in uses."""
        if self.kernel_field == ecdsa.DEFAULT_FIELD:
            return {}
        return {"field": self.kernel_field}

    def _launch_ed25519(self, arrs):
        """K8 over the six limb arrays, the field's build (the plain twin
        on the CPU)."""
        kw = self._field_kw()
        if self._stream is None:
            return ed_ops.launch_verify(arrs, device=self.device, **kw)
        return self._staged_launch(
            np.stack(arrs).view(np.int32),
            lambda buf: ed_ops.launch_verify(list(buf), device=self.device,
                                             **kw))

    def _throughput_launch(self, curve: str, size: int, arrs, slots=None,
                           pools=None, n: Optional[int] = None):
        """The field's generic program (K1, K1 + K5 or K4), or with
        ``slots`` its pinned program (K2 or K2 + K5), launched eagerly:
        on the card from a staging buffer of its own, on the CPU the
        plain version (synchronously). A bucket :meth:`_use_mesh` admits
        splits across the mesh instead, the first ``n`` lanes (all by
        default) counted as real."""
        cv = CURVES[curve]
        kw = self._field_kw()
        slot_arr = None
        if slots is not None:
            slot_arr = np.asarray(
                list(slots) + [slots[0]] * (size - len(slots)), np.int32)
        if self._use_mesh(size):
            return self._mesh_launch(curve, size, arrs, slot_arr, pools,
                                     size if n is None else n)
        if self._stream is None:
            if slots is None:
                return ecdsa.launch_verify(cv, arrs, device=self.device,
                                           **kw)
            return ecdsa.launch_verify_pinned(cv, arrs[2:], slot_arr, pools,
                                              device=self.device, **kw)
        if slots is None:
            return self._staged_launch(
                np.stack(arrs).view(np.int32),
                lambda buf: ecdsa.launch_verify(cv, list(buf),
                                                device=self.device, **kw))

        def pinned(buf):
            limbs = buf[:3 * 16 * size].view(3, 16, size)
            return ecdsa.launch_verify_pinned(
                cv, list(limbs), buf[3 * 16 * size:], pools,
                device=self.device, **kw)

        inflight = self._staged_launch(np.concatenate([
            np.stack(arrs[2:]).view(np.int32).reshape(-1), slot_arr]),
            pinned)
        inflight.pools = pools
        return inflight

    def _use_mesh(self, size: int) -> bool:
        """Split this bucket across the mesh (the reference's rule): at
        or above a nonzero ``mesh_threshold``, more than one device, and
        the bucket divides among them."""
        if not self.mesh_threshold or size < self.mesh_threshold:
            return False
        ndev = pmesh.mesh_device_count()
        return ndev > 1 and size % ndev == 0

    def _mesh_launch(self, curve: str, size: int, arrs, slot_arr, pools,
                     n: int):
        """One bucket through the mesh program of ``shard_mode`` (K10):
        the generic program, or with ``slot_arr`` the pinned one; the
        mask marks the first ``n`` lanes real. On the card the shards'
        rows go as one page-locked buffer, shard-major, each shard's part
        copied to its device; the joined verdict comes back behind an
        event on the first shard's device."""
        pinned = slot_arr is not None
        if self.shard_mode == "pjit":
            get = (pmesh.get_pjit_verify_pinned if pinned
                   else pmesh.get_pjit_verify)
        else:
            get = (pmesh.get_sharded_verify_pinned if pinned
                   else pmesh.get_sharded_verify)
        fn = get(curve, self.kernel_field)
        mask = np.arange(size) < n
        limbs = list(arrs[2:] if pinned else arrs)
        if self._stream is None:
            if pinned:
                return fn(pools, mask, slot_arr, *limbs)[0]
            return fn(mask, *limbs)[0]
        mesh = fn.mesh
        rows = np.concatenate(
            [np.stack(limbs).view(np.int32).reshape(-1, size)]
            + ([slot_arr[None]] if pinned else [])
            + [mask.astype(np.int32)[None]])
        L = size // mesh.size
        staged = torch.from_numpy(np.ascontiguousarray(
            rows.reshape(rows.shape[0], mesh.size, L).transpose(1, 0, 2))
        ).pin_memory()
        first = mesh.devices[0]
        with torch.cuda.stream(self._stream):
            parts = [staged[i].to(dev, non_blocking=True)
                     for i, dev in enumerate(mesh.devices)]
            cols = [pmesh.Sharded(p[16 * k:16 * (k + 1)] for p in parts)
                    for k in range(len(limbs))]
            m = pmesh.Sharded(p[-1].ne(0) for p in parts)
            if pinned:
                sl = pmesh.Sharded(p[16 * len(limbs)] for p in parts)
                ok, _ = fn(pools, m, sl, *cols)
            else:
                ok, _ = fn(m, *cols)
            out = torch.empty(size, dtype=torch.bool, pin_memory=True)
            out.copy_(ok, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(first))
        return _Inflight(out, event, staged, pools=pools)

    @staticmethod
    def _materialize(dev) -> np.ndarray:
        """Block for one launch's result (drainer/warmup only); a stalled
        handle sleeps its stall first."""
        if isinstance(dev, _Stalled):
            time.sleep(dev.stall_s)
            dev = dev.dev
        if isinstance(dev, _Inflight):
            return dev.result()
        return dev.cpu().numpy()

    def _release(self, dev) -> None:
        """Give a K3 launch's slot back (its verdict has been read)."""
        if isinstance(dev, _Stalled):
            dev = dev.dev
        if isinstance(dev, _Inflight) and dev.slot is not None:
            self._give_slot(dev.slot)

    def _fallback(self, reqs, futs, exc, parent=None) -> None:
        if not self.use_cpu_fallback:
            for f in futs:
                f.fail(exc)
            return
        self._c_fallbacks.add()
        with self.tracer.span(
            "tpu.cpu_fallback", parent=parent,
            attrs={"n": len(reqs), "cause": repr(exc)[:200],
                   "outcome": "fallback"},
        ):
            oks = self._sw.verify_batch(reqs)
        for f, ok in zip(futs, oks):
            f.set(ok)

    # ---- the fused block lane --------------------------------------------
    def verify_block(self, req) -> np.ndarray:
        """Whole-block endorsement verify in one launch of the fused
        block program: SHA-256 of the raw messages → ECDSA verify →
        N-of-M policy tally, per-tx int32 flags out
        (:mod:`bdls_tpu_torch.ops.block_verify`). The request is read by
        attribute only (``curve``, ``lanes``, ``policies``, ``norgs``,
        ``ntx``), so the reference's request type works as is. The key
        cache plays no part: the block program runs the generic verify.
        The field picks the build (``mont16`` runs the fold program's,
        as the reference); under ``"sw"`` the host reference path
        answers, not counted as a fallback (``fused`` False).

        A request beyond the largest bucket (lanes, txs, message blocks
        or orgs) is answered by the host reference path over
        :meth:`verify_batch` and counted in
        ``tpu_block_fallbacks_total``; that is the only fallback. A
        build or launch error raises."""
        t0 = time.perf_counter()
        field = {"mont16": "fold"}.get(self.kernel_field, self.kernel_field)
        buckets = oversize = None
        if field != "sw":
            try:
                buckets = block_verify.request_buckets(req)
            except ValueError as exc:
                oversize = exc
        with self.tracer.span("tpu.verify_block", attrs={
                "lanes": len(req.lanes), "txs": req.ntx,
                "orgs": req.norgs, "fused": buckets is not None}) as span:
            self._c_block_blocks.add()
            self._c_block_lanes.add(len(req.lanes))
            if field == "sw":
                flags = blocklane.verify_block_host(self.verify_batch, req)
            elif buckets is None:
                span.set_attr("outcome", "fallback")
                span.set_attr("cause", repr(oversize)[:200])
                self._c_block_fallbacks.add()
                flags = blocklane.verify_block_host(self.verify_batch, req)
            else:
                with self._maybe_profile():
                    flags = self._verify_block_fused(req, buckets, field)
            self._h_block_rtt.observe(time.perf_counter() - t0)
            return flags

    def _verify_block_fused(self, req, buckets, field: str) -> np.ndarray:
        """Pack with the host low-S screen (offending lanes pack as
        filler and never hit), launch, return the real tx rows' flags.
        On the card the packed arrays go as one page-locked buffer on
        the provider's stream, K7 launches there and the flags come
        back behind an event; on the CPU the plain twin runs."""
        cv = CURVES.get(req.curve)
        if cv is None:
            raise ValueError(f"unsupported curve {req.curve!r}")
        packed = block_verify.pack_block_request(
            req, lane_ok=block_lane_screen(req.curve), buckets=buckets)
        ntx = packed["ntx"]
        if self._stream is None:
            kw = {} if field == ecdsa.DEFAULT_FIELD else {"field": field}
            flags, _ = block_verify.launch_block(cv, packed,
                                                 device=self.device, **kw)
            return flags.numpy()[:ntx].astype(np.int32)
        arrs = [np.ascontiguousarray(packed[k]).view(np.int32)
                for k in block_verify.PACKED_KEYS]
        staged = torch.from_numpy(
            np.concatenate([a.reshape(-1) for a in arrs])).pin_memory()
        with torch.cuda.stream(self._stream):
            buf = staged.to(self.device, non_blocking=True)
            parts, off = [], 0
            for a in arrs:
                parts.append(buf[off:off + a.size].view(a.shape))
                off += a.size
            flags, _ = block_verify.verify_block_cuda(
                cv, *parts, engine=ecdsa.FOLD_FIELDS[field])
            out = torch.empty(flags.shape, dtype=torch.int32,
                              pin_memory=True)
            out.copy_(flags, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        return out.numpy()[:ntx].copy()

    # ---- the certificate lane ---------------------------------------------
    def verify_certificates(self, certs, aggregators,
                            backend: Optional[str] = None) -> list[bool]:
        """The pairing lane: a cross-round batch of quorum certificates
        -> per-certificate verdicts (the reference's
        ``TpuCSP.verify_certificates``), by one of three backends
        (``bls_kernel.resolve_backend``: given here, or by
        ``BDLS_CERT_BACKEND``):

        - ``"kernel"``: the batch packed
          (``consensus.threshold.certificate_lanes``: structurally
          invalid certificates masked False) and checked on the
          provider's device through the full-exponent final
          exponentiation, the reference's ``verify_pipeline``: one K9
          Miller launch and one K11 launch a call on the card
          (:mod:`bdls_tpu_torch.ops.bls_kernel`), the plain twin on the
          CPU; ``BDLS_BLS_FE=fast`` turns it into ``"kernel-fast"``;
        - ``"kernel-fast"`` (the default: ``None`` and an empty
          ``BDLS_CERT_BACKEND``): the same through the x-chain, whose
          values are the full exponent's cubes and whose verdicts are
          the same: one Miller and one K9 final launch a call;
        - ``"host"``: the copied oracle, counted in
          ``tpu_certs_host_total``.

        A build or launch error raises; nothing falls back."""
        if not certs:
            return []
        backend = bls_kernel.resolve_backend(backend)
        with self.tracer.span("tpu.verify_certs", attrs={
                "n": len(certs), "backend": backend}):
            self._c_certs.add(len(certs))
            if backend == "host":
                self._c_cert_host.add(len(certs))
            with (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext()):
                return bls_kernel.verify_certificates(
                    certs, aggregators, backend, device=self.device)

    # ---- completion drainer ----------------------------------------------
    def _enqueue(self, launch: _Launch) -> None:
        self._ensure_drainer()
        with self._lock:
            self._inflight_n += 1
            depth = self._inflight_n
            self._max_inflight = max(self._max_inflight, depth)
        self._g_inflight.set(depth)
        self._inflight.put(launch)

    def _dec_inflight(self) -> None:
        with self._lock:
            self._inflight_n -= 1
            depth = self._inflight_n
        self._g_inflight.set(depth)

    def _ensure_drainer(self) -> None:
        with self._lock:
            if self._drainer is not None and self._drainer.is_alive():
                return
            self._drainer = threading.Thread(
                target=self._drain_loop, daemon=True,
                name="torch-csp-drain")
            self._drainer.start()

    def _drain_loop(self) -> None:
        while True:
            launch = self._inflight.get()
            if launch is None:  # close() sentinel
                return
            self._drain_one(launch)

    def _drain_one(self, launch: _Launch) -> None:
        sp = self.tracer.start_span(
            "tpu.dispatch_inflight", parent=launch.parent,
            attrs={"curve": launch.curve, "bucket": launch.size})
        try:
            ok = self._materialize(launch.dev)
        except Exception as exc:
            self._release(launch.dev)
            sp.end(error=repr(exc)[:200],
                   duration=time.perf_counter() - launch.t_launch)
            self._dec_inflight()
            self._fallback(launch.reqs, launch.futs, exc,
                           parent=launch.parent)
            return
        sp.end(duration=time.perf_counter() - launch.t_launch)
        fold_sp = self.tracer.start_span(
            "tpu.fold", parent=launch.parent, attrs={"n": launch.n})
        vals = [bool(v) for v in ok[:launch.n]]
        self._release(launch.dev)
        fold_sp.end()
        # futures resolve only after every span closed, so a sync caller
        # returning immediately still observes a finalized trace
        for f, v in zip(launch.futs, vals):
            f.set(v)
        if launch.tier == "latency":
            self._h_vote_rtt.observe(time.perf_counter() - launch.t_submit)
        self._dec_inflight()

    # ---- async accumulator (deadline-or-size window) ---------------------
    def submit(self, req: VerifyRequest) -> "_Future":
        """Enqueue a request; the background flusher batches it with
        concurrent callers."""
        fut = _Future()
        with self._lock:
            if self.pending_cap:
                if (self.pending_policy == "reject"
                        and len(self._pending) >= self.pending_cap):
                    raise AccumulatorSaturated(
                        f"pending queue full "
                        f"({len(self._pending)} >= {self.pending_cap})")
                while len(self._pending) >= self.pending_cap:
                    # block policy: park until a flush drains room, so
                    # the backpressure reaches the submitter
                    self._wake.set()  # nudge the flusher
                    if not self._lock.wait(self.dispatch_timeout):
                        raise AccumulatorSaturated(
                            f"pending queue full for "
                            f"{self.dispatch_timeout}s "
                            f"({len(self._pending)} >= {self.pending_cap})")
            self._pending.append((req, fut, time.perf_counter()))
            npend = len(self._pending)
            full = npend >= self.max_pending
            if (not full and self.quorum_lanes
                    and npend >= self.quorum_lanes):
                # quorum occupancy reached: the flusher launches now
                # (speculative flush) instead of letting a complete vote
                # bucket age to the deadline
                self._speculative = True
        if full:
            self.flush()
        self._ensure_runner()
        self._wake.set()
        return fut

    def flush(self) -> None:
        """Marshal and launch everything pending, without waiting for
        device results (the drainer resolves the futures)."""
        with self._lock:
            batch, self._pending = self._pending, []
            spec, self._speculative = self._speculative, False
            if self.pending_cap:
                self._lock.notify_all()  # wake parked submitters
        if not batch:
            return
        if spec:
            self._c_spec.add()
        queue_wait = time.perf_counter() - min(t for _, _, t in batch)
        reqs = [r for r, _, _ in batch]
        futs = [f for _, f, _ in batch]
        vspan = self.tracer.start_span(
            "tpu.verify_batch", attrs={"n": len(reqs)})
        try:
            with self.tracer.use(vspan):
                self._dispatch(reqs, futs, queue_wait, vspan)
        finally:
            vspan.end()

    def _ensure_runner(self) -> None:
        with self._lock:
            if self._runner is not None and self._runner.is_alive():
                return
            self._stop.clear()
            self._runner = threading.Thread(
                target=self._run, daemon=True, name="torch-csp-flush")
            self._runner.start()

    def _run(self) -> None:
        # sleeps until the oldest pending request's deadline or an
        # enqueue wakeup; an armed speculative flush (quorum occupancy)
        # fires at once; an idle provider parks on the event
        while not self._stop.is_set():
            with self._lock:
                oldest = self._pending[0][2] if self._pending else None
                spec = self._speculative
            if oldest is None:
                self._wake.wait(self.flush_interval)
                self._wake.clear()
                continue
            remaining = self.flush_interval - (time.perf_counter() - oldest)
            if spec or remaining <= 0:
                self.flush()
                continue
            self._wake.wait(remaining)
            self._wake.clear()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self.flush()
        with self._lock:
            runner, drainer = self._runner, self._drainer
        if runner is not None and runner.is_alive():
            runner.join(timeout=self.dispatch_timeout)
        if drainer is not None and drainer.is_alive():
            # sentinel lands behind any launches flush just queued
            self._inflight.put(None)
            drainer.join(timeout=self.dispatch_timeout)
        if self.key_cache is not None:
            self.key_cache.close()

    # ---- health ----------------------------------------------------------
    def healthy(self) -> bool:
        """Cheap health probe for an operations /healthz checker."""
        if self.device.type == "cpu" or self.kernel_field == "sw":
            return True
        return torch.cuda.is_available()


class _ProfileCapture:
    """One dispatch's ``torch.profiler`` capture, written as a Chrome
    trace into ``BDLS_TPU_PROFILE_DIR``. Mutually exclusive across
    threads through a non-blocking lock (a concurrent dispatch runs
    uncaptured); on the card the exit synchronises the provider's stream
    before it stops, since a dispatch returns before its kernel ends.
    A capture that fails leaves the dispatch untouched and counts
    nothing."""

    def __init__(self, csp: "TorchCSP"):
        self._csp = csp
        self._prof = None

    def __enter__(self):
        csp = self._csp
        if not csp._profile_lock.acquire(blocking=False):
            return self
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if csp._stream is not None:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception:  # noqa: BLE001 — profiling never fails a verify
            csp._profile_lock.release()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof is None:
            return False
        csp, prof, self._prof = self._csp, self._prof, None
        try:
            if csp._stream is not None:
                csp._stream.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(csp._profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                csp._profile_dir,
                f"trace-{os.getpid()}-{time.time_ns()}.json"))
            csp._c_profiles.add()
        except Exception:  # noqa: BLE001 — profiling never fails a verify
            pass
        finally:
            csp._profile_lock.release()
        return False


class _Future:
    def __init__(self):
        self._ev = threading.Event()
        self._val: Optional[bool] = None
        self._exc: Optional[BaseException] = None

    def set(self, val: bool) -> None:
        self._val = val
        self._ev.set()

    def fail(self, exc: BaseException) -> None:
        """Resolve exceptionally (kernel failure with fallback disabled):
        waiters re-raise instead of hanging mid-pipeline."""
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> bool:
        if not self._ev.wait(timeout):
            raise TimeoutError("verify future timed out")
        if self._exc is not None:
            raise self._exc
        return bool(self._val)

"""Operations/observability tests on the port: every case of
``tests/test_operations.py`` (metrics rendering, health checkers, dynamic
log spec, pprof — driven over real HTTP like the reference's operations
system tests, core/operations/system_test.go pattern) over
``bdls_tpu_torch.utils``; the cases of ``tests/test_sidecar.py:713`` and
``:734`` on the port's daemon (its ops endpoint serves verifyd's
metrics, the SLO verdict with the sidecar objectives bound, and the
flight recorder); and ``--ops-port`` through the port's command line."""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from bdls_tpu_torch.utils.flog import LogRegistry
from bdls_tpu_torch.utils.metrics import MetricOpts, MetricsProvider
from bdls_tpu_torch.utils.operations import OperationsSystem

ROOT = Path(__file__).resolve().parents[1]


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return resp.status, resp.read()


def test_counter_gauge_histogram_render():
    prov = MetricsProvider()
    c = prov.new_counter(
        MetricOpts(namespace="consensus", name="msgs", label_names=("channel",))
    )
    c.add(3, ("ch1",))
    c.with_labels("ch2").add()
    g = prov.new_gauge(MetricOpts(namespace="cluster", name="size"))
    g.set(4)
    h = prov.new_histogram(
        MetricOpts(namespace="verify", name="latency", buckets=(0.01, 0.1, 1.0))
    )
    h.observe(0.05)
    h.observe(0.5)
    text = prov.render_prometheus()
    assert 'consensus_msgs{channel="ch1"} 3.0' in text
    assert 'consensus_msgs{channel="ch2"} 1.0' in text
    assert "cluster_size 4" in text
    assert 'verify_latency_bucket{le="0.1"} 1' in text
    assert 'verify_latency_bucket{le="1.0"} 2' in text
    assert 'verify_latency_bucket{le="+Inf"} 2' in text
    assert "verify_latency_count 2" in text


def test_log_registry_spec():
    import io

    reg = LogRegistry(stream=io.StringIO())
    lg = reg.get_logger("orderer.consensus")
    assert lg.level == 20  # info
    reg.set_spec("orderer.consensus=debug:warning")
    assert lg.level == 10
    assert reg.get_logger("gossip").level == 30
    with pytest.raises(ValueError):
        reg.set_spec("orderer=verbose")


def test_operations_http_surface():
    ops = OperationsSystem()
    ops.metrics.new_gauge(MetricOpts(name="up")).set(1)
    healthy = {"val": None}
    ops.register_checker("tpu", lambda: healthy["val"])
    ops.start()
    base = f"http://{ops.host}:{ops.port}"
    try:
        status, body = _get(base + "/metrics")
        assert status == 200 and b"up 1" in body

        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] == "OK"

        healthy["val"] = "device lost"
        try:
            _get(base + "/healthz")
            assert False, "expected 503"
        except urllib.error.HTTPError as e:
            assert e.code == 503
            assert json.loads(e.read())["failed_checks"][0]["component"] == "tpu"
        healthy["val"] = None

        status, body = _get(base + "/version")
        assert status == 200 and "version" in json.loads(body)

        req = urllib.request.Request(
            base + "/logspec",
            data=json.dumps({"spec": "comm=debug:info"}).encode(),
            method="PUT",
        )
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 204
        status, body = _get(base + "/logspec")
        assert json.loads(body)["spec"] == "comm=debug:info"

        req = urllib.request.Request(
            base + "/logspec", data=b'{"spec": "bogus-level"}', method="PUT"
        )
        try:
            urllib.request.urlopen(req)
            assert False, "expected 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        ops.stop()


def test_pprof_surface():
    """Profiling endpoints (the reference's General.Profile pprof gate:
    orderer/common/server/main.go:312-317)."""
    ops = OperationsSystem()
    ops.start()
    base = f"http://127.0.0.1:{ops.port}"
    try:
        with urllib.request.urlopen(f"{base}/debug/pprof/threads") as r:
            assert "thread MainThread" in r.read().decode()
        with urllib.request.urlopen(
            f"{base}/debug/pprof/profile?seconds=0.2"
        ) as r:
            assert "samples:" in r.read().decode()
        ops.profile_enabled = False
        try:
            urllib.request.urlopen(f"{base}/debug/pprof/threads")
            assert False, "expected 403"
        except urllib.error.HTTPError as e:
            assert e.code == 403
    finally:
        ops.stop()


def test_version_is_the_ports():
    import bdls_tpu_torch

    ops = OperationsSystem()
    ops.start()
    try:
        status, body = _get(f"http://{ops.host}:{ops.port}/version")
        assert json.loads(body) == {"version": bdls_tpu_torch.__version__}
        status, body = _get(f"http://{ops.host}:{ops.port}/debug/traces")
        assert status == 200 and "traces" in json.loads(body)
    finally:
        ops.stop()
    OperationsSystem().stop()  # stop before start returns at once


# ---- the daemon's ops surface and SLO (tests/test_sidecar.py:713, :734) -----

def _signed(i: int):
    from bdls_tpu_torch.crypto.csp import VerifyRequest
    from bdls_tpu_torch.crypto.sw import SwCSP

    sw = SwCSP()
    key = sw.key_from_scalar("secp256k1", 0x0B5 + i)
    digest = sw.hash(b"ops-%d" % i)
    r, s = sw.sign(key, digest)
    return VerifyRequest(key.public_key(), digest, r, s)


def test_ops_endpoint_serves_verifyd_metrics_and_slo():
    from bdls_tpu_torch.crypto.torch_provider import TorchCSP
    from bdls_tpu_torch.sidecar.remote_csp import RemoteCSP
    from bdls_tpu_torch.sidecar.verifyd import VerifydServer
    from bdls_tpu_torch.utils import tracing

    metrics, tracer = MetricsProvider(), tracing.Tracer()
    csp = TorchCSP(device="cpu", kernel_field="sw", buckets=(8, 32, 128),
                   key_cache_size=0, metrics=metrics, tracer=tracer)
    srv = VerifydServer(csp=csp, transport="socket", flush_interval=0.005,
                        metrics=metrics, tracer=tracer).start()
    reqs = [_signed(i) for i in range(4)]
    try:
        assert srv.ops_port and srv.tsdb is not None
        # enough batches that the min_count-gated sidecar objectives bind
        for _ in range(5):
            client = RemoteCSP(f"127.0.0.1:{srv.port}", transport="socket",
                               tenant="opsy")
            try:
                assert client.verify_batch(reqs) == [True] * 4
            finally:
                client.close()
        base = f"http://127.0.0.1:{srv.ops_port}"
        status, body = _get(f"{base}/healthz")
        assert status == 200 and json.loads(body)["status"] == "OK"
        status, body = _get(f"{base}/metrics")
        text = body.decode()
        assert "verifyd_requests_total" in text
        assert 'tenant="opsy"' in text
        assert "verifyd_coalesce_bucket_lanes" in text
        assert "tpu_verify_requests_total" in text
        status, body = _get(f"{base}/debug/slo")
        names = {o["name"]: o for o in json.loads(body)["objectives"]}
        assert "coalesced_bucket_floor" in names
        assert "sidecar_queue_wait_p99" in names
        # gated sidecar objectives actually bound on this daemon
        assert names["sidecar_queue_wait_p99"]["status"] in ("pass", "fail")
        srv.tsdb.sample()
        status, body = _get(f"{base}/debug/tsdb")
        fqs = {s["fq"] for s in json.loads(body)["series"]}
        assert "verifyd_requests_total" in fqs
    finally:
        srv.stop()
        srv.close_csp()
    assert srv.tsdb._thread is None  # the recorder stops with the server


def test_slo_sidecar_objectives_gate_off_without_daemon():
    from bdls_tpu_torch.utils import slo, tracing

    verdict = slo.evaluate(tracer=tracing.Tracer(),
                           metrics=MetricsProvider())
    names = {o["name"]: o for o in verdict["objectives"]}
    assert names["coalesced_bucket_floor"]["status"] == "skipped"
    assert names["sidecar_fallback_zero"]["status"] == "skipped"


# ---- --ops-port through the command line -------------------------------------

_CLI = """
import sys
from bdls_tpu_torch.crypto import factory
from bdls_tpu_torch.crypto.torch_provider import TorchCSP
# the daemon's provider on the CPU: the command line itself runs on the card
factory.get_csp = lambda opts: TorchCSP(
    device="cpu", kernel_field="sw", buckets=(8,), key_cache_size=0,
    metrics=opts.metrics, tracer=opts.tracer)
from bdls_tpu_torch.cli.main import main
sys.exit(main(sys.argv[1:]))
"""


def test_cli_serves_the_ops_port():
    proc = subprocess.Popen(
        [sys.executable, "-c", _CLI, "verifyd", "--no-warmup", "--ops-port",
         "0"], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        info = json.loads(proc.stdout.readline())
        assert info["transport"] == "socket"
        assert isinstance(info["operations"], int) and info["operations"] > 0
        status, body = _get(f"http://127.0.0.1:{info['operations']}/healthz")
        assert status == 200 and json.loads(body)["status"] == "OK"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()

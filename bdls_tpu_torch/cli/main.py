"""The port's command line: ``python3 -m bdls_tpu_torch.cli.main verifyd``.

One subcommand so far, the verification daemon (the reference's
``bdls_tpu verifyd``, ``bdls_tpu/cli/main.py:cmd_verifyd``): one
:class:`~bdls_tpu_torch.sidecar.verifyd.VerifydServer` over a TorchCSP on
the card, shared by every node that points its ``verify_endpoint`` at
it. It prints one JSON line once it listens and drains on SIGINT.
Without a card it fails at once: it never verifies on the CPU.
The operations endpoint (``--ops-port``) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_verifyd(args) -> int:
    from bdls_tpu_torch.sidecar.verifyd import VerifydServer

    try:
        server = VerifydServer(
            host=args.listen_host,
            port=args.port,
            transport=args.transport,
            flush_interval=args.flush_interval,
            tenant_quota=args.tenant_quota,
            kernel_field=args.kernel,
            warmup=not args.no_warmup,
            warm_snapshot=args.warm_snapshot,
        )
    except RuntimeError as exc:  # no card: resolve_device's message
        print(f"verifyd: {exc}", file=sys.stderr, flush=True)
        return 1
    server.start()
    print(json.dumps({
        "listen": [server.host, server.port],
        "transport": server.transport,
        "operations": None,
        "kernel": getattr(server.csp, "kernel_field", "sw"),
    }), flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        server.close_csp()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bdls_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    vd = sub.add_parser("verifyd",
                        help="run the verification daemon on the card")
    vd.add_argument("--listen-host", default="127.0.0.1")
    vd.add_argument("--port", type=int, default=0,
                    help="client stream port (0 = ephemeral, printed)")
    vd.add_argument("--transport", default="auto",
                    choices=["auto", "socket"])
    vd.add_argument("--kernel", default=None,
                    choices=["fold", "mxu", "mont16", "sw"],
                    help="kernel generation (default BDLS_TPU_KERNEL)")
    vd.add_argument("--flush-interval", type=float, default=0.002,
                    help="coalescing window seconds (deadline flush)")
    vd.add_argument("--tenant-quota", type=int, default=65536,
                    help="max in-flight lanes per tenant")
    vd.add_argument("--no-warmup", action="store_true",
                    help="skip the per-(curve, bucket) warm-up at boot")
    vd.add_argument("--warm-snapshot", default=None,
                    help="pinned-table snapshot path: restored before "
                         "the listener starts, written on drain (the "
                         "warm handoff of a rolling restart)")
    vd.set_defaults(fn=cmd_verifyd)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

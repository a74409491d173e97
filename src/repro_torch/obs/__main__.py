"""CLI: trace reports, the live SLO watcher, and one-shot SLO checks.

  python -m repro_torch.obs report <trace.json> [--top K]
  python -m repro_torch.obs watch [--port P] [--interval S] [--duration S]
                                  [--demo] [--device DEV]
  python -m repro_torch.obs slo check (--url http://host:port
                                       | --file slo.json)

``watch`` starts the TopoWatch HTTP exporter in-process, installs the
stock serving SLOs when no engine is installed yet, and prints a verdict
table every interval (``--demo`` additionally spins a small TopoServe
with synthetic traffic so the loop has something to watch; it runs on
the card unless ``--device`` names another, as tests ask for the CPU).
``slo check`` fetches ``/slo`` from a running exporter (or reads a saved
verdict JSON) and exits 1 on any breach, 2 when the exporter cannot be
reached or the status is empty — the scriptable alerting hook.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .report import report


def _cmd_watch(args) -> int:
    from . import slo as slo_mod
    from .http import start_http_server

    engine = slo_mod.installed()
    if engine is None:
        engine = slo_mod.SLOEngine(slo_mod.default_serve_slos())
        slo_mod.install(engine)
    srv = start_http_server(port=args.port)
    print(f"[watch] exporter at {srv.url} "
          "(/metrics /healthz /readyz /varz /slo /debug/flight)")

    stop_demo = _start_demo(args.device) if args.demo else None
    t_end = (time.monotonic() + args.duration
             if args.duration is not None else None)
    try:
        while t_end is None or time.monotonic() < t_end:
            status = engine.tick()
            stamp = time.strftime("%H:%M:%S")
            marks = {"ok": ".", "breach": "!", "no_data": "-"}
            line = " ".join(
                f"{name}={marks.get(v['status'], '?')}"
                for name, v in sorted(status.items()))
            breached = [n for n, v in status.items()
                        if v["status"] == "breach"]
            print(f"[watch {stamp}] {line}"
                  + (f"  BREACH: {breached}" if breached else ""),
                  flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if stop_demo is not None:
            stop_demo()
        srv.stop()
    return 0


def _start_demo(device=None):
    """Tiny in-process TopoServe + traffic thread for `watch --demo`, on
    ``device`` (CUDA unless given)."""
    import threading

    import numpy as np

    from repro_torch.serve import TopoServe, TopoServeConfig

    # pad_batch_to == max_batch pins one batch shape per bucket, and the
    # synchronous warm round below pays the first launch's module load and
    # kernel build before the watcher ticks — otherwise the demo's latency
    # SLOs breach on the build, not on anything a real operator should
    # alert on
    server = TopoServe(TopoServeConfig(max_batch=8, pad_batch_to=8),
                       device=device)
    for n in (10, 28):  # one graph per bucket the traffic below can hit
        server.submit(edges=[(i, i + 1) for i in range(n - 1)],
                      n_vertices=n)
    server.drain()
    drain = threading.Thread(target=server.serve_forever,
                             name="watch-demo-drain", daemon=True)
    drain.start()
    stop = threading.Event()

    def traffic():
        rng = np.random.default_rng(0)
        while not stop.is_set():
            n = int(rng.integers(5, 30))
            edges = [(int(rng.integers(n)), int(rng.integers(n)))
                     for _ in range(2 * n)]
            edges = [(u, v) for (u, v) in edges if u != v]
            try:
                server.submit(edges=edges, n_vertices=n)
            except ValueError:
                pass  # oversize roll: skip
            stop.wait(0.05)

    gen = threading.Thread(target=traffic, name="watch-demo-traffic",
                           daemon=True)
    gen.start()

    def stop_all():
        stop.set()
        server.stop()
        gen.join(timeout=2)
        drain.join(timeout=2)

    return stop_all


def _cmd_slo_check(args) -> int:
    if args.url:
        from urllib.request import urlopen

        url = args.url.rstrip("/")
        if not url.endswith("/slo"):
            url += "/slo"
        try:
            with urlopen(url, timeout=args.timeout) as resp:
                doc = json.load(resp)
        except Exception as e:
            print(f"[slo check] cannot reach {url}: {e}")
            return 2
    else:
        try:
            with open(args.file) as fh:
                doc = json.load(fh)
        except Exception as e:
            print(f"[slo check] cannot read {args.file}: {e}")
            return 2
    status = doc.get("status", doc)  # accept /slo payloads or bare dicts
    if not status:
        print("[slo check] no SLO engine installed / empty status")
        return 2
    breached = sorted(n for n, v in status.items()
                      if v.get("status") == "breach")
    for name, v in sorted(status.items()):
        print(f"  {v.get('status', '?'):>8}  {name}"
              + (f"  ({v.get('description', '')})"
                 if v.get("description") else ""))
    if breached:
        print(f"[slo check] FAIL: {len(breached)} breached: {breached}")
        return 1
    print(f"[slo check] OK: {len(status)} objectives within budget")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="TopoScope/TopoWatch tooling")
    sub = p.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser(
        "report",
        help="top-k self-time table with roofline cost cells")
    rp.add_argument("trace", help="Chrome-trace JSON written by "
                                  "repro_torch.obs.export_chrome_trace")
    rp.add_argument("--top", type=int, default=15,
                    help="rows to print (default 15)")

    wp = sub.add_parser(
        "watch", help="live SLO watcher + TopoWatch HTTP exporter")
    wp.add_argument("--port", type=int, default=9464,
                    help="exporter port (0 = ephemeral; default 9464)")
    wp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between SLO ticks (default 2)")
    wp.add_argument("--duration", type=float, default=None,
                    help="exit after this many seconds (default: run "
                         "until Ctrl-C)")
    wp.add_argument("--demo", action="store_true",
                    help="also run a demo TopoServe with synthetic "
                         "traffic")
    wp.add_argument("--device", default=None,
                    help="the demo's device (default: CUDA; 'cpu' runs "
                         "the plain PyTorch path)")

    sp = sub.add_parser("slo", help="SLO verdict tooling")
    sp.add_argument("action", choices=["check"],
                    help="check: exit 1 on any breached objective")
    sp.add_argument("--url", default=None,
                    help="base URL (or /slo URL) of a running exporter")
    sp.add_argument("--file", default=None,
                    help="saved /slo JSON payload to check instead")
    sp.add_argument("--timeout", type=float, default=5.0)

    args = p.parse_args(argv)
    if args.cmd == "report":
        print(report(args.trace, top=args.top))
        return 0
    if args.cmd == "watch":
        return _cmd_watch(args)
    if args.cmd == "slo":
        if not args.url and not args.file:
            p.error("slo check needs --url or --file")
        return _cmd_slo_check(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

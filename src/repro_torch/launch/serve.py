"""FPTC archive service: the serving front-end as a long-lived process.
Port of ``repro/launch/serve.py``.

Two modes over the same :class:`~repro_torch.serving.frontend.ServingFrontend`
(tables for all four paper domains, deadline micro-batching, bounded
queues with explicit shedding), its engines sharded over every visible
card (``devices="auto"``, as the reference serves) unless ``--device``
names one device (``--device cpu``: the plain PyTorch versions), under
the ``--policy`` bucket ladder:

  * **replay** — drive the front-end with synthetic open-loop traffic
    (:mod:`repro_torch.serving.traffic`) and print the latency/goodput
    report; the self-contained way to see the service behave under load::

      PYTHONPATH=src python -m repro_torch.launch.serve --replay \\
          --rate 100 --duration 2

  * **HTTP** (default) — a stdlib ``ThreadingHTTPServer`` front door;
    handler threads admit concurrently (the front-end's admission path is
    thread-safe), the dispatcher micro-batches behind them::

      PYTHONPATH=src python -m repro_torch.launch.serve --port 8080

    ================================  =====================================
    ``POST /v1/encode?domain_id=K``   body: raw little-endian float32
                                      samples -> container bytes
    ``POST /v1/decode``               body: container bytes -> raw float32
                                      samples
    ``POST /v1/transcode?dst=K``      body: container bytes -> container
                                      bytes re-encoded under domain K
    ``GET /healthz``                  liveness
    ``GET /statz``                    front-end stats + queue depths (JSON)
    ================================  =====================================

    Requests may carry ``X-FPTC-Deadline-Ms``; a shed request gets **429**
    with the queue's depth/bound and a ``Retry-After`` (backpressure is a
    response, never a silent drop); an already-expired deadline gets
    **400**; decode of a domain the service has no tables for gets **404**.

    Fault handling (see the README's taxonomy table): a corrupt container
    gets **422** with the typed quarantine record (fault class + byte
    offset) — whether caught at admission (header faults) or by the
    per-request quarantine at dispatch (payload faults) — while its
    batch-mates are unaffected; a dispatch the watchdog/retry machinery
    gave up on gets **503** with ``dispatch-failed``.  ``GET /healthz``
    returns **200** with ``{"status": "ok"}`` when healthy and **503**
    with the degraded evidence (recent fault events, shed rate,
    quarantine/retry counters) when a watchdog restart, dispatcher crash
    or dispatch failure happened within the degraded window.
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from repro_torch.core.container import ContainerFormatError
from repro_torch.serving.frontend import (
    DeadlineExpiredError,
    DispatchFailedError,
    FrontendClosedError,
    FrontendConfig,
    QueueFullError,
    RetryPolicy,
    ServingFrontend,
    settle_heap,
)
from repro_torch.serving.quarantine import PoisonedContainerError
from repro_torch.serving.traffic import (
    TrafficConfig,
    build_domain_tables,
    generate,
    replay,
)
from repro_torch.tuning.policy import POLICY_NAMES


def build_frontend(args, fault_injector=None) -> ServingFrontend:
    tables = build_domain_tables(seed=args.seed)
    return ServingFrontend(
        tables,
        config=FrontendConfig(
            max_batch=args.max_batch,
            max_queue_depth=args.queue_depth,
            default_slo_ms=args.slo_ms,
            flush_slack_ms=args.slack_ms,
            quarantine=not args.no_quarantine,
            retry=RetryPolicy(max_retries=args.retries),
            watchdog_timeout_ms=args.watchdog_ms,
        ),
        pipeline=not args.no_pipeline,
        device=args.device,
        # every visible card, as the reference serves; an explicit
        # --device runs on that device alone
        devices="auto" if args.device is None else None,
        policy=getattr(args, "policy", None),
        fault_injector=fault_injector,
    )


# ---------------------------------------------------------------------------
# HTTP mode.
# ---------------------------------------------------------------------------
def make_handler(frontend: ServingFrontend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _reply(self, code: int, body: bytes,
                   content_type: str = "application/octet-stream",
                   extra=()):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj, extra=()):
            self._reply(
                code, json.dumps(obj).encode(), "application/json", extra
            )

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                health = frontend.health()
                self._reply_json(
                    200 if health["status"] == "ok" else 503, health
                )
            elif path == "/statz":
                st = frontend.stats_snapshot()
                self._reply_json(200, {
                    "health": frontend.health(),
                    "stats": {
                        k: getattr(st, k)
                        for k in st.__dataclass_fields__
                    },
                    "mean_batch_size": st.mean_batch_size,
                    "inflight": frontend.inflight(),
                    "queues": {
                        repr(k): v
                        for k, v in frontend.queue_depths().items()
                    },
                    "fill_target": frontend.fill_target,
                })
            else:
                self._reply_json(404, {"error": f"no route {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            query = parse_qs(url.query)
            body = self.rfile.read(
                int(self.headers.get("Content-Length", 0))
            )
            deadline = self.headers.get("X-FPTC-Deadline-Ms")
            deadline_ms = float(deadline) if deadline else None
            try:
                if url.path == "/v1/decode":
                    # raw wire bytes go straight to admission: under
                    # quarantine the frontend routes off the O(1) header
                    # peek and a corrupt payload poisons only this request
                    fut = frontend.submit_decode(
                        body, deadline_ms=deadline_ms
                    )
                    payload = fut.result().astype("<f4").tobytes()
                elif url.path == "/v1/encode":
                    domain_id = int(query.get("domain_id", ["0"])[0])
                    signal = np.frombuffer(body, dtype="<f4")
                    fut = frontend.submit_encode(
                        signal, domain_id, deadline_ms=deadline_ms
                    )
                    payload = fut.result().to_bytes()
                elif url.path == "/v1/transcode":
                    if "dst" not in query:
                        self._reply_json(
                            400, {"error": "transcode needs ?dst=<domain>"}
                        )
                        return
                    fut = frontend.submit_transcode(
                        body,
                        int(query["dst"][0]),
                        deadline_ms=deadline_ms,
                    )
                    payload = fut.result().to_bytes()
                else:
                    self._reply_json(404, {"error": f"no route {url.path}"})
                    return
            except QueueFullError as e:
                # explicit shed: tell the client how loaded we are and to
                # back off — never a silent drop
                self._reply_json(429, {
                    "error": "shed", "queue": repr(e.queue),
                    "depth": e.depth, "bound": e.bound,
                }, extra=[("Retry-After", "1")])
                return
            except DeadlineExpiredError as e:
                self._reply_json(400, {"error": str(e)})
                return
            except FrontendClosedError:
                self._reply_json(503, {"error": "shutting down"})
                return
            except (ContainerFormatError, PoisonedContainerError) as e:
                # the typed quarantine record: the request's payload is
                # bad, the rest of its batch completed untouched
                self._reply_json(422, {
                    "error": "poisoned-container",
                    "fault": e.fault,
                    "offset": e.offset,
                    "index": e.index,
                    "detail": str(e),
                })
                return
            except DispatchFailedError as e:
                # the serving machinery (not the payload) gave up —
                # resubmitting is safe
                self._reply_json(503, {
                    "error": "dispatch-failed", "detail": str(e),
                }, extra=[("Retry-After", "1")])
                return
            except (KeyError, ValueError) as e:
                self._reply_json(404, {"error": str(e)})
                return
            self._reply(200, payload)

    return Handler


def make_server(frontend: ServingFrontend, host: str,
                port: int) -> ThreadingHTTPServer:
    """The service's HTTP server over ``frontend``, bound to ``(host,
    port)`` (port 0 picks a free one: read ``server_port``) and not yet
    serving — :func:`serve_http` runs it; an embedding caller runs
    ``serve_forever()`` on a thread of its own and stops it with
    ``shutdown()``."""
    return ThreadingHTTPServer((host, port), make_handler(frontend))


def serve_http(frontend: ServingFrontend, host: str, port: int,
               ready: "threading.Event | None" = None) -> None:
    httpd = make_server(frontend, host, port)
    print(f"FPTC archive service on http://{host}:{httpd.server_port} "
          f"(fill target {frontend.fill_target})", flush=True)
    if ready is not None:
        ready.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        frontend.close(drain=True)


# ---------------------------------------------------------------------------
# Replay mode.
# ---------------------------------------------------------------------------
def run_replay(frontend: ServingFrontend, args) -> None:
    cfg = TrafficConfig(
        rate=args.rate,
        duration_s=args.duration,
        fixed_windows=8 if args.smoke else None,
        seed=args.seed,
    )
    requests = generate(
        cfg, frontend.tables, device=frontend.decoder.device
    )
    print(f"replaying {len(requests)} requests at {args.rate:g} rps "
          f"for {args.duration:g}s ...", flush=True)
    try:
        report = replay(frontend, requests, deadline_ms=args.slo_ms)
        stats = frontend.stats_snapshot()
    finally:
        frontend.close(drain=True)
    for k, v in report.summary().items():
        print(f"  {k:>16}: {v:.2f}" if isinstance(v, float) else
              f"  {k:>16}: {v}")
    print(f"  {'batches':>16}: {stats.batches} "
          f"(mean size {stats.mean_batch_size:.2f}; "
          f"{stats.fill_dispatches} fill / "
          f"{stats.deadline_dispatches} deadline / "
          f"{stats.forced_dispatches} forced)")
    print(f"  {'deadline misses':>16}: {stats.deadline_misses}")
    print(f"  {'max inflight':>16}: {stats.max_inflight}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replay", action="store_true",
                    help="synthetic open-loop traffic instead of HTTP")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed-size replay")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--slo-ms", type=float, default=250.0)
    ap.add_argument("--slack-ms", type=float, default=5.0)
    ap.add_argument("--no-pipeline", action="store_true",
                    help="synchronous engines (debugging)")
    ap.add_argument("--no-quarantine", action="store_true",
                    help="batch-fatal container faults (offline contract)")
    ap.add_argument("--retries", type=int, default=2,
                    help="transient-fault retry budget per request")
    ap.add_argument("--watchdog-ms", type=float, default=10_000.0,
                    help="dispatcher watchdog timeout (0 disables)")
    ap.add_argument("--device", default=None,
                    help="the engines' device: every visible card when "
                    "omitted, 'cpu' for the plain PyTorch versions")
    ap.add_argument("--policy", default=None, choices=POLICY_NAMES,
                    help="the bucket-edge ladder (default: "
                    "$FPTC_BUCKET_POLICY, else p2)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.rate, args.duration = 50.0, 0.5
        args.replay = True

    frontend = build_frontend(args)
    settle_heap()  # keep full collections off the long-lived heap
    if args.replay:
        run_replay(frontend, args)
    else:
        serve_http(frontend, args.host, args.port)


if __name__ == "__main__":
    main()

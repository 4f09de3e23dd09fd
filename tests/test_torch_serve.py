"""The port's archive service (``repro_torch.launch.serve``) over a real
socket on 127.0.0.1: every route and status code of the reference's
``repro/launch/serve.py`` — 200 for ``/v1/{encode,decode,transcode}``
(bodies equal to the port's offline engines), 422 with the typed
quarantine record for each corrupt-container fault class, 429 with the
queue's depth and bound and a ``Retry-After`` on a shed, 400 for an
expired deadline or a transcode without ``?dst=``, 404 for an unknown
route or domain, 503 for a dispatch the retry machinery gave up on and
for a closed frontend, ``/healthz`` 200 or 503 and ``/statz`` — plus the
replay mode through ``main``.  No JAX: the engines run on
``device="cpu"``, and the card's run is ``chip_smoke.py``'s serve phase.
"""
import http.client
import json
import threading
import types

import numpy as np
import pytest

from repro_torch.core import DOMAIN_DEFAULTS, calibrate, encode
from repro_torch.data import make_signal
from repro_torch.launch import serve
from repro_torch.serving import (
    BatchDecoder,
    BatchEncoder,
    FrontendConfig,
    RetryPolicy,
    ServingFrontend,
    Transcoder,
    build_domain_tables,
)
from repro_torch.testing.faults import (
    CONTAINER_FAULTS,
    EXPECTED_FAULT,
    DispatcherFaultInjector,
    corrupt,
)

CPU = "cpu"


@pytest.fixture(scope="module")
def tables():
    return build_domain_tables(calib_len=8192)


class Service:
    """One frontend behind ``serve.make_server`` on a free port, served by
    a thread of its own until :meth:`stop`."""

    def __init__(self, tables, **kw):
        self.frontend = ServingFrontend(tables, device=CPU, **kw)
        self.server = serve.make_server(self.frontend, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def call(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(
            "127.0.0.1", self.server.server_port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)
        assert not self.thread.is_alive()
        self.frontend.close()


@pytest.fixture(scope="module")
def service(tables):
    svc = Service(tables, config=FrontendConfig(default_slo_ms=5_000.0,
                                                flush_slack_ms=4_990.0))
    yield svc
    svc.stop()


@pytest.fixture(scope="module")
def blobs(tables, service):
    """A v2 container (domain 2) from the service's encode route, and a v3
    one for the v3-only fault."""
    sig = make_signal("load_power", 16 * tables[2].config.n, seed=5)
    code, _, blob = service.call("POST", "/v1/encode?domain_id=2",
                                 sig.astype("<f4").tobytes())
    assert code == 200
    v3 = calibrate(make_signal("load_power", 8192, seed=1002),
                   DOMAIN_DEFAULTS["power"].replace(
                       predictor="delta", predict_bands=2, zero_planes=True),
                   domain_id=2)
    return sig, blob, encode(sig, v3).to_bytes()


def test_routes_answer_like_the_offline_engines(tables, service, blobs):
    sig, blob, _ = blobs
    dec = BatchDecoder(pipeline=False, device=CPU)
    enc = BatchEncoder(pipeline=False, device=CPU)
    tr = Transcoder(decoder=dec, encoder=enc)
    want = enc.encode([sig], tables[2]).to_host()[0]
    assert blob == want.to_bytes()
    code, hdr, raw = service.call("POST", "/v1/decode", blob)
    assert code == 200 and hdr["Content-Type"] == "application/octet-stream"
    assert raw == dec.decode([want], tables[2]).to_host()[0].astype(
        "<f4").tobytes()
    code, _, out = service.call("POST", "/v1/transcode?dst=3", blob)
    assert code == 200
    assert out == tr.transcode([want], tables[2], tables[3],
                               dst_domain_ids=[3]).to_host()[0].to_bytes()


@pytest.mark.parametrize("fault", CONTAINER_FAULTS)
def test_corrupt_container_gets_422_with_its_fault(service, blobs, fault):
    _, blob, blob_v3 = blobs
    src = blob_v3 if fault == "reserved-flags" else blob
    for route in ("/v1/decode", "/v1/transcode?dst=3"):
        code, hdr, body = service.call("POST", route,
                                       corrupt(src, fault, seed=13))
        rec = json.loads(body)
        assert code == 422 and hdr["Content-Type"] == "application/json"
        assert rec["error"] == "poisoned-container"
        assert rec["fault"] in EXPECTED_FAULT[fault], (route, rec)
        assert set(rec) == {"error", "fault", "offset", "index", "detail"}


def test_bad_requests_get_400_and_404(service, blobs):
    _, blob, _ = blobs
    code, _, body = service.call("POST", "/v1/transcode", blob)
    assert code == 400 and "dst" in json.loads(body)["error"]
    code, _, _ = service.call("POST", "/v1/decode", blob,
                              {"X-FPTC-Deadline-Ms": "0"})
    assert code == 400
    for method in ("GET", "POST"):
        code, _, body = service.call(method, "/v1/nowhere", b"")
        assert code == 404 and "no route" in json.loads(body)["error"]
    sig = np.zeros(64, "<f4")
    code, _, body = service.call("POST", "/v1/encode?domain_id=7",
                                 sig.tobytes())
    assert code == 404 and "domain_id=7" in json.loads(body)["error"]


def test_healthz_and_statz(service, blobs):
    code, hdr, body = service.call("GET", "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert hdr["Content-Type"] == "application/json"
    code, _, body = service.call("GET", "/statz")
    statz = json.loads(body)
    assert code == 200
    assert statz["stats"]["completed"] >= 1
    assert statz["fill_target"] == service.frontend.fill_target
    assert set(statz) == {"health", "stats", "mean_batch_size", "inflight",
                          "queues", "fill_target"}


def test_shed_gets_429_with_depth_bound_and_retry_after(tables, blobs):
    """A queue bound of 1 and deadlines a minute out: the second request
    on the queue is shed with the evidence, the first completes on the
    flush."""
    _, blob, _ = blobs
    svc = Service(tables, config=FrontendConfig(
        max_batch=8, max_queue_depth=1, default_slo_ms=60_000.0))
    try:
        first = {}
        waiter = threading.Thread(target=lambda: first.update(
            zip(("code", "hdr", "body"),
                svc.call("POST", "/v1/decode", blob))))
        waiter.start()
        for _ in range(200):  # the first request is queued
            if svc.frontend.queue_depths():
                break
            threading.Event().wait(0.01)
        code, hdr, body = svc.call("POST", "/v1/decode", blob)
        rec = json.loads(body)
        assert code == 429 and hdr["Retry-After"] == "1"
        assert rec["error"] == "shed"
        assert (rec["depth"], rec["bound"]) == (1, 1)
        svc.frontend.flush()
        waiter.join(60)
        assert not waiter.is_alive() and first["code"] == 200
    finally:
        svc.stop()


def test_dispatch_failure_gets_503_and_healthz_degrades(tables, blobs):
    _, blob, _ = blobs
    inj = DispatcherFaultInjector(fail_on={1})
    svc = Service(tables, fault_injector=inj, config=FrontendConfig(
        default_slo_ms=5_000.0, retry=RetryPolicy(max_retries=0)))
    try:
        code, hdr, body = svc.call("POST", "/v1/decode", blob)
        assert code == 503 and hdr["Retry-After"] == "1"
        assert json.loads(body)["error"] == "dispatch-failed"
        code, _, body = svc.call("GET", "/healthz")
        health = json.loads(body)
        assert code == 503 and health["status"] == "degraded"
        assert health["events"]
        code, _, _ = svc.call("POST", "/v1/decode", blob)  # serves on
        assert code == 200
    finally:
        svc.stop()


def test_closed_frontend_gets_503(tables, blobs):
    _, blob, _ = blobs
    svc = Service(tables)
    try:
        svc.frontend.close()
        code, _, body = svc.call("POST", "/v1/decode", blob)
        assert code == 503 and json.loads(body)["error"] == "shutting down"
        code, _, body = svc.call("GET", "/healthz")
        assert code == 503 and json.loads(body)["status"] == "closed"
    finally:
        svc.stop()


def test_replay_mode_through_main(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: the
    replay report, every request completed."""
    serve.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    lines = dict(line.split(":", 1) for line in out.splitlines()
                 if ":" in line and not line.startswith("replaying"))
    stats = {k.strip(): v.strip() for k, v in lines.items()}
    assert int(stats["submitted"]) == int(stats["completed"]) > 0
    assert int(stats["shed"]) == int(stats["failed"]) == 0


def test_no_device_means_the_card(monkeypatch):
    """``build_frontend`` with no ``--device`` builds its engines on the
    card, and raises without one: no quiet CPU fallback."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(serve, "build_domain_tables",
                        lambda seed: {0: calibrate(
                            make_signal("load_power", 4096, seed=seed),
                            DOMAIN_DEFAULTS["power"])})
    args = types.SimpleNamespace(
        seed=0, max_batch=64, queue_depth=256, slo_ms=250.0, slack_ms=5.0,
        no_quarantine=False, retries=2, watchdog_ms=0.0, no_pipeline=False,
        device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_frontend(args)
    fe = serve.build_frontend(types.SimpleNamespace(**{**vars(args),
                                                       "device": CPU}))
    try:
        assert fe.decoder.device.type == "cpu"
        assert fe.config.default_slo_ms == 250.0
    finally:
        fe.close()

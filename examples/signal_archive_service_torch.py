"""The paper's deployment scenario end to end on the PyTorch port: a fleet
of sensors streams signal strips to a central server, which batch-compresses
them into an archive, later batch-decompresses it, and eventually MIGRATES
it to a new codec config — all through the batched serving engines.  The
twin of ``examples/signal_archive_service.py``, on one device: the card
unless ``--device cpu`` asks for the plain PyTorch versions.

Server-side ingest arrives through the always-on serving front-end
(``repro_torch.serving.ServingFrontend``): each sensor submits its strip
from its own thread (admission is thread-safe and bounded — a flooded queue
sheds with a typed error instead of silently dropping), and the
front-end's deadline micro-batcher forms the buckets that ride the batched
*encode* engine (``repro_torch.serving.BatchEncoder``): each bucket is one
DCT + quantize launch and one chunk-parallel SymLen pack launch, with the
encode tables resident in the plan cache.  Micro-batching changes only
when buckets run: the archived containers are byte-identical to an offline
``BatchEncoder.encode`` of the same strips (asserted below).  The archive
drain mirrors it through the batched decode engine
(``repro_torch.serving.BatchDecoder``): one bucket decode per (domain,
config) group, outputs staying on the device until the final
``to_host()`` drain.

The migration stage is the transcode pipeline
(``repro_torch.serving.Transcoder``): the archive is re-encoded under a
coarser cold-storage config (half the retained coefficients) with decode
and re-encode composed on the device — no decoded-signal drain, no host
re-stage, byte-identical to the decode-to-host-then-re-encode round trip,
one drain at the end.

Bucket staging and upload double-buffer against device compute
(``--no-pipeline`` to compare against the strict serial loop); neither
changes a single output byte.

  PYTHONPATH=src python examples/signal_archive_service_torch.py \\
      [--fleet 8] [--device cpu]
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.core import DOMAIN_DEFAULTS, calibrate
from repro_torch.core.container import Container
from repro_torch.core.metrics import prd
from repro_torch.data import SignalPipeline, make_signal
from repro_torch.data.signals import domain_of
from repro_torch.serving import (
    BatchDecoder,
    BatchEncoder,
    FrontendConfig,
    ServingFrontend,
    Transcoder,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=8)
    ap.add_argument("--dataset", default="temperature")
    ap.add_argument("--strip", type=int, default=65536)
    ap.add_argument(
        "--no-pipeline", action="store_true",
        help="disable the double-buffered bucket staging (serial loop)",
    )
    ap.add_argument("--device", default=None,
                    help="the engines' device: the card when omitted, "
                    "'cpu' for the plain PyTorch versions")
    args = ap.parse_args()
    pipeline = not args.no_pipeline
    device = args.device

    dom = domain_of(args.dataset)
    tables = calibrate(
        np.concatenate(
            [make_signal(args.dataset, 65536, seed=90 + i) for i in range(4)]
        ),
        DOMAIN_DEFAULTS[dom],
    )

    # --- acquisition fleet: one pipeline per device, sharded streams ------
    originals = []
    for dev_id in range(args.fleet):
        pipe = SignalPipeline(
            args.dataset, strip_length=args.strip,
            host_id=dev_id, num_hosts=args.fleet,
        )
        originals.append(pipe.strip(0))

    # --- server-side ingest through the serving front-end ------------------
    # every sensor submits from its own thread; the deadline micro-batcher
    # forms the encode buckets (fill at the policy edge, or the oldest
    # deadline's slack — whichever first)
    encoder = BatchEncoder(pipeline=pipeline, device=device)
    frontend = ServingFrontend(
        tables, encoder=encoder, pipeline=pipeline, device=encoder.device,
        config=FrontendConfig(
            max_batch=max(args.fleet, 1), default_slo_ms=60_000.0,
        ),
    )
    print(f"serving engines: pipeline={'on' if pipeline else 'off'}, "
          f"device {encoder.device}")
    t0 = time.time()
    futures = [None] * args.fleet
    threads = [
        threading.Thread(
            target=lambda i=i: futures.__setitem__(
                i, frontend.submit_encode(originals[i], tables.domain_id)
            )
        )
        for i in range(args.fleet)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    frontend.flush()
    containers = [f.result() for f in futures]
    archive = [c.to_bytes() for c in containers]
    enc_s = time.time() - t0
    fstats = frontend.stats_snapshot()
    frontend.close()
    raw_mb = args.fleet * args.strip * 4 / 1e6
    comp_mb = sum(len(b) for b in archive) / 1e6
    print(f"front-end ingest of {args.fleet} strips: {raw_mb:.1f} MB raw -> "
          f"{comp_mb:.2f} MB archived (CR {raw_mb/comp_mb:.1f}x) "
          f"in {enc_s:.2f}s ({fstats.batches} micro-batch(es), "
          f"{encoder.stats.dispatches} bucket encode(s))")

    # micro-batching changes scheduling, never bytes: the served archive
    # matches an offline batch encode of the same strips
    offline = BatchEncoder(pipeline=pipeline, device=device).encode(
        originals, tables
    ).to_host()
    assert [c.to_bytes() for c in offline] == archive, (
        "front-end ingest must be byte-identical to offline batch encode"
    )

    # --- server-side batch decompression ----------------------------------
    decoder = BatchDecoder(pipeline=pipeline, device=device)
    t0 = time.time()
    containers = [Container.from_bytes(blob) for blob in archive]
    batch = decoder.decode(containers, tables)  # bucket decodes, on device
    recs = batch.to_host()  # single drain
    dec_s = time.time() - t0
    out_mb = sum(r.nbytes for r in recs) / 1e6
    print(f"server decode: {out_mb:.1f} MB reconstructed in {dec_s:.2f}s "
          f"({out_mb/dec_s/1e3:.3f} GB/s on {decoder.device}; "
          f"{decoder.stats.dispatches} bucket decode(s) for "
          f"{len(containers)} containers)")

    worst = max(prd(o, r) for o, r in zip(originals, recs))
    print(f"worst-strip PRD: {worst:.3f}% "
          f"(domain threshold: {'2%' if dom == 'seismic' else '5%'})")

    # --- archive migration: coarser config for cold storage ---------------
    # e.g. a biomedical-grade config migrating to power-grid-style coarse
    # quantization: half the retained coefficients, fresh domain id
    cold_cfg = tables.config.replace(
        e=max(tables.config.e // 2, 1),
        b1=min(tables.config.b1, max(tables.config.e // 2, 1)),
        b2=max(tables.config.e // 2, 1),
    )
    cold_tables = calibrate(
        np.concatenate(
            [make_signal(args.dataset, 65536, seed=90 + i) for i in range(4)]
        ),
        cold_cfg,
        domain_id=tables.domain_id + 1,
    )

    transcoder = Transcoder(pipeline=pipeline, device=device)
    t0 = time.time()
    migrated = transcoder.transcode(containers, tables, cold_tables)
    cold_archive = [c.to_bytes() for c in migrated.to_host()]  # one drain
    mig_s = time.time() - t0

    # the round trip it replaces must produce byte-identical containers
    sigs = BatchDecoder(device=device).decode(containers, tables).to_host()
    rt = BatchEncoder(device=device).encode(sigs, cold_tables).to_host()
    assert all(
        blob == c.to_bytes() for blob, c in zip(cold_archive, rt)
    ), "device-resident migration must match the host round trip"

    cold_mb = sum(len(b) for b in cold_archive) / 1e6
    print(f"archive migration e={tables.config.e}->{cold_cfg.e}: "
          f"{comp_mb:.2f} MB -> {cold_mb:.2f} MB "
          f"(CR {raw_mb/cold_mb:.1f}x) in {mig_s:.2f}s, decode and "
          "re-encode composed on the device — byte-identical to the host "
          "round trip, no host sync between decode and re-encode")
    for engine in (decoder, transcoder):
        engine.close()


if __name__ == "__main__":
    main()

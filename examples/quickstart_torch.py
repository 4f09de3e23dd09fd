"""FPTC quickstart on the PyTorch port: calibrate -> encode -> decode ->
metrics.  The twin of ``examples/quickstart.py``; the server-side decode
runs on the card unless ``--device cpu`` asks for the plain PyTorch
versions.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    DOMAIN_DEFAULTS,
    calibrate,
    decode,
    decode_device,
    encode,
)
from repro_torch.core.container import Container
from repro_torch.core.metrics import prd
from repro_torch.data import make_signal


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the decode's device: the card when omitted, "
                    "'cpu' for the plain PyTorch versions")
    args = ap.parse_args()

    # 1. calibrate once per signal domain on representative data (paper §3.4)
    calib_signal = np.concatenate(
        [make_signal("load_power", 65536, seed=90 + i) for i in range(4)]
    )
    tables = calibrate(calib_signal, DOMAIN_DEFAULTS["power"])
    print(f"codebook: {tables.book.num_active} symbols, "
          f"L_max={tables.book.l_max}, "
          f"avg codeword {tables.book.expected_bits(tables.hist):.2f} bits")

    # 2. encode on the (simulated) embedded device — single pass, table-driven
    signal = make_signal("load_power", 1 << 18, seed=7)
    container = encode(signal, tables)
    print(f"compressed {container.original_bytes/1e6:.2f} MB -> "
          f"{container.compressed_bytes/1e6:.3f} MB "
          f"(CR {container.compression_ratio:.1f}x, "
          f"{container.num_words} SymLen words)")

    # 3. container bytes travel to the server...
    blob = container.to_bytes()

    # 4. ...which decodes at scale with the word-parallel pipeline
    received = Container.from_bytes(blob)
    rec_ref = decode(received, tables)  # host reference decoder
    rec_par = decode_device(received, tables, device=args.device)
    print(f"PRD {prd(signal, rec_par):.3f}%  "
          f"(ref vs parallel max diff "
          f"{np.abs(rec_ref - rec_par).max():.2e})")


if __name__ == "__main__":
    main()

"""Per-backend dispatch cost model for the serving engines' shape decisions.
Port of ``repro/tuning/cost_model.py``.

The model predicts the wall cost of one bucket dispatch from (words,
windows, batch, launch shape, backend) with a plain roofline:

    t = flops / peak_flops + bytes / hbm_bps
        + steps * step_overhead_s + dispatch_overhead_s

The analytic flop/byte counts are the reference's (the slot-loop Huffman
decode, the 256-level LUT select, the iDCT / DCT, the one-hot codeword
lookups, the chunk pack), so the ``cpu`` profile predicts what the
reference's does.  A model can be *seeded* — rescaled so the analytic
count reproduces another count of the same shape — and *refined* by timing
samples (:meth:`CostModel.observe`).  The ``cuda`` default is seeded from
the port's own counts of its H100 kernels (:func:`port_decode_counts`,
:func:`port_encode_counts`: each input read once, each output written
once, the fp32 FLOPs of the transform — the counts ``chip_smoke.py``'s
bounds use), never from the reference's jaxpr costs.

``steps`` charges what the port's launch shapes cost
(:mod:`repro_torch.kernels.tiles`): the windows padded to the last tile,
and the waves of tiles over the CTAs the card holds at once at that tile's
shared memory.

Three consumers:

  * :func:`repro_torch.tuning.policy.cost_balanced_policy` picks the
    bucket-edge density where the padded-work saving of a denser ladder
    stops paying for a new bucket shape's first-call cost;
  * ``serving.engine.BucketScheduler`` splits each key group's members into
    per-device shards balanced by :meth:`CostModel.signal_decode_cost` /
    :meth:`signal_encode_cost` instead of equal counts;
  * :func:`repro_torch.tuning.autotune.tune` ranks candidate launch shapes
    with :meth:`decode_bucket_cost` / :meth:`encode_bucket_cost`.

All numbers are *relative* by design — shard balancing and candidate
ranking only need ordering.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import tiles

__all__ = [
    "BackendProfile",
    "CostModel",
    "default_cost_model",
    "backend_of",
    "port_decode_counts",
    "port_encode_counts",
]


@dataclasses.dataclass(frozen=True)
class BackendProfile:
    """Static roofline numbers for one backend.

    ``sms`` is the streaming multiprocessors the resident CTAs spread over
    (1 where the backend runs no CUDA kernel).  The ``cpu`` numbers are the
    reference's order-of-magnitude ones; the ``cuda`` numbers are the
    H100's (see ``_PROFILES``).
    """

    backend: str
    peak_flops: float  # FLOP/s
    hbm_bps: float  # bytes/s
    dispatch_overhead_s: float  # per bucket dispatch (host launch work)
    step_overhead_s: float  # per wave of tiles inside a kernel
    compile_cost_s: float  # per new bucket shape's first call
    sms: int = 1


_PROFILES: Dict[str, BackendProfile] = {
    "cpu": BackendProfile("cpu", 5e10, 2e10, 3e-5, 2e-7, 0.5),
    # The H100's data-sheet peaks (fp32 outside the tensor cores, device
    # memory), as chip_smoke.py's bounds take them.  dispatch_overhead_s:
    # the host time of one kernel wrapper call, 23-42 us for K1
    # (symlen_profile.py, NVIDIA H100 80GB HBM3, 700.00 W).
    # compile_cost_s: a new bucket shape's first call less its warm call
    # (new pinned staging buffers and device blocks; there is no jit),
    # the median of eight new decode shapes over two runs, 0.06-6.0 ms
    # each (chip_smoke.py's tune phase, NVIDIA H100 80GB HBM3, 700.00 W):
    # 3 edges an octave.  step_overhead_s is a modelled cost of one wave
    # of CTAs, not a measurement.
    "cuda": BackendProfile("cuda", 67e12, 3.35e12, 3.2e-5, 2e-6, 2.1e-3,
                           sms=132),
}

# analytic per-unit op counts of the reference's kernels:
#   huffman slot step: ~l_max compare/shift ops per (word, slot) iteration
_HUFFMAN_OPS_PER_SLOT = 16.0
#   LUT dequant: the fused kernel's 256-way masked select per level
_LUT_OPS_PER_LEVEL = 256.0
#   chunk pack: segment-sum + searchsorted word materialization per symbol
_PACK_OPS_PER_SYMBOL = 24.0

_CTA_THREADS = 256  # every tunable kernel's CTA
_THREADS_PER_SM = 2048
_SMEM_RESERVED = 1024  # the shared memory the card reserves per CTA

# the shapes the cuda default is seeded at: one archive bucket of
# chip_smoke.py (128 signals of 8192 windows, N = 32, E = 8, about 2
# symbols a byte of the packed words)
_SEED_E, _SEED_N, _SEED_WINDOWS = 8, 32, 1 << 20
_SEED_WORDS = _SEED_WINDOWS * _SEED_E // 16


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // max(int(b), 1))


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * max(int(b), 1)


def backend_of(device=None) -> str:
    """The profile key of ``device``: ``"cuda"`` or ``"cpu"``.  ``None`` is
    the device the engines default to: the card when one is present."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str):
        return device.split(":")[0]
    return torch.device(device).type


def port_decode_counts(words: int, windows: int, *, e: int,
                       n: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the port's bucket decode: K1 reads each word and
    its symlen byte (9 B) and writes a level byte a symbol, ``lut_idct``
    reads them and writes the f32 windows; the FLOPs are the iDCT's 2 E N
    a window (the decode and the dequant are integer and table work)."""
    flops = 2.0 * float(windows) * e * n
    nbytes = 9.0 * float(words) + 2.0 * float(windows) * e
    return flops, nbytes + 4.0 * float(windows) * n


def port_encode_counts(rows: int, windows_per_row: int, *, e: int,
                       n: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the port's bucket encode: ``encode_levels`` reads
    the f32 rows and writes a level byte a symbol, ``symlen_pack`` reads
    them and writes the chunk parts (12 B a word, about a word per four
    symbols); the FLOPs are the DCT's 2 N E a window."""
    windows = float(rows) * windows_per_row
    flops = 2.0 * windows * n * e
    nbytes = 4.0 * windows * n + 2.0 * windows * e
    return flops, nbytes + 12.0 * windows * e / 4.0


def _resident(profile: BackendProfile, smem: int) -> int:
    """CTAs of 256 threads the backend holds at once at ``smem`` bytes of
    shared memory each."""
    per_sm = min(_THREADS_PER_SM // _CTA_THREADS,
                 tiles.H100_SMEM_PER_SM // (int(smem) + _SMEM_RESERVED))
    return max(profile.sms * max(per_sm, 1), 1)


class CostModel:
    """Predicts bucket-dispatch cost; thread-safe (engines share one).

    ``seed(kind, flops, hbm_bytes, **shape)`` rescales the analytic model
    so its raw counts reproduce another count of the same shape;
    ``observe(kind, predicted_s, measured_s)`` records a wall-time sample
    whose running median multiplies later predictions of that kind.
    """

    def __init__(
        self,
        profile: Optional[BackendProfile] = None,
        *,
        backend=None,
    ):
        if profile is None:
            profile = _PROFILES.get(backend_of(backend), _PROFILES["cpu"])
        self.profile = profile
        self._lock = threading.Lock()
        # kind -> (flops scale, bytes scale) from seeding
        self._seed: Dict[str, Tuple[float, float]] = {}
        # kind -> measured/predicted wall-time ratios (bounded history)
        self._samples: Dict[str, deque] = {}

    # -- analytic op counts -------------------------------------------------
    def decode_flops(
        self,
        words: int,
        windows: int,
        *,
        e: int,
        n: int,
        max_symlen: int = 8,
    ) -> float:
        """Raw FLOP count of one bucket decode: slot-loop Huffman over the
        words, 256-level LUT dequant and the iDCT over the windows
        (padding words/windows pay full price — that is the point: the
        model sees the cost of a policy's padding)."""
        huff = float(words) * max(max_symlen, 1) * _HUFFMAN_OPS_PER_SLOT
        dequant = float(windows) * e * _LUT_OPS_PER_LEVEL
        idct = 2.0 * float(windows) * e * n
        return huff + dequant + idct

    def decode_bytes(
        self, words: int, windows: int, *, e: int, n: int
    ) -> float:
        """Boundary memory traffic of one bucket decode: the packed words
        (hi/lo/symlen, 12 B each) in, the window tensor out."""
        return 12.0 * float(words) + 4.0 * float(windows) * n

    def encode_flops(
        self, rows: int, windows_per_row: int, *, e: int, n: int
    ) -> float:
        """Raw FLOP count of one bucket encode: the DCT, the one-hot
        codeword lookups and the chunk pack, all over the padded
        ``rows x windows_per_row`` bucket."""
        syms = float(rows) * windows_per_row * e
        dct = 2.0 * float(rows) * windows_per_row * n * e
        onehot = 2.0 * syms * 256.0 * 2.0  # code + length lookups
        pack = syms * _PACK_OPS_PER_SYMBOL
        return dct + onehot + pack

    def encode_bytes(
        self, rows: int, windows_per_row: int, *, e: int, n: int
    ) -> float:
        samples_in = 4.0 * float(rows) * windows_per_row * n
        words_out = 12.0 * float(rows) * windows_per_row * e / 4.0
        return samples_in + words_out

    # -- seeding / calibration ---------------------------------------------
    def seed(
        self, kind: str, flops: float, hbm_bytes: float, **shape
    ) -> None:
        """Rescale the analytic model so its raw counts for ``shape``
        reproduce another estimate of the same shape (``kind`` is
        ``"decode"`` or ``"encode"``; ``shape`` carries the keywords the
        matching ``*_flops`` method takes)."""
        if kind == "decode":
            raw_f = self.decode_flops(**shape)
            raw_b = self.decode_bytes(
                **{k: v for k, v in shape.items() if k != "max_symlen"}
            )
        elif kind == "encode":
            raw_f = self.encode_flops(**shape)
            raw_b = self.encode_bytes(**shape)
        else:
            raise ValueError(f"unknown cost kind {kind!r}")
        with self._lock:
            self._seed[kind] = (
                flops / max(raw_f, 1.0),
                hbm_bytes / max(raw_b, 1.0),
            )

    def seed_from_cost(self, kind: str, cost, **shape) -> None:
        """Seed from any object with ``flops`` and ``hbm_bytes``."""
        self.seed(kind, cost.flops, cost.hbm_bytes, **shape)

    def observe(self, kind: str, predicted_s: float, measured_s: float):
        """Record one timing sample for ``kind``; the running median of
        measured/predicted multiplies later predictions."""
        if predicted_s <= 0 or measured_s <= 0:
            return
        with self._lock:
            self._samples.setdefault(kind, deque(maxlen=64)).append(
                measured_s / predicted_s
            )

    def calibration(self, kind: str) -> float:
        with self._lock:
            samples = sorted(self._samples.get(kind, ()))
        if not samples:
            return 1.0
        return samples[len(samples) // 2]

    def _scales(self, kind: str) -> Tuple[float, float]:
        with self._lock:
            return self._seed.get(kind, (1.0, 1.0))

    def _roofline(self, kind: str, flops: float, nbytes: float,
                  steps: int) -> float:
        sf, sb = self._scales(kind)
        p = self.profile
        t = (
            sf * flops / p.peak_flops
            + sb * nbytes / p.hbm_bps
            + steps * p.step_overhead_s
            + p.dispatch_overhead_s
        )
        return t * self.calibration(kind)

    # -- bucket dispatch predictions ---------------------------------------
    def decode_bucket_cost(
        self,
        words: int,
        windows: int,
        *,
        e: int,
        n: int,
        max_symlen: int = 8,
        idct_rw: int = 0,
        v3_tile_windows: int = 0,
    ) -> float:
        """Predicted seconds for one bucket decode of ``words`` packed words
        / ``windows`` output windows under the given launch shapes
        (``idct_rw``: ``lut_idct``'s register tile; ``v3_tile_windows``: the
        v3 stage's tile, 0 where the bucket has no v3 coding; either 0 is
        the kernel's own pick).  Each stage pads the windows to its last
        tile and pays a step per wave of tiles over the CTAs the card holds
        at that tile's shared memory."""
        t = tiles.idct_tile_shape(e, n, idct_rw)
        if t is None:
            raise ValueError(f"lut_idct takes no rw={idct_rw} at E={e}, "
                             f"N={n}")
        nwp = _round_up(max(windows, 1), t.bw)
        steps = _ceil_div(
            _ceil_div(nwp, t.bw), _resident(self.profile, t.smem)
        )
        if v3_tile_windows:
            if not tiles.v3_tile_ok(v3_tile_windows, e):
                raise ValueError(f"the v3 stage takes no tile of "
                                 f"{v3_tile_windows} windows at E={e}")
            nwp = max(nwp, _round_up(max(windows, 1), v3_tile_windows))
            steps += _ceil_div(
                _ceil_div(windows, v3_tile_windows),
                _resident(self.profile, v3_tile_windows * (e + 1)),
            )
        return self._roofline(
            "decode",
            self.decode_flops(words, nwp, e=e, n=n, max_symlen=max_symlen),
            self.decode_bytes(words, nwp, e=e, n=n),
            steps,
        )

    def encode_bucket_cost(
        self,
        rows: int,
        windows_per_row: int,
        *,
        e: int,
        n: int,
        levels_rw: int = 0,
    ) -> float:
        """Predicted seconds for one bucket encode: ``rows``
        (batch-padded) signal rows of ``windows_per_row`` windows each,
        under ``encode_levels``' register tile ``levels_rw`` (0: the
        kernel's own pick); each row pads to its last tile."""
        t = tiles.dct_tile_shape(n, e, levels_rw)
        if t is None:
            raise ValueError(f"encode_levels takes no rw={levels_rw} at "
                             f"N={n}, E={e}")
        wpr = _round_up(max(windows_per_row, 1), t.bw)
        steps = _ceil_div(
            max(rows, 1) * (wpr // t.bw), _resident(self.profile, t.smem)
        )
        return self._roofline(
            "encode",
            self.encode_flops(rows, wpr, e=e, n=n),
            self.encode_bytes(rows, wpr, e=e, n=n),
            steps,
        )

    # -- per-signal costs (shard balancing) --------------------------------
    def signal_decode_cost(
        self,
        words: int,
        windows: int,
        *,
        e: int,
        n: int,
        max_symlen: int = 8,
    ) -> float:
        """One signal's share of a decode bucket — what the scheduler's
        cost-balanced shard split weighs (relative units)."""
        sf, _ = self._scales("decode")
        return sf * self.decode_flops(
            words, windows, e=e, n=n, max_symlen=max_symlen
        )

    def signal_encode_cost(
        self, windows: int, *, e: int, n: int
    ) -> float:
        """One signal's share of an encode bucket (relative units)."""
        sf, _ = self._scales("encode")
        return sf * self.encode_flops(1, windows, e=e, n=n)

    # -- policy support -----------------------------------------------------
    def edges_per_octave(
        self,
        *,
        ref_words: int = 1 << 16,
        ref_dispatches: int = 1 << 17,
        max_density: int = 4,
    ) -> int:
        """Bucket-edge density where a denser ladder stops paying.

        Going from ``d`` to ``d + 1`` edges per octave shrinks the expected
        padded fraction of every dispatch (for a geometric ladder of ratio
        ``r = 2**(1/d)`` the expected occupancy of a uniformly-sized bucket
        is ``(1 - 1/r) / ln r``) but adds roughly one new bucket shape per
        octave in use.  Accept the denser ladder while the padded-word
        seconds saved over ``ref_dispatches`` dispatches of a
        ``ref_words``-word bucket exceed one ``compile_cost_s``.
        """
        def waste(d: int) -> float:
            r = 2.0 ** (1.0 / d)
            return 1.0 - (1.0 - 1.0 / r) / math.log(r)

        p = self.profile
        per_word_s = (
            self.decode_flops(1, 0, e=1, n=1) / p.peak_flops
            + 12.0 / p.hbm_bps
        )
        d = 1
        while d < max_density:
            saved = (
                (waste(d) - waste(d + 1))
                * ref_words
                * per_word_s
                * ref_dispatches
            )
            if saved < p.compile_cost_s:
                break
            d += 1
        return d


_DEFAULTS: Dict[str, CostModel] = {}
_DEFAULTS_LOCK = threading.Lock()


def default_cost_model(backend=None) -> CostModel:
    """Process-wide shared model per backend (``"cuda"`` or ``"cpu"``, or a
    device; None is the engines' default device).  Engines constructed
    with ``cost_model=None`` resolve here.  The ``cuda`` model is seeded
    from the port's own kernel counts at an archive bucket's shape."""
    key = backend_of(backend)
    with _DEFAULTS_LOCK:
        cm = _DEFAULTS.get(key)
        if cm is None:
            cm = _DEFAULTS[key] = CostModel(backend=key)
            if key == "cuda":
                shape = dict(e=_SEED_E, n=_SEED_N)
                cm.seed("decode", *port_decode_counts(
                    _SEED_WORDS, _SEED_WINDOWS, **shape),
                    words=_SEED_WORDS, windows=_SEED_WINDOWS, **shape)
                rows, wpr = 128, _SEED_WINDOWS // 128
                cm.seed("encode", *port_encode_counts(rows, wpr, **shape),
                        rows=rows, windows_per_row=wpr, **shape)
        return cm

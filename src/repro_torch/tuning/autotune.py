"""Launch-shape autotuner for the H100 kernels, with a persisted on-disk
tuning cache.  Port of ``repro/tuning/autotune.py``.

The kernels pick their own launch shapes (:mod:`repro_torch.kernels.tiles`);
this module sweeps the shapes a launcher accepts on the card and records
the winner in a :class:`TuningCache`:

  * **keyed like the reference's** — by (kind, backend, plan key, bucket
    shape), where the backend is ``cuda:<device name>`` (or ``cpu``), so an
    entry is as specific as the launch it configures;
  * **the port's own knobs** — a decode entry holds ``idct_rw`` (4 or 8:
    ``lut_idct``'s register tile) and, for a v3 coding,
    ``v3_tile_windows`` (a multiple of 256: the v3 stage's tile); an encode
    entry holds ``levels_rw`` (1, 2 or 4: ``encode_levels``' register
    tile).  An entry naming a shape its launcher refuses is dropped at
    lookup and re-tuned;
  * **persisted** — JSON under the ``FPTC_TUNING_CACHE`` directory (unset:
    in memory only), written atomically (tmp + ``os.replace``), loaded
    lazily; corrupt files and stale or invalid entries are rejected, never
    trusted.  The file is the reference's (``fptc_tuning.json``, the same
    version): each package keeps the other's entries;
  * **thread-safe** — one ``RLock`` around the in-memory map and the file.

``kernels.decode_fused.decode_fused`` and ``kernels.encode_fused.
encode_fused`` / ``encode_fused_gather`` consult :func:`tuned_blocks` when
the caller did not pin the shapes (the engines do not).  Every consult
goes through the kernel module's :class:`BlockMemo`, which reads the cache
once per bucket shape and :func:`epoch` (bumped on every store and
default-cache swap), so a warm bucket pays a dict lookup and an integer
compare.  A cold cache changes nothing: every launch takes the kernel's
own pick.  On the card the launchers themselves say which shapes they
accept (:func:`~repro_torch.kernels.tiles.launcher_idct_tile` and its
siblings); the tuner offers and keeps nothing else.  Launch shapes change scheduling only — never an output
bit (the kernels' bit contracts).

    python -m repro_torch.tuning.autotune [--smoke] [--cache-dir DIR]

warms the cache on the card for the serving domains' common bucket shapes.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import tiles

__all__ = [
    "TuningCache",
    "BlockMemo",
    "default_cache",
    "set_default_cache",
    "epoch",
    "backend_key",
    "blocks_legal",
    "tuned_blocks",
    "tune",
    "decode_block_candidates",
    "encode_block_candidates",
    "decode_bucket_inputs",
    "encode_bucket_inputs",
    "tune_decode_bucket",
    "tune_encode_bucket",
]

ENV_DIR = "FPTC_TUNING_CACHE"
CACHE_VERSION = 1
_CACHE_FILE = "fptc_tuning.json"
# sanity range for any persisted block value: rejects corrupt/stale entries
_MAX_BLOCK = 1 << 20

Blocks = Dict[str, int]


def _entry_key(
    kind: str, backend: str, plan_key: Sequence, shape: Sequence[int]
) -> str:
    plan = ",".join(str(int(p)) for p in plan_key)
    shp = "x".join(str(int(s)) for s in shape)
    return f"{kind}|{backend}|plan({plan})|shape({shp})"


def _valid_blocks(blocks) -> bool:
    if not isinstance(blocks, dict) or not blocks:
        return False
    for k, v in blocks.items():
        if not isinstance(k, str):
            return False
        if not isinstance(v, int) or isinstance(v, bool):
            return False
        if not 1 <= v <= _MAX_BLOCK:
            return False
    return True


class TuningCache:
    """Thread-safe, optionally persisted map: tuning key -> winning blocks.

    ``directory=None`` resolves ``FPTC_TUNING_CACHE``; when that is unset
    too the cache is memory-only (same API, nothing touches disk).
    """

    def __init__(self, directory: Optional[str] = None):
        if directory is None:
            directory = os.environ.get(ENV_DIR, "").strip() or None
        self.directory = directory
        self._lock = threading.RLock()
        self._entries: Dict[str, dict] = {}
        self._loaded = False
        self.hits = 0
        self.misses = 0

    # -- persistence --------------------------------------------------------
    @property
    def path(self) -> Optional[str]:
        if self.directory is None:
            return None
        return os.path.join(self.directory, _CACHE_FILE)

    def _load_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        path = self.path
        if path is None or not os.path.exists(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, ValueError):
            return  # corrupt file: start empty; winners re-tune, overwrite
        if not isinstance(data, dict) or data.get("version") != CACHE_VERSION:
            return  # stale schema: reject wholesale, re-tune
        entries = data.get("entries")
        if not isinstance(entries, dict):
            return
        for key, entry in entries.items():
            if (
                isinstance(key, str)
                and isinstance(entry, dict)
                and _valid_blocks(entry.get("blocks"))
            ):
                self._entries[key] = entry
            # invalid entries are dropped here -> lookup misses -> re-tuned

    def _save_locked(self) -> None:
        path = self.path
        if path is None:
            return
        os.makedirs(self.directory, exist_ok=True)
        payload = {"version": CACHE_VERSION, "entries": self._entries}
        fd, tmp = tempfile.mkstemp(
            dir=self.directory, prefix=_CACHE_FILE, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # atomic: readers see old or new, whole
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- the map ------------------------------------------------------------
    def lookup(
        self,
        kind: str,
        backend: str,
        plan_key: Sequence,
        shape: Sequence[int],
    ) -> Optional[Blocks]:
        key = _entry_key(kind, backend, plan_key, shape)
        with self._lock:
            self._load_locked()
            entry = self._entries.get(key)
            if entry is None or not _valid_blocks(entry.get("blocks")):
                if entry is not None:
                    del self._entries[key]  # invalid in-memory entry
                self.misses += 1
                return None
            self.hits += 1
            return dict(entry["blocks"])

    def store(
        self,
        kind: str,
        backend: str,
        plan_key: Sequence,
        shape: Sequence[int],
        blocks: Blocks,
        *,
        sample_s: Optional[float] = None,
    ) -> None:
        if not _valid_blocks(blocks):
            raise ValueError(f"refusing to store invalid blocks {blocks!r}")
        key = _entry_key(kind, backend, plan_key, shape)
        entry = {"blocks": dict(blocks)}
        if sample_s is not None:
            entry["sample_s"] = float(sample_s)
        with self._lock:
            self._load_locked()
            self._entries[key] = entry
            self._save_locked()
        _bump_epoch()

    def discard(
        self,
        kind: str,
        backend: str,
        plan_key: Sequence,
        shape: Sequence[int],
    ) -> None:
        """Drop one entry (a shape its launcher would refuse), in memory and
        on disk; the next sweep of its key re-tunes it."""
        key = _entry_key(kind, backend, plan_key, shape)
        with self._lock:
            self._load_locked()
            if self._entries.pop(key, None) is not None:
                self._save_locked()
        _bump_epoch()

    def __len__(self) -> int:
        with self._lock:
            self._load_locked()
            return len(self._entries)


# ---------------------------------------------------------------------------
# The process-default cache + the epoch the engines key their memos on.
# ---------------------------------------------------------------------------
_STATE_LOCK = threading.Lock()
_DEFAULT: Optional[TuningCache] = None
_DEFAULT_DIR: Optional[str] = None
_PINNED = False  # set_default_cache() pins: env re-resolution must not undo
_EPOCH = 0


def _bump_epoch() -> None:
    global _EPOCH
    with _STATE_LOCK:
        _EPOCH += 1


def epoch() -> int:
    """Monotone counter bumped on every cache store / discard /
    default-cache swap.  The kernel modules keep each bucket's resolved
    shapes with the epoch they were read at (:class:`BlockMemo`), so an
    entry that
    lands after a bucket shape was first resolved still takes effect.  A
    plain read: an int load needs no lock."""
    return _EPOCH


def default_cache() -> TuningCache:
    """The process-wide cache (re-resolves ``FPTC_TUNING_CACHE`` when the
    env changes; an explicit :func:`set_default_cache` pin wins over the
    env until reset)."""
    global _DEFAULT, _DEFAULT_DIR, _EPOCH
    env_dir = os.environ.get(ENV_DIR, "").strip() or None
    with _STATE_LOCK:
        if _DEFAULT is None or (not _PINNED and _DEFAULT_DIR != env_dir):
            _DEFAULT = TuningCache(env_dir)
            _DEFAULT_DIR = env_dir
            _EPOCH += 1
        return _DEFAULT


def set_default_cache(cache: Optional[TuningCache]) -> None:
    """Pin (or with ``None`` reset to env resolution) the process-default
    cache — the pin survives later ``FPTC_TUNING_CACHE`` changes until
    reset."""
    global _DEFAULT, _DEFAULT_DIR, _PINNED, _EPOCH
    with _STATE_LOCK:
        _DEFAULT = cache
        _DEFAULT_DIR = cache.directory if cache is not None else None
        _PINNED = cache is not None
        _EPOCH += 1


# ---------------------------------------------------------------------------
# Backends and the legality of the port's knobs.
# ---------------------------------------------------------------------------
_DEVICE_INFO: Dict[int, tuple] = {}
_DEVICE_LOCK = threading.Lock()


def _device_info(index: int) -> tuple:
    """(name, opt-in shared memory a block) of CUDA device ``index``."""
    with _DEVICE_LOCK:
        info = _DEVICE_INFO.get(index)
        if info is None:
            props = torch.cuda.get_device_properties(index)
            info = _DEVICE_INFO[index] = (
                props.name, int(props.shared_memory_per_block_optin))
        return info


def _cuda_index(device) -> int:
    dev = torch.device(device)
    return dev.index if dev.index is not None else torch.cuda.current_device()


def backend_key(device=None) -> str:
    """The backend part of an entry's key: ``cuda:<device name>`` (for
    example ``cuda:NVIDIA H100 80GB HBM3``) or ``cpu``.  ``None`` is the
    current CUDA device where there is one, else the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = "cuda"
    if torch.device(device).type != "cuda":
        return "cpu"
    return "cuda:" + _device_info(_cuda_index(device))[0]


def _max_smem(device) -> int:
    if device is not None and torch.device(device).type == "cuda":
        return _device_info(_cuda_index(device))[1]
    return tiles.H100_SMEM_OPTIN


def _asks_launcher(device) -> bool:
    """Whether the launch shapes for ``device`` are the built library's to
    judge (a CUDA device, on a machine with CUDA) rather than the host
    copy's of its rules (:mod:`repro_torch.kernels.tiles`)."""
    if not torch.cuda.is_available():
        return False
    return device is None or torch.device(device).type == "cuda"


def blocks_legal(kind: str, plan_key: Sequence, blocks: Blocks, *,
                 max_smem: int = tiles.H100_SMEM_OPTIN,
                 launcher: bool = False) -> bool:
    """Whether the launchers accept ``blocks`` for this plan key: a decode
    entry's ``idct_rw`` (and, for a v3 plan key, its optional
    ``v3_tile_windows``), an encode entry's ``levels_rw``, and no other
    key.  Plan keys are :func:`~repro_torch.kernels.decode_fused.
    tuning_plan_key` (decode: ``(n, e, l_max, max_symlen[, coding])``) and
    :func:`~repro_torch.kernels.encode_fused.tuning_plan_key` (encode:
    ``(n, e, chunk[, coding])``).  ``launcher``: ask the built library's
    rules (on the card) rather than the host copy's."""
    if not _valid_blocks(blocks):
        return False
    n, e = int(plan_key[0]), int(plan_key[1])
    if kind == "decode":
        v3 = len(plan_key) > 4
        allowed = {"idct_rw", "v3_tile_windows"} if v3 else {"idct_rw"}
        if not set(blocks) <= allowed or "idct_rw" not in blocks:
            return False
        if blocks["idct_rw"] not in tiles.idct_rws(e, n, max_smem,
                                                   launcher=launcher):
            return False
        tile = blocks.get("v3_tile_windows")
        ok = tiles.launcher_v3_tile_ok if launcher else tiles.v3_tile_ok
        return tile is None or ok(tile, e)
    if kind == "encode":
        return (set(blocks) == {"levels_rw"}
                and blocks["levels_rw"] in tiles.levels_rws(
                    n, e, launcher=launcher))
    return False


def tuned_blocks(
    kind: str,
    plan_key: Sequence,
    shape: Sequence[int],
    *,
    backend: Optional[str] = None,
    device=None,
) -> Blocks:
    """The kernels' consult path: the winning blocks for this (backend,
    plan key, bucket shape), or ``{}`` when nothing is tuned (the kernels
    then take their own pick).  ``device`` names the backend (the current
    CUDA device where both are None).  An entry its launcher would refuse
    is dropped here and reads as ``{}``."""
    if backend is None:
        backend = backend_key(device)
    cache = default_cache()
    blocks = cache.lookup(kind, backend, plan_key, shape)
    if not blocks:
        return {}
    if not blocks_legal(kind, plan_key, blocks, max_smem=_max_smem(device),
                        launcher=_asks_launcher(device)):
        cache.discard(kind, backend, plan_key, shape)
        return {}
    return blocks


class BlockMemo:
    """Resolved launch shapes: (kind, plan arguments, bucket shape, device)
    -> (the :func:`epoch` they were read at, blocks).  :meth:`get` returns
    the memo while the epoch holds and consults :func:`tuned_blocks` once
    per new epoch; for a device other than CUDA it resolves ``{}`` (the
    plain versions have no launch shape).  ``plan_key`` turns the plan
    arguments into the cache's plan key (``tuning_plan_key`` of the
    kernel module), on a miss only, so a warm call builds nothing but its
    memo key.  Each kernel module that consults the
    cache keeps one.  Thread-safe: a race resolves the same key twice."""

    def __init__(self, plan_key: Callable[..., tuple]):
        self._plan_key = plan_key
        self._memo: Dict[tuple, tuple] = {}

    def get(self, kind: str, args: tuple, shape: tuple, device) -> Blocks:
        ep = _EPOCH  # read before the lookup: a later store re-resolves
        key = (kind, args, shape, device)
        hit = self._memo.get(key)
        if hit is not None and hit[0] == ep:
            return hit[1]
        blocks: Blocks = {}
        if torch.device(device).type == "cuda":
            blocks = tuned_blocks(kind, self._plan_key(*args),
                                  tuple(int(s) for s in shape),
                                  device=device)
        self._memo[key] = (ep, blocks)
        return blocks


# ---------------------------------------------------------------------------
# The sweep.
# ---------------------------------------------------------------------------
# Single-flight registry for in-progress tunes: concurrent tune() calls on
# the same (cache, key) coalesce onto one sweep instead of each running the
# candidates and each store()-ing (every store bumps the epoch and so makes
# every engine re-resolve its buckets).
_TUNE_LOCK = threading.Lock()
_TUNE_INFLIGHT: Dict[tuple, threading.Event] = {}


def decode_block_candidates(n: int, e: int, coding=(0, 0, False), *,
                            max_smem: int = tiles.H100_SMEM_OPTIN,
                            launcher: bool = False) -> List[Blocks]:
    """The decode sweep grid at (N, E): every ``idct_rw`` ``lut_idct``
    accepts, times every offered ``v3_tile_windows`` the v3 stage accepts
    when ``coding`` is non-trivial (``launcher``: by the built library's
    rules, as the sweeps on the card ask)."""
    rws = tiles.idct_rws(e, n, max_smem, launcher=launcher)
    if tuple(coding) == (0, 0, False):
        return [{"idct_rw": rw} for rw in rws]
    return [{"idct_rw": rw, "v3_tile_windows": t}
            for rw in rws for t in tiles.v3_tiles(e, launcher=launcher)]


def encode_block_candidates(n: int, e: int, *,
                            launcher: bool = False) -> List[Blocks]:
    """The encode sweep grid at (N, E): every ``levels_rw``
    ``encode_levels`` accepts (``launcher`` as
    :func:`decode_block_candidates` takes it)."""
    return [{"levels_rw": rw}
            for rw in tiles.levels_rws(n, e, launcher=launcher)]


def tune(
    kind: str,
    plan_key: Sequence,
    shape: Sequence[int],
    runner: Callable[[Blocks], Optional[float]],
    candidates: Iterable[Blocks],
    *,
    cache: Optional[TuningCache] = None,
    backend: Optional[str] = None,
    trials: int = 3,
    warmup: int = 1,
    force: bool = False,
    rank: Optional[Callable[[Blocks], float]] = None,
    top_k: Optional[int] = None,
    valid: Optional[Callable[[Blocks], bool]] = None,
    record: Optional[Callable[[Blocks, float], None]] = None,
) -> Blocks:
    """Sweep ``candidates``, record the winner, return its blocks.

    ``runner(blocks)`` must execute ONE dispatch with the candidate blocks
    and return once it finished; a runner that times itself returns its
    seconds (the card's runners: CUDA events), otherwise the host clock
    around the call counts (first-call costs are excluded by the
    ``warmup`` calls).  The cache is consulted first: a hit returns
    without running anything (``force=True`` re-tunes), unless ``valid``
    rejects it, which drops the entry and re-tunes.  ``rank`` (e.g. a
    cost-model prediction) orders candidates and ``top_k`` prunes the
    sweep to the model's best guesses; ``record(blocks, seconds)`` sees
    every candidate's time.
    """
    if cache is None:
        cache = default_cache()
    if backend is None:
        backend = backend_key()
    flight_key = (id(cache), _entry_key(kind, backend, plan_key, shape))

    def hit() -> Optional[Blocks]:
        got = cache.lookup(kind, backend, plan_key, shape)
        if got is not None and valid is not None and not valid(got):
            cache.discard(kind, backend, plan_key, shape)
            return None
        return got

    while True:
        if not force:
            got = hit()
            if got is not None:
                return got
        with _TUNE_LOCK:
            done = _TUNE_INFLIGHT.get(flight_key)
            if done is None:
                _TUNE_INFLIGHT[flight_key] = done = threading.Event()
                break  # we lead this key's sweep
        # same key already tuning: wait, then take its fresh entry — even
        # under force (the entry postdates our call, so it IS a re-tune)
        done.wait()
        got = hit()
        if got is not None:
            return got
        # the leader failed; loop and lead the sweep ourselves
    try:
        return _sweep(
            kind, plan_key, shape, runner, candidates, cache=cache,
            backend=backend, trials=trials, warmup=warmup, rank=rank,
            top_k=top_k, record=record,
        )
    finally:
        with _TUNE_LOCK:
            _TUNE_INFLIGHT.pop(flight_key, None)
        done.set()


def _sweep(
    kind: str,
    plan_key: Sequence,
    shape: Sequence[int],
    runner: Callable[[Blocks], Optional[float]],
    candidates: Iterable[Blocks],
    *,
    cache: TuningCache,
    backend: str,
    trials: int,
    warmup: int,
    rank: Optional[Callable[[Blocks], float]],
    top_k: Optional[int],
    record: Optional[Callable[[Blocks, float], None]],
) -> Blocks:
    """The sweep body; the caller holds this key's single-flight lease."""
    cands = list(candidates)
    if not cands:
        raise ValueError("tune() needs at least one candidate")
    if rank is not None:
        cands.sort(key=rank)
        if top_k is not None:
            cands = cands[: max(int(top_k), 1)]
    best: Optional[Blocks] = None
    best_t = float("inf")
    for blocks in cands:
        for _ in range(max(warmup, 0)):
            runner(blocks)
        times = []
        for _ in range(max(trials, 1)):
            t0 = time.perf_counter()
            took = runner(blocks)
            times.append(time.perf_counter() - t0 if took is None else took)
        t = sorted(times)[len(times) // 2]
        if record is not None:
            record(dict(blocks), t)
        if t < best_t:
            best, best_t = blocks, t
    cache.store(kind, backend, plan_key, shape, best, sample_s=best_t)
    return dict(best)


# ---------------------------------------------------------------------------
# Concrete sweeps over the card's kernels (the CLI / chip_smoke path).
# ---------------------------------------------------------------------------
def _cuda_device(device) -> torch.device:
    """The sweep's device: the card by default; the plain versions have no
    launch shape to sweep, so the CPU is refused."""
    from repro_torch.serving.engine import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            "a launch-shape sweep needs a CUDA device: the plain PyTorch "
            f"versions on {dev} have no launch shape to time"
        )
    return dev


def _timed_runner(fn: Callable[[Blocks], None], device: torch.device):
    """Wrap ``fn`` as a tune() runner that returns its CUDA-event seconds."""
    def run(blocks: Blocks) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            start.record()
            fn(blocks)
            stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3

    return run


def decode_bucket_inputs(tables, *, num_words: int, num_windows: int,
                         device=None) -> dict:
    """A representative decode bucket on ``device`` (the card by default):
    a random signal encoded under ``tables`` (so symbol statistics match
    the codebook), its words and symlen sidecar tiled to ``num_words``
    (SymLen words decode independently, so the tiling stays well-formed)
    and, for a v3 coding, the expansion arrays of one ``num_windows``-window
    signal.  Returns ``decode_fused``'s arguments: ``args`` (words, symlen,
    tables, lut, basis, v3) and ``kw``."""
    from repro_torch.core import codec, dct, symlen
    from repro_torch.core.quantize import quant_grid
    from repro_torch.kernels.decode_fused import TRIVIAL
    from repro_torch.serving.engine import putter, symlen_bucket

    dev = torch.device(device) if device is not None else None
    cfg = tables.config
    rng = np.random.default_rng(7)
    sample_windows = max(1, min(int(num_windows), 256))
    signal = rng.standard_normal(sample_windows * cfg.n).astype(np.float32)
    c = codec.encode(signal, tables)
    reps = -(-int(num_words) // max(c.num_words, 1))
    words = np.tile(c.words.view(np.int64), reps)[:num_words]
    sl = np.tile(c.symlen.astype(np.uint8), reps)[:num_words]
    put = putter(dev if dev is not None else "cpu")
    coding = tuple(cfg.coding)
    v3 = None
    if coding != TRIVIAL:
        idx, seg = symlen.v3_expand_index([(num_windows, None, None)],
                                          cfg.e, total_windows=num_windows)
        v3 = (put(idx), put(seg))
    lut, _ = quant_grid(tables.quant)
    args = (put(words), put(sl), tables.device_tables(dev or "cpu"),
            put(lut), put(dct.idct_basis(cfg.n, cfg.e)), v3)
    kw = dict(l_max=cfg.l_max, max_symlen=symlen_bucket(c.max_symlen),
              num_windows=int(num_windows), n=cfg.n, e=cfg.e, coding=coding)
    return {"args": args, "kw": kw}


def encode_bucket_inputs(tables, *, rows: int, num_windows: int,
                         chunk_size: Optional[int] = None,
                         device=None) -> dict:
    """A representative encode bucket on ``device``: ``rows`` random
    signals of ``num_windows`` windows, every symbol counted; the chunk is
    the engine's (``chunk_size`` clipped to the row, None for exact mode).
    Returns ``encode_fused``'s arguments: ``args`` (signals, counts,
    tables, basis) and ``kw``."""
    from repro_torch.core import dct
    from repro_torch.serving.engine import putter

    dev = torch.device(device) if device is not None else torch.device("cpu")
    cfg = tables.config
    sp = int(num_windows) * cfg.e
    chunk = sp if chunk_size is None else min(int(chunk_size), sp)
    rng = np.random.default_rng(11)
    put = putter(dev)
    signals = rng.standard_normal((rows, num_windows * cfg.n)).astype(
        np.float32)
    counts = np.full((rows,), sp, dtype=np.int32)
    args = (put(signals), put(counts), tables.device_tables(dev),
            put(dct.dct_basis(cfg.n, cfg.e)))
    kw = dict(n=cfg.n, e=cfg.e, chunk_size=chunk, check_gaps=False,
              coding=tuple(cfg.coding))
    return {"args": args, "kw": kw}


def tune_decode_bucket(
    tables,
    *,
    num_words: int,
    num_windows: int,
    device=None,
    bucket: Optional[dict] = None,
    cache: Optional[TuningCache] = None,
    cost_model=None,
    trials: int = 3,
    warmup: int = 1,
    force: bool = False,
    top_k: Optional[int] = None,
    record: Optional[Callable[[Blocks, float], None]] = None,
) -> Blocks:
    """Sweep the bucket decode's launch shapes (``idct_rw``, and for a v3
    coding ``v3_tile_windows``) for one (plan key, bucket shape) on the
    card, timed by CUDA events.  ``bucket`` (:func:`decode_bucket_inputs`'
    form, with ``num_words`` words) replaces the synthetic bucket, e.g. an
    archive bucket.  The entry's key is the one the engines consult."""
    from repro_torch.kernels.decode_fused import decode_fused, tuning_plan_key

    dev = _cuda_device(device)
    if bucket is None:
        bucket = decode_bucket_inputs(tables, num_words=num_words,
                                      num_windows=num_windows, device=dev)
    args, kw = bucket["args"], bucket["kw"]
    if int(args[0].shape[0]) != int(num_words) or (
        kw["num_windows"] != int(num_windows)
    ):
        raise ValueError("the bucket's shape is not (num_words, "
                         "num_windows)")
    cfg = tables.config
    plan_key = tuning_plan_key(cfg.n, cfg.e, cfg.l_max, kw["max_symlen"],
                               kw["coding"])

    def run(blocks: Blocks) -> None:
        decode_fused(*args, **kw, idct_rw=blocks["idct_rw"],
                     v3_tile_windows=blocks.get("v3_tile_windows", 0))

    max_smem = _max_smem(dev)
    rank = None
    if cost_model is not None:
        rank = lambda b: cost_model.decode_bucket_cost(  # noqa: E731
            num_words, num_windows, e=cfg.e, n=cfg.n,
            max_symlen=kw["max_symlen"], idct_rw=b["idct_rw"],
            v3_tile_windows=b.get("v3_tile_windows", 0),
        )
    return tune(
        "decode", plan_key, (num_words, num_windows),
        _timed_runner(run, dev),
        decode_block_candidates(cfg.n, cfg.e, kw["coding"],
                                max_smem=max_smem, launcher=True),
        cache=cache, backend=backend_key(dev), trials=trials,
        warmup=warmup, force=force, rank=rank, top_k=top_k,
        valid=lambda b: blocks_legal("decode", plan_key, b,
                                     max_smem=max_smem, launcher=True),
        record=record,
    )


def tune_encode_bucket(
    tables,
    *,
    rows: int,
    num_windows: int,
    chunk_size: Optional[int] = None,
    device=None,
    bucket: Optional[dict] = None,
    cache: Optional[TuningCache] = None,
    cost_model=None,
    trials: int = 3,
    warmup: int = 1,
    force: bool = False,
    top_k: Optional[int] = None,
    record: Optional[Callable[[Blocks, float], None]] = None,
) -> Blocks:
    """Sweep ``encode_levels``' register tile (``levels_rw``) for one
    (plan key, bucket shape) on the card, timed by CUDA events over the
    whole bucket encode.  ``bucket`` (:func:`encode_bucket_inputs`' form)
    replaces the synthetic rows."""
    from repro_torch.kernels.encode_fused import encode_fused, tuning_plan_key

    dev = _cuda_device(device)
    if bucket is None:
        bucket = encode_bucket_inputs(tables, rows=rows,
                                      num_windows=num_windows,
                                      chunk_size=chunk_size, device=dev)
    args, kw = bucket["args"], bucket["kw"]
    cfg = tables.config
    width = num_windows * cfg.n
    if tuple(args[0].shape) != (rows, width):
        raise ValueError("the bucket's shape is not (rows, num_windows * n)")
    plan_key = tuning_plan_key(cfg.n, cfg.e, kw["chunk_size"], kw["coding"])

    def run(blocks: Blocks) -> None:
        encode_fused(*args, **kw, levels_rw=blocks["levels_rw"])

    rank = None
    if cost_model is not None:
        rank = lambda b: cost_model.encode_bucket_cost(  # noqa: E731
            rows, num_windows, e=cfg.e, n=cfg.n, levels_rw=b["levels_rw"],
        )
    return tune(
        "encode", plan_key, (rows, width),
        _timed_runner(run, dev),
        encode_block_candidates(cfg.n, cfg.e, launcher=True),
        cache=cache, backend=backend_key(dev), trials=trials,
        warmup=warmup, force=force, rank=rank, top_k=top_k,
        valid=lambda b: blocks_legal("encode", plan_key, b,
                                     launcher=True),
        record=record,
    )


# ---------------------------------------------------------------------------
# CLI: pre-populate the cache for a grid of serving bucket shapes.
# ---------------------------------------------------------------------------
def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Warm the FPTC kernel tuning cache "
        f"(${ENV_DIR} or --cache-dir) for common serving bucket shapes, "
        "on the card."
    )
    parser.add_argument(
        "--cache-dir", default=None,
        help=f"cache directory (default: ${ENV_DIR})",
    )
    parser.add_argument(
        "--datasets", nargs="*", default=["load_power", "temperature"],
        help="calibration datasets to tune plans for",
    )
    parser.add_argument(
        "--smoke", action="store_true",
        help="small shapes + fewer trials",
    )
    parser.add_argument("--force", action="store_true", help="re-tune hits")
    parser.add_argument("--device", default=None,
                        help="the CUDA device (default: the current one)")
    args = parser.parse_args(argv)

    from repro_torch.core import DOMAIN_DEFAULTS, calibrate
    from repro_torch.data import make_signal
    from repro_torch.data.signals import domain_of
    from repro_torch.tuning.cost_model import default_cost_model

    dev = _cuda_device(args.device)
    cache = TuningCache(args.cache_dir) if args.cache_dir else default_cache()
    cm = default_cost_model(dev)
    trials = 1 if args.smoke else 3
    shapes = (
        [(4096, 512), (16384, 2048)]
        if args.smoke
        else [(4096, 512), (16384, 2048), (65536, 8192)]
    )
    enc_shapes = [(8, 32), (16, 128)] if args.smoke else [
        (8, 32), (16, 128), (32, 512)
    ]
    for dataset in args.datasets:
        dom = domain_of(dataset)
        calib = np.concatenate(
            [make_signal(dataset, 65536, seed=90 + i) for i in range(2)]
        )
        tables = calibrate(calib, DOMAIN_DEFAULTS[dom])
        for words, windows in shapes:
            blocks = tune_decode_bucket(
                tables, num_words=words, num_windows=windows, device=dev,
                cache=cache, cost_model=cm, trials=trials, force=args.force,
                top_k=4 if args.smoke else None,
            )
            print(f"decode {dataset} ({words}w,{windows}win): {blocks}")
        for rows, windows in enc_shapes:
            blocks = tune_encode_bucket(
                tables, rows=rows, num_windows=windows, device=dev,
                cache=cache, cost_model=cm, trials=trials, force=args.force,
            )
            print(f"encode {dataset} ({rows}r,{windows}win): {blocks}")
    where = cache.path or "(memory only)"
    print(f"tuning cache: {len(cache)} entries at {where}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())

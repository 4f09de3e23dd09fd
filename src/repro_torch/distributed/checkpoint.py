"""Fault-tolerant checkpointing with optional FPTC compression.
Port of ``repro/distributed/checkpoint.py``; the two packages read each
other's checkpoints.

Layout:  <dir>/step_<k>/
            manifest.json        — step, leaf index, shapes/dtypes, CRCs
            <leaf-hash>.npy      — raw leaf (default)
            state.fptc           — compress=True: every large float leaf of
                                   the tree, sharded + batch-encoded (one
                                   engine call per 2**30 samples) into
                                   concatenated FPTC containers (manifest
                                   v2); tables are
                                   calibrated once per checkpoint over the
                                   whole tree (``train_state`` domain) and
                                   serialized in the manifest sidecar
            <leaf-hash>.fptc     — legacy per-leaf containers (manifest v1,
                                   still restorable)
Writes are atomic: a temp dir is populated, fsync'd, then renamed; a restart
that died mid-write can never observe a torn checkpoint.  ``restore_latest``
scans for the newest complete manifest (crash -> restart -> resume from the
last durable step).  Every blob's CRC is verified on load.

A tree is nested dicts, lists and tuples of tensors (any device) or numpy
arrays (:mod:`repro_torch.core.tree`: JAX's leaf order and key strings, so
leaf keys and file names equal the reference's).  The state crosses the
host on its way to disk.  The compressed blob is encoded (K4) and decoded
(K1 + K2) on the card unless the caller passes ``device="cpu"``; restored
leaves land on the device of the matching leaf of ``tree_like``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import tables_from_hist
from repro_torch.core.codec import decode as fptc_decode
from repro_torch.core.config import CodecConfig
from repro_torch.core.container import Container
from repro_torch.core.domains import (
    TRAIN_STATE_DOMAIN_ID,
    calibrate_train_state,
)
from repro_torch.core.tree import tree_flatten_with_path, tree_unflatten
from repro_torch.serving.workloads import (
    dtype_name,
    state_from_containers,
    state_to_containers,
)

Tree = Any

__all__ = ["save_checkpoint", "restore_latest", "restore_checkpoint",
           "latest_step", "CKPT_CODEC_CONFIG"]

# near-lossless operating point for state compression: full retention, heavy
# mu-law resolution.  This is the same operating point as
# DOMAIN_DEFAULTS["train_state"].
CKPT_CODEC_CONFIG = CodecConfig(
    n=64, e=64, b1=64, b2=64, mu=255.0, a0_percentile=100.0,
    scale_headroom=1.05, l_max=12,
)

# leaves below this many elements are stored raw: per-leaf container overhead
# and calibration noise dominate any savings
_COMPRESS_MIN_SIZE = 4096


def _fname(key: str) -> str:
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array and its dtype's name.  A bfloat16
    tensor, which numpy cannot hold, becomes its 2-byte words as a ``V2``
    array — the bytes the reference saves for its bfloat16 leaves."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _dtype(leaf: Any):
    return leaf.dtype if isinstance(leaf, torch.Tensor) else np.asarray(
        leaf).dtype


def _size(leaf: Any) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else np.asarray(
        leaf).size


def save_checkpoint(directory: str, step: int, tree: Tree,
                    *, compress: bool = False, device=None,
                    raw: Tuple[str, ...] = ()) -> str:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    step's directory.  ``compress=True`` routes every float32/float16 leaf
    of at least 4096 elements into the shared ``state.fptc`` blob, encoded
    on ``device`` (the card unless ``device="cpu"``), except the leaves
    under the top-level keys ``raw`` names, which are written raw whatever
    their dtype (a training state's weights: ``convert.save_train_state``;
    the reference has no such keys and compresses fp32 weights too)."""
    raw_keys = tuple(f"[{k!r}]" for k in raw)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:012d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "version": 2}
    try:
        to_compress: Dict[str, Any] = {}
        for key, leaf in tree_flatten_with_path(tree):
            name = _fname(key)
            if (
                compress
                and not key.startswith(raw_keys)
                and dtype_name(_dtype(leaf)) in ("float32", "float16")
                and _size(leaf) >= _COMPRESS_MIN_SIZE
            ):
                # routed into the shared sharded/batched state blob below,
                # as it lives: calibrated where it is, sharded on the host
                manifest["leaves"][key] = {
                    "shape": list(np.shape(leaf)),
                    "dtype": dtype_name(_dtype(leaf)),
                    "codec": "fptc_state",
                }
                to_compress[key] = leaf
            else:
                arr, dtype = _host_array(leaf)
                entry = {
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "file": name,
                }
                path = os.path.join(tmp, name + ".npy")
                np.save(path, arr)
                with open(path, "rb") as f:
                    entry["crc"] = zlib.crc32(f.read())
                manifest["leaves"][key] = entry
        if to_compress:
            manifest["state"] = _write_state_blob(tmp, to_compress, device)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_state_blob(tmp: str, arrays: Dict[str, Any], device
                      ) -> Dict[str, Any]:
    """Encode every large float leaf in batched engine calls.

    Tables are calibrated once over the whole tree (``train_state``
    domain), leaves shard into fixed-length strips, and the shards ride
    one :class:`~repro_torch.serving.batch_encode.BatchEncoder` encode per
    ``MAX_CALL_SAMPLES`` samples (uniform shard lengths mean one bucket
    shape a call; the kernels' int32 offsets bound a call).  Containers concatenate
    into ``state.fptc``; the manifest sidecar carries per-shard
    offsets/CRCs plus the serialized calibration (per-bin scales +
    smoothed histogram — the codebook rebuilds deterministically on
    restore).
    """
    tables = calibrate_train_state(arrays, CKPT_CODEC_CONFIG)
    containers, leaf_manifest = state_to_containers(arrays, tables,
                                                    device=device)
    shards = []
    offset = 0
    with open(os.path.join(tmp, "state.fptc"), "wb") as f:
        for cont in containers:
            blob = cont.to_bytes()
            f.write(blob)
            shards.append({
                "offset": offset,
                "size": len(blob),
                "crc": zlib.crc32(blob),
            })
            offset += len(blob)
        f.flush()
        os.fsync(f.fileno())
    return {
        "file": "state.fptc",
        "domain_id": int(tables.domain_id),
        "leaves": leaf_manifest,
        "shards": shards,
        "tables": {
            "scale": np.asarray(tables.quant.scale).tolist(),
            "hist": np.asarray(tables.hist).tolist(),
        },
    }


def _read_containers(base: str, state: Dict[str, Any]):
    """The v2 blob's containers, each shard's CRC verified."""
    with open(os.path.join(base, state["file"]), "rb") as f:
        raw = f.read()
    containers = []
    for shard in state["shards"]:
        blob = raw[shard["offset"]:shard["offset"] + shard["size"]]
        if zlib.crc32(blob) != shard["crc"]:
            raise ValueError(
                f"CRC mismatch in {state['file']} shard at "
                f"offset {shard['offset']}"
            )
        containers.append(Container.from_bytes(blob))
    return containers


def _read_state_blob(base: str, state: Dict[str, Any], device
                     ) -> Dict[str, Any]:
    """Inverse of :func:`_write_state_blob`: one batched decode per
    engine call of the save."""
    containers = _read_containers(base, state)
    tables = tables_from_hist(
        CKPT_CODEC_CONFIG,
        np.asarray(state["tables"]["scale"], np.float32),
        np.asarray(state["tables"]["hist"], np.int64),
        domain_id=int(state.get("domain_id", TRAIN_STATE_DOMAIN_ID)),
    )
    return state_from_containers(containers, state["leaves"], tables,
                                 device=device)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, "manifest.json")
        ):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _place(arr: Any, proto: Any) -> Any:
    """A restored leaf where ``tree_like``'s leaf lives: on its tensor's
    device, or as a host array for a numpy (or scalar) leaf.  A bfloat16
    leaf is always a tensor: numpy has no bfloat16."""
    if isinstance(proto, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        return t.to(proto.device)
    return arr


def restore_checkpoint(directory: str, step: int, tree_like: Tree,
                       *, device=None) -> Tree:
    """Restore into the structure of ``tree_like`` (shapes verified).  A
    compressed blob is decoded on ``device`` (the card unless
    ``device="cpu"``)."""
    base = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    state_arrays: Dict[str, Any] = {}
    if manifest.get("state"):
        state_arrays = _read_state_blob(base, manifest["state"], device)

    out = []
    for key, proto in tree_flatten_with_path(tree_like):
        entry = manifest["leaves"].get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        expected_shape = tuple(entry["shape"])
        if entry.get("codec") == "fptc_state":
            # manifest v2: leaf lives in the shared batched state blob
            arr = state_arrays[key]
            if tuple(arr.shape) != expected_shape:
                raise ValueError(
                    f"{key}: shape {tuple(arr.shape)} != manifest "
                    f"{expected_shape}"
                )
            out.append(_place(_as_dtype(arr, entry["dtype"]), proto))
            continue
        name = entry["file"]
        if entry.get("codec") == "fptc":
            fpath = os.path.join(base, name + ".fptc")
            with open(fpath, "rb") as f:
                blob = f.read()
            if zlib.crc32(blob) != entry["crc"]:
                raise ValueError(f"CRC mismatch for {key}")
            cont = Container.from_bytes(blob)
            tables = tables_from_hist(
                CKPT_CODEC_CONFIG,
                np.asarray(entry["aux"]["scale"], np.float32),
                np.asarray(entry["aux"]["hist"], np.int64),
            )
            arr = _as_dtype(fptc_decode(cont, tables),
                            entry["dtype"]).reshape(entry["shape"])
        else:
            fpath = os.path.join(base, name + ".npy")
            with open(fpath, "rb") as f:
                raw = f.read()
            if zlib.crc32(raw) != entry["crc"]:
                raise ValueError(f"CRC mismatch for {key}")
            arr = np.load(fpath)
            if arr.dtype.kind == "V":
                # a bfloat16 leaf saved as raw 2-byte words (by either
                # package): re-view the bits as the manifest's dtype
                if entry["dtype"] != "bfloat16":
                    raise ValueError(
                        f"{key}: raw {arr.dtype} bytes for dtype "
                        f"{entry['dtype']!r}"
                    )
                arr = torch.from_numpy(
                    np.ascontiguousarray(arr).view(np.uint16)
                ).view(torch.bfloat16)
        if tuple(arr.shape) != expected_shape:
            raise ValueError(
                f"{key}: shape {tuple(arr.shape)} != manifest "
                f"{expected_shape}"
            )
        out.append(_place(arr, proto))
    return tree_unflatten(tree_like, out)


def _as_dtype(arr: Any, name: str) -> Any:
    """A decoded f32 leaf in its recorded dtype (bfloat16 as a tensor)."""
    if isinstance(arr, torch.Tensor):
        return arr
    if name == "bfloat16":
        return torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16)
    return arr.astype(np.dtype(name))


def restore_latest(directory: str, tree_like: Tree, *, device=None
                   ) -> Optional[Tuple[int, Tree]]:
    step = latest_step(directory)
    if step is None:
        return None
    return step, restore_checkpoint(directory, step, tree_like,
                                    device=device)

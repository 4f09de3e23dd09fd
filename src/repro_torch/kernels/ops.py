"""The kernel layer's shared machinery: the CUDA library's build and load,
the launch counters, and the int32 offset guard.

Port of the dispatch layer in ``repro/kernels/ops.py``.  The kernels
are CUDA C++ for ``sm_90a`` under ``csrc/`` with a plain C interface.
:func:`library` compiles each source with ``nvcc`` (all at once, in
parallel), links one shared library into ``kernels/build/<hash>/`` at first
use, and loads it with ``ctypes`` — so a fresh checkout builds its kernels
the first time a CUDA tensor reaches a wrapper.  Nothing is built or
imported when this module is imported.

Every kernel module (``huffman_decode``, ``decode_fused``, ``idct_dequant``,
``dct_quant``, ``encode_fused``) holds its wrapper and the plain PyTorch
version of the same function.  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel through
:func:`launch` or raises.  Each launch of a wrapper's kernel adds one to
``LAUNCHES[name]`` — the counters a run reads to show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "check_i32_offsets",
    "library",
    "launch",
    "build_log",
    "is_cuda",
    "workspace",
]

_I32_MAX = np.iinfo(np.int32).max

# one counter per CUDA kernel, counted in :func:`launch` only:
# symlen_decode (K1, and K2's first stage), v3_unpredict and lut_idct (K2's
# stages after K1), idct_dequant (K3), encode_levels and symlen_pack (K4's
# two stages), encode_levels_gather (K4's first stage reading its rows
# through a GatherStage), dct_quant (K5), symlen_tile (K6), and symlen_lut
# (K1's decode table built on its own, for the checks)
LAUNCHES: Dict[str, int] = {
    "symlen_decode": 0,
    "v3_unpredict": 0,
    "lut_idct": 0,
    "idct_dequant": 0,
    "encode_levels": 0,
    "encode_levels_gather": 0,
    "symlen_pack": 0,
    "dct_quant": 0,
    "symlen_tile": 0,
    "symlen_lut": 0,
}


# guards LAUNCHES: the serving front-end's dispatcher threads (a watchdog
# restart can leave two running) launch concurrently, and ``+=`` on a dict
# entry is a read-modify-write
_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def check_i32_offsets(num_symbols: int, max_symlen: int) -> None:
    """Refuse a decode whose dense symbol offsets would overflow int32.

    The decode kernel's compaction offsets are int32 (as in the reference's
    kernels); a bucket past the 2^31-symbol (= 2^31-byte) mark would wrap
    offsets negative and scatter symbols to the WRONG positions silently.
    The bound keeps the reference's one ``max_symlen`` row of spill.
    """
    if int(num_symbols) + int(max_symlen) > _I32_MAX:
        raise ValueError(
            f"decode bucket of {num_symbols} symbols (+{max_symlen} spill) "
            "exceeds the int32 offset range of the fused kernels — decode "
            "the archive in smaller batches"
        )


def _check_encode_i32(width: int, e: int, n: int) -> None:
    """Encode-side arm of the int32 guard: per-signal symbol capacity."""
    sp = (int(width) // int(n)) * int(e)
    if sp > _I32_MAX:
        raise ValueError(
            f"encode bucket rows of {sp} symbols exceed the int32 offset "
            "range of the fused pack kernel — encode in smaller windows"
        )


def is_cuda(t: torch.Tensor) -> bool:
    """Pick the arm by the tensor's device: True for CUDA, False for the
    CPU; any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain arm for device {t.device}")


# ---------------------------------------------------------------------------
# Build and load.
# ---------------------------------------------------------------------------
_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "build"
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = ["-std=c++17", "-O3", _ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int64
# exported C functions and their argument types (pointers and the stream as
# void*, sizes as int64)
_SIGNATURES = {
    "fptc_symlen_decode": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I,
                           _P],
    "fptc_symlen_lut": [_P, _P, _P, _P, _I, _P, _P],
    "fptc_v3_expand_unpredict": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                 _P],
    "fptc_lut_idct": [_P, _I, _I, _I, _P, _P, _P, _I, _P],
    "fptc_idct_dequant": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "fptc_dct_quant": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "fptc_encode_levels": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                           _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "fptc_encode_levels_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                                  _P],
    "fptc_symlen_pack": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                         _P, _P, _P, _P, _P, _P],
    "fptc_symlen_tile": [_P, _I, _P, _P, _P, _P, _I, _I, _P, _P],
    # the launchers' tile rules, asked by the tuner (no launch)
    "fptc_idct_tile": [_I, _I, _I, _I, _P],
    "fptc_levels_tile": [_I, _I, _I, _P],
    "fptc_v3_tile_ok": [_I, _I],
}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built on this machine"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, link one shared library into
    ``out_dir`` (atomically), and return the compiler's output."""
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=_BUILD))
    try:
        procs = []
        for cu in cus:
            obj = tmp / (cu.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", str(cu), "-o", str(obj)]
            procs.append((cu, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        log = []
        failed = []
        for cu, p in procs:
            out, _ = p.communicate()
            log.append(f"== {cu.name}\n{out}")
            if p.returncode != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        so = tmp / "libfptc_kernels.so"
        link = subprocess.run(
            [nvcc, _ARCH, "-shared", "-o", str(so),
             *[str(tmp / (cu.stem + ".o")) for cu in cus]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        try:
            tmp.rename(out_dir)  # atomic: a concurrent builder may win
        except OSError:
            if not (out_dir / "libfptc_kernels.so").exists():
                raise
        return "\n".join(log)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (raises if it cannot
    be built or loaded — there is no fallback)."""
    global _lib, _build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        cus, headers = _sources()
        digest = hashlib.sha256(" ".join(_FLAGS).encode())
        for path in [*cus, *headers]:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        out_dir = _BUILD / digest.hexdigest()[:16]
        _BUILD.mkdir(parents=True, exist_ok=True)
        if not (out_dir / "libfptc_kernels.so").exists():
            _build_log = _build(out_dir)
        else:
            log = out_dir / "build.log"
            _build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(out_dir / "libfptc_kernels.so"))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fptc_error_string.argtypes = [ctypes.c_int]
        lib.fptc_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v`` resource use) of the build
    :func:`library` loaded."""
    return _build_log


def _stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle."""
    return torch._C._cuda_getCurrentRawStream(device.index)


_workspaces: Dict[tuple, torch.Tensor] = {}
_workspaces_lock = threading.Lock()


def workspace(device: torch.device, nbytes: int) -> torch.Tensor:
    """Scratch bytes on ``device`` for launches on its current stream: one
    buffer per (device, stream), kept across calls and grown on demand, so
    a wrapper allocates no scratch per call.  Launches on one stream run in
    order, so they may share it; another stream gets its own.  The lookup
    and the growth run under one lock, so host threads that share a stream
    get one buffer at a time (a caller keeps its reference to the buffer
    it was handed; a buffer replaced by a larger one is freed in stream
    order)."""
    key = (device.index, _stream(device))
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None or ws.numel() < nbytes:
            ws = torch.empty(nbytes, dtype=torch.uint8, device=device)
            _workspaces[key] = ws
        return ws


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call the exported launcher ``fn`` on ``device`` and count one launch
    of ``name``; raise if the launch was refused.

    The launchers read the current device's limits and launch in its
    context, so ``device`` is made current for the call where it is not;
    PyTorch's current stream on it is passed as the launcher's last
    argument.
    """
    lib = library()
    stream = _stream(device)
    if device.index == torch.cuda.current_device():
        rc = getattr(lib, fn)(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        msg = lib.fptc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
    _count_launch(name)


def _count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]``, under the counters' lock (called by
    :func:`launch` only, once a kernel was enqueued)."""
    with _launches_lock:
        LAUNCHES[name] += 1

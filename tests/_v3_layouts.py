"""Adversarial inputs for K2's v3 stage (expand + segmented un-prediction),
made with numpy from a seed; shared by the CPU tests (the plain stage
against the JAX reference) and the card's tests (the kernel against the
plain stage).  Imports neither JAX nor the reference package.

Every layout has ``4 * tile + 3`` windows, so the last tile is ragged, and
ends in ``PAD`` padding windows: single-window segments whose cells are all
holes, as ``v3_expand_index`` stages a bucket's padding.
"""
import numpy as np

PAD = 5
LAYOUTS = ("singles", "long", "head_on_tile", "head_before", "head_after",
           "random")


def layout_heads(name: str, live: int, tile: int, rng) -> np.ndarray:
    """The segment heads among ``live`` windows: sorted, starting at 0."""
    if name == "singles":  # every window its own segment
        return np.arange(live)
    if name == "long":  # one segment across every tile (>= 3 tiles)
        return np.array([0])
    if name == "random":  # lengths from 1 window to 3 tiles
        lens = rng.integers(1, 3 * tile, size=live)
        lens[::3] = rng.integers(1, 4, size=lens[::3].size)
        return np.unique(np.concatenate([[0], np.cumsum(lens)]))
    shift = {"head_on_tile": 0, "head_before": -1, "head_after": 1}[name]
    heads = np.arange(tile, live, tile) + shift
    return np.concatenate([[0], heads])


def v3_stage_case(name: str, e: int, tile: int, seed: int = 0):
    """(dense u8, idx i32[W * e], seg i32[W], W) for layout ``name``: random
    coded symbols, about 15% of the live cells suppressed (idx -1), the
    rest ranked row-major into ``dense``."""
    rng = np.random.default_rng(seed)
    num_windows = 4 * tile + 3
    live = num_windows - PAD
    heads = layout_heads(name, live, tile, rng)
    heads = heads[heads < live]
    seg = np.arange(num_windows, dtype=np.int32)  # padding: own segments
    starts = np.zeros(live, dtype=np.int32)
    starts[heads] = heads
    seg[:live] = np.maximum.accumulate(starts)
    coded = rng.random((num_windows, e)) >= 0.15
    coded[live:] = False
    idx = np.where(coded.ravel(), np.cumsum(coded.ravel()) - 1, -1)
    dense = rng.integers(0, 256, size=int(coded.sum()), dtype=np.uint8)
    return dense, idx.astype(np.int32), seg, num_windows

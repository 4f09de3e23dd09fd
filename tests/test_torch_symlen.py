"""The port's SymLen packers held against the JAX package's, exactly.

``pack_symlen_chunked_parts``, ``pack_symlen_chunked``,
``stitch_chunk_parts`` and ``pack_symlen_scan`` of ``repro_torch.core.
symlen`` against the same functions of ``repro.core.symlen``: words
(as uint32 halves), symlen sidecars and word counts equal bit for bit.
The pinned cases are ``tests/test_properties.py``'s chunked-pack cases,
given as (seed, num_symbols, chunk, l_max).  The packs are compared
directly, never through the reference's dense-decode arm.  The encode
kernel's plain pack (``encode_fused.symlen_pack_plain``, which the card's
kernel is held to) is held to the reference's chunked pack on the
adversarial layouts of ``tests/_pack_layouts.py``.
"""
import functools

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import huffman as ref_huffman
from repro.core import symlen as ref_symlen
from repro_torch.core import symlen
from repro_torch.core.huffman import codebook_from_lengths
from repro_torch.kernels import encode_fused as ef
from _pack_layouts import CHUNKS, LAYOUTS, pack_case

PINNED = [(11, 63, 7, 8), (12, 4096, 1024, 16), (13, 1, 1, 9),
          (14, 500, 501, 10)]


def _case(seed, num_symbols, l_max):
    """Zipf symbols and a Laplace-smoothed book, as the property suite
    draws them; the port's tables are rebuilt from the code lengths."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, max(num_symbols, 1))[:num_symbols]
    syms = np.clip(raw, 0, 255).astype(np.uint8)
    freqs = np.bincount(syms, minlength=256).astype(np.int64) + 1
    book = ref_huffman.build_codebook(freqs, l_max=l_max)
    port = codebook_from_lengths(book.lengths, l_max)
    codes = torch.from_numpy(port.codes.astype(np.int64))
    lengths = torch.from_numpy(port.lengths.astype(np.int32))
    np.testing.assert_array_equal(port.codes, book.codes)
    return syms, book, codes, lengths


def _ref_tables(book):
    return (jnp.asarray(book.codes, jnp.uint32),
            jnp.asarray(book.lengths, jnp.int32))


def _u32(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def assert_parts_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        g = g.numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("seed,num_symbols,chunk,l_max", PINNED)
def test_chunked_parts_and_stitch_match_reference(seed, num_symbols, chunk,
                                                  l_max):
    syms, book, codes, lengths = _case(seed, num_symbols, l_max)
    rc, rl = _ref_tables(book)
    ref = ref_symlen.pack_symlen_chunked_parts(
        jnp.asarray(syms), rc, rl, chunk_size=chunk)
    got = symlen.pack_symlen_chunked_parts(
        torch.from_numpy(syms), codes, lengths, chunk_size=chunk)
    assert_parts_equal(got, ref)
    for cap in (symlen.stitch_capacity(int(np.asarray(ref[3]).sum())),
                ref[0].shape[0] * chunk):
        rs = ref_symlen.stitch_chunk_parts(*ref, capacity=cap)
        gs = symlen.stitch_chunk_parts(*got, capacity=cap)
        assert_parts_equal(gs, rs)
    # the stitched stream decodes on the host to the input
    hi, lo, sl, nw = symlen.pack_symlen_chunked(
        torch.from_numpy(syms), codes, lengths, chunk_size=chunk)
    nw = int(nw)
    stream = symlen.PackedStream(
        words=symlen.u32_to_words(_u32(hi[:nw]), _u32(lo[:nw])),
        symlen=sl[:nw].numpy(), num_symbols=syms.size)
    port_book = codebook_from_lengths(book.lengths, l_max)
    np.testing.assert_array_equal(
        symlen.unpack_symlen_np(stream, port_book), syms)
    # every chunk is within the static word bound
    assert int(got[3].max()) <= symlen.chunk_words_bound(chunk, l_max)
    assert symlen.chunk_words_bound(chunk, l_max) == \
        ref_symlen.chunk_words_bound(chunk, l_max)


@pytest.mark.parametrize("seed,num_symbols,chunk,l_max", PINNED)
def test_scan_packer_matches_reference(seed, num_symbols, chunk, l_max):
    del chunk
    syms, book, codes, lengths = _case(seed, num_symbols, l_max)
    ref = ref_symlen.pack_symlen_scan(jnp.asarray(syms), *_ref_tables(book))
    got = symlen.pack_symlen_scan(torch.from_numpy(syms), codes, lengths)
    assert_parts_equal(got, ref)
    nw = int(got[3])
    host = symlen.pack_symlen_np(syms, codebook_from_lengths(book.lengths,
                                                             l_max))
    np.testing.assert_array_equal(
        symlen.u32_to_words(_u32(got[0][:nw]), _u32(got[1][:nw])),
        host.words)


@pytest.mark.parametrize("seed,num_symbols,chunk,l_max",
                         PINNED + [(15, 0, 1, 12)])
def test_packed_stream_payload_bytes_matches_reference(seed, num_symbols,
                                                       chunk, l_max):
    """``PackedStream.payload_bytes`` (words and a one-byte sidecar per
    word) against the reference's on the host packer's stream."""
    del chunk
    syms, book, _, _ = _case(seed, num_symbols, l_max)
    got = symlen.pack_symlen_np(syms, codebook_from_lengths(book.lengths,
                                                            l_max))
    ref = ref_symlen.pack_symlen_np(syms, book)
    assert got.num_words == ref.num_words
    assert got.payload_bytes == ref.payload_bytes == 9 * ref.num_words


@pytest.mark.parametrize("mode", ["holes", "empty_chunk", "num_symbols"])
def test_masked_packs_match_reference(mode):
    """A ``valid`` mask with holes (zero-plane suppression), a chunk with no
    valid symbol, and a ``num_symbols`` prefix."""
    syms, book, codes, lengths = _case(21, 700, 12)
    rng = np.random.default_rng(22)
    chunk = 64
    kw = {}
    if mode == "holes":
        valid = rng.random(700) < 0.7
        kw = {"valid": valid}
    elif mode == "empty_chunk":
        valid = np.ones(700, bool)
        valid[128:192] = False  # chunk 2 holds no valid symbol
        valid[640:] = False  # nor does the last, partial, chunk
        kw = {"valid": valid}
    else:
        kw = {"num_symbols": 333}
    ref = ref_symlen.pack_symlen_chunked_parts(
        jnp.asarray(syms), *_ref_tables(book), chunk_size=chunk,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = symlen.pack_symlen_chunked_parts(
        torch.from_numpy(syms), codes, lengths, chunk_size=chunk,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    assert_parts_equal(got, ref)
    if mode == "empty_chunk":
        assert int(got[3][2]) == 0 and int(got[3][-1]) == 0
        assert not got[0][2].any() and not got[2][2].any()


def test_precheck_refuses_histogram_gaps():
    syms, book, codes, lengths = _case(31, 200, 10)
    lengths = lengths.clone()
    gap = int(syms[5])
    lengths[gap] = 0
    for fn in (
        lambda: symlen.pack_symlen_scan(torch.from_numpy(syms), codes,
                                        lengths),
        lambda: symlen.pack_symlen_chunked_parts(
            torch.from_numpy(syms), codes, lengths, chunk_size=16),
    ):
        with pytest.raises(ValueError, match="histogram gap"):
            fn()
    # a gap symbol that lies only in masked-out slots packs
    valid = torch.from_numpy(syms != gap)
    symlen.pack_symlen_chunked_parts(torch.from_numpy(syms), codes, lengths,
                                     chunk_size=16, valid=valid)
    with pytest.raises(ValueError, match="positive"):
        symlen.pack_symlen_chunked_parts(torch.from_numpy(syms), codes,
                                         lengths, chunk_size=0)


@functools.lru_cache(maxsize=None)
def _ref_chunked_parts(chunk):
    """The reference's chunked pack under jit, as its batched encoder runs
    it (traced, so a gap symbol packs and is flagged, not refused)."""
    return jax.jit(lambda syms, codes, lengths, valid:
                   ref_symlen.pack_symlen_chunked_parts(
                       syms, codes, lengths, chunk_size=chunk, valid=valid))


def _layout_valid(c):
    """bool[K, Wp * E]: the slots a layout's coding enters into the stream,
    by the container format's rule (v2: the first ``count`` slots; v3: the
    true windows, less the zero planes)."""
    k, wp, e = c["grid"].shape
    if tuple(c["coding"]) == (0, 0, False):
        return np.arange(wp * e)[None, :] < c["counts"][:, None]
    valid = np.arange(wp)[None, :] < (c["counts"] // e)[:, None]
    valid = np.repeat(valid[:, :, None], e, axis=2)
    if c["zrow"] is not None:
        valid &= ~c["zrow"][:, :, None] & ~c["zcol"][:, None, :]
    return valid.reshape(k, -1)


@pytest.mark.parametrize("chunk", CHUNKS,
                         ids=lambda c: "exact" if c is None else str(c))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pack_matches_reference_on_layouts(layout, chunk):
    """``symlen_pack_plain`` against the reference's chunked pack, row by
    row, on each adversarial layout: words, sidecars and word counts
    exactly, and the gap flags against the valid slots with no code."""
    c = pack_case(layout, chunk)
    t = {k: None if c[k] is None else torch.from_numpy(c[k])
         for k in ("grid", "zrow", "zcol", "counts", "codes", "lengths")}
    got = ef.symlen_pack_plain(t["grid"], t["zrow"], t["zcol"], t["counts"],
                               t["codes"], t["lengths"],
                               chunk_size=c["chunk"], coding=c["coding"])
    valid = _layout_valid(c)
    flat = c["grid"].reshape(valid.shape[0], -1)
    ref_pack = _ref_chunked_parts(c["chunk"])
    codes = jnp.asarray(c["codes"], jnp.uint32)
    lengths = jnp.asarray(c["lengths"], jnp.int32)
    for r in range(flat.shape[0]):
        ref = ref_pack(jnp.asarray(flat[r]), codes, lengths,
                       jnp.asarray(valid[r]))
        assert_parts_equal([g[r] for g in got[:4]], ref)
    want_bad = ((c["lengths"][flat] == 0) & valid).any(axis=1)
    np.testing.assert_array_equal(got[4].numpy(), want_bad)
    assert want_bad.any() == (layout == "gap_after_full")
    if layout == "masked":  # a row with no coded cell packs no word
        assert not got[3][1].any() and not got[0][1].any()

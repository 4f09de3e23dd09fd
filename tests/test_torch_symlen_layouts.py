"""The plain versions of the SymLen word decode held to the JAX reference on
the layouts of ``tests/_symlen_layouts.py`` (each ``l_max`` of 1, 2, 8, 12,
13 and 16 under each layout: packed streams with padding words, words
clamped below their symlen, 64 one-bit codes a word, random words under a
random code; word counts around a tile; ``num_symbols`` below, at and past
the total), at small sizes:

  * ``huffman_decode_plain`` (K1's): exactly equal to the reference's XLA
    arm ``repro.core.symlen.unpack_symlen`` (never its Pallas dense arm,
    which this JAX does not run) and, on packed streams decoded whole, to
    the symbols packed;
  * ``huffman_decode_tile_plain`` (K6's): the whole slot-major tile exactly
    equal to the reference's Pallas tile kernel in interpret mode;
  * ``decode_lut_plain`` (the table both kernels decode through): entry by
    entry equal to the reference's step over every prefix
    (``repro.core.huffman.decode_prefix_arith``: symbol and length), and
    its symbols to one slot of the XLA arm's decode of each prefix.

The kernels against these plain versions on the same layouts, on the
card: ``tests/test_torch_gpu.py``.
"""
import dataclasses

import pytest

jnp = pytest.importorskip("jax.numpy")  # the reference; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _symlen_layouts import (  # noqa: E402
    COUNTS,
    L_MAXES,
    LAYOUTS,
    num_symbols_cases,
    symlen_case,
)
from repro.core import huffman as ref_huffman  # noqa: E402
from repro.core import symlen as ref_symlen  # noqa: E402
from repro.kernels.huffman_decode import (  # noqa: E402
    huffman_decode_tile as ref_pallas_tile,
)
from repro_torch.core.calibration import DomainTables  # noqa: E402
from repro_torch.core.config import CodecConfig  # noqa: E402
from repro_torch.core.huffman import codebook_from_lengths  # noqa: E402
from repro_torch.core.quantize import quant_table_from_arrays  # noqa: E402
from repro_torch.kernels import huffman_decode as hd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CASES = [(l_max, layout) for l_max in L_MAXES for layout in LAYOUTS]
# one XLA program a shape, in place of one eager op at a time
_ref_dense = jax.jit(ref_symlen.unpack_symlen, static_argnames=(
    "l_max", "max_symlen", "num_symbols"))


def _ids(case):
    return "l{}-{}".format(*case)


def _book(lengths, l_max):
    """The port's codebook (decode tables) for the code lengths, and the
    reference's codebook holding the same arrays."""
    book = codebook_from_lengths(lengths, l_max)
    return book, ref_huffman.HuffmanCodebook(**dataclasses.asdict(book))


def _tables(book):
    cfg = CodecConfig(n=8, e=8, b1=0, b2=8, l_max=book.l_max)
    quant = quant_table_from_arrays(np.zeros(8), np.ones(8), 50.0, 0.0)
    return DomainTables(config=cfg, quant=quant, book=book).device_tables(
        "cpu")


def _ref_tables(book):
    return (jnp.asarray(book.limit_shifted[1:], jnp.uint32),
            jnp.asarray(book.first_code_shifted, jnp.uint32),
            jnp.asarray(book.rank_offset, jnp.int32),
            jnp.asarray(book.sorted_symbols, jnp.int32))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_dense_plain_on_layouts(case):
    l_max, layout = case
    for count in COUNTS:
        c = symlen_case(l_max, layout, count)
        book, _ = _book(c["lengths"], l_max)
        tables = _tables(book)
        hi, lo = ref_symlen.words_to_u32(c["words"])
        w = torch.from_numpy(c["words"].view(np.int64))
        s = torch.from_numpy(c["symlen"])
        for nsym in num_symbols_cases(c["total"]):
            kw = dict(l_max=l_max, max_symlen=c["max_symlen"],
                      num_symbols=nsym)
            before = dict(ops.LAUNCHES)
            got = hd.huffman_decode_dense(w, s, tables, **kw)
            assert ops.LAUNCHES == before  # CPU tensors take the plain arm
            ref = _ref_dense(jnp.asarray(hi), jnp.asarray(lo),
                             jnp.asarray(c["symlen"].astype(np.int32)),
                             *_ref_tables(book), **kw)
            assert got.dtype == torch.uint8 and got.shape == (nsym,)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            if c["symbols"] is not None:  # the stream decoded whole
                n = min(nsym, c["total"])
                np.testing.assert_array_equal(got[:n].numpy(),
                                              c["symbols"][:n])
                assert not got[n:].any()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tile_plain_on_layouts(case):
    l_max, layout = case
    for count in (1, COUNTS[-1]):
        c = symlen_case(l_max, layout, count)
        book, _ = _book(c["lengths"], l_max)
        ms = c["max_symlen"]
        hi, lo = ref_symlen.words_to_u32(c["words"])
        want = np.asarray(ref_pallas_tile(
            jnp.asarray(hi), jnp.asarray(lo), *_ref_tables(book),
            l_max=l_max, max_symlen=ms, block_words=128, interpret=True))
        got = hd.huffman_decode_tile(
            torch.from_numpy(c["words"].view(np.int64)), _tables(book),
            l_max=l_max, max_symlen=ms)
        assert got.dtype == torch.int32 and got.shape == (ms, count)
        np.testing.assert_array_equal(got.numpy(), want)  # the WHOLE tile


@pytest.mark.parametrize("l_max", L_MAXES)
def test_decode_lut_plain_every_prefix(l_max):
    for layout in ("stream", "one_bit", "random"):
        lengths = symlen_case(l_max, layout, 1)["lengths"]
        book, ref_book = _book(lengths, l_max)
        lut = hd.decode_lut_plain(_tables(book), l_max=l_max)
        assert lut.dtype == torch.int16 and lut.shape == (1 << l_max,)
        lut = lut.numpy().astype(np.int64)
        prefix = np.arange(1 << l_max, dtype=np.uint32)
        sym, length = ref_huffman.decode_prefix_arith(ref_book, prefix)
        np.testing.assert_array_equal(lut & 255, sym)
        np.testing.assert_array_equal(lut >> 8, length)
        # the XLA arm's first slot of a word whose top bits are the prefix
        words = prefix.astype(np.uint64) << np.uint64(64 - l_max)
        hi, lo = ref_symlen.words_to_u32(words)
        first = _ref_dense(jnp.asarray(hi), jnp.asarray(lo),
                           jnp.ones(prefix.size, jnp.int32),
                           *_ref_tables(book), l_max=l_max, max_symlen=1,
                           num_symbols=prefix.size)
        np.testing.assert_array_equal(lut & 255, np.asarray(first))

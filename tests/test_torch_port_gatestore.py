"""A pure-Python model of #10's realigning kernel's memory plan
(``silu_mul_quant_any_kernel`` in ``csrc/fused_quant.cu``), on the CPU.

One block a row (up to 256 threads, in as many warps as the row's words
need); thread t makes the aligned 16-byte words t, t + blockDim, ... of the
row's int8 output. Word k holds outputs e0 = 16 k - a0 .. e0 + 15, a0
the row's offset from the 16-byte boundary before it. A word wholly inside
the row is written by one 16-byte store; the ragged first and last word by
aligned stores of 8, 4, 2 and 1 bytes (``store_bytes``) over the row's bytes
alone, since the rest of those 16 bytes belong to the neighbouring rows,
which other blocks write. Each of x1's and x2's 16 inputs comes from the
aligned 16-byte words that enclose them (``load16``), except words that
hold no byte of that half-row.

For H in 1..300, the registry's four widths off a multiple of 8 (the tp-2
halves 1,365 and 2,389, L's 2,730, 1p6B's 4,778) and the largest (8,192),
at output bases 0..15 bytes past a 16-byte boundary and x12 bases at every
element offset within 16 bytes: every output byte of three adjacent rows is
written exactly once, by aligned stores, nothing outside the rows is
written, each row fits the kernel's words a thread, and every input element
lies in a loaded word that holds a byte of its half-row.
"""

import pytest

MAX_THREADS = 256  # kMaxWarps * 32
H_CASES = list(range(1, 301)) + [1365, 2389, 2730, 4778, 8192]


def launch_shape(h: int) -> tuple:
    """``gate_launch_any``'s (kWords, threads): words a thread, and threads a
    block in whole warps."""
    words = (h + 30) // 16
    per = (words + MAX_THREADS - 1) // MAX_THREADS
    return per, ((words + per - 1) // per + 31) // 32 * 32


def store_pieces(dst: int, lo: int, hi: int) -> list:
    """``store_bytes``: (address, size) of the stores of bytes [lo, hi) of
    the word at dst."""
    if lo == 0 and hi == 16:
        return [(dst, 16)]
    out, p = [], lo
    while p < hi:
        for size in (8, 4, 2, 1):
            if p % size == 0 and p + size <= hi:
                out.append((dst + p, size))
                p += size
                break
    return out


def row_stores(orow: int, h: int) -> list:
    a0 = orow % 16
    nw = (a0 + h + 15) // 16
    per, threads = launch_shape(h)
    assert nw <= per * threads and per <= 3 and threads <= MAX_THREADS
    pieces = []
    for k in range(nw):
        e0 = 16 * k - a0
        assert (orow + e0) % 16 == 0
        pieces += store_pieces(orow + e0, max(0, -e0), min(16, h - e0))
    return pieces


def loaded_words(p: int, e0: int, h: int, elem: int) -> list:
    """``load16``'s loaded 16-byte words (their addresses) for elements e0 ..
    e0 + 15 of the half-row at byte address p."""
    k_in = 16 * elem // 16 + 1
    lo, hi = p, p + h * elem
    start = p + e0 * elem
    base, shift = start // 16 * 16, start % 16
    return [base + 16 * k for k in range(k_in)
            if (k < k_in - 1 or shift != 0) and base + 16 * k < hi and base + 16 * k + 16 > lo]


@pytest.mark.parametrize("base_off", range(16))
def test_each_output_byte_is_written_once_and_nothing_else(base_off):
    rows, base = 3, 4096 + base_off
    for h in H_CASES:
        written = {}
        for row in range(rows):
            for addr, size in row_stores(base + row * h, h):
                assert addr % size == 0
                for a in range(addr, addr + size):
                    written[a] = written.get(a, 0) + 1
        assert sorted(written) == list(range(base, base + rows * h)), h
        assert set(written.values()) == {1}, h


@pytest.mark.parametrize("elem,x_off", [(2, o) for o in range(0, 16, 2)] + [(4, o) for o in range(0, 16, 4)])
def test_every_input_element_lies_in_a_loaded_word_of_its_half_row(elem, x_off):
    x1 = 8192 + x_off
    for h in H_CASES:
        for half in (x1, x1 + h * elem):  # x1, then x2 right after it
            for a0 in (0, 7, 15):
                for k in range((a0 + h + 15) // 16):
                    e0 = 16 * k - a0
                    words = loaded_words(half, e0, h, elem)
                    for w in words:  # each holds a byte of the half-row
                        assert w < half + h * elem and w + 16 > half
                    for e in range(max(e0, 0), min(e0 + 16, h)):
                        addr = half + e * elem
                        assert any(w <= addr and addr + elem <= w + 16 for w in words), (h, e)

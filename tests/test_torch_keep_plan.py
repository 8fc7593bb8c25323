"""The tensor-core kernels' dropout draw (flash_tc.cuh::keep_bits) modelled
in numpy, lane by lane, and held to the plain mask on the CPU.

K1's and K2's kernels on the card (mma.sync and wgmma, bf16 and 3xTF32)
take each tile's keep decisions from ``keep_bits<NT>``: a warp's quad of
lanes (lane % 4 = q) holds rows g and g + 8 of the tile, and lane q keys
c = 2q, 2q + 1 of each of NT n-tiles of 8 keys. Element n of a row takes
word n % 4 of Philox4x32-10 at counter n / 4. Where Sk % 4 == 0 a row
starts a counter, and lanes q and q ^ 1 share their counters by one
shuffle. Elsewhere each row has a phase ph = (row offset + k0) % 4, and
the plan modelled here is the kernel's: lane q draws for row q / 2 the
counters of parity q % 2 (NT + 1 calls), and every lane takes each of its
four (row, column) streams from one computed lane of its quad by one
shuffle and one shift. The model follows the CUDA code's arithmetic
step by step (the counters, the nibbles of each lane's word, the shuffle
sources, the shifts) with the port's plain Philox (``philox4x32``), and
its decisions must equal ``philox_keep_plain``'s at every row phase, for
NT in {4, 8}, in a row's last tile (keys past Sk, whose elements are the
next row's) and at offsets past 2^32, with the same number of Philox
calls and shuffles on every lane.
"""

import numpy as np
import pytest
import torch

from reftr_torch.kernels.attention import (dropout_threshold, philox4x32,
                                           philox_keep_plain)

torch.set_num_threads(1)
RATE = 0.1
SEED = 0x5EED_1234_ABCD


def philox_nibbles(seed: int, counters: np.ndarray, threshold: int):
    """The four keep decisions of each Philox counter as a nibble (word w
    at bit w), as ``flash::kept`` of each word of ``flash::philox4``."""
    ctr = torch.from_numpy(counters.astype(np.int64))
    words = philox4x32(torch.stack([ctr & 0xFFFFFFFF, ctr >> 32,
                                    torch.zeros_like(ctr),
                                    torch.zeros_like(ctr)], -1),
                       (seed & 0xFFFFFFFF, seed >> 32)).numpy()
    kept = (words >> 8) >= threshold
    return (kept * (1 << np.arange(4))).sum(-1).astype(np.uint64)


def keep_bits_model(n_row, k0: int, nt: int, sk: int, seed: int,
                    threshold: int):
    """keep_bits<nt> for the four lanes of one quad: (bits per lane, Philox
    calls per lane, shuffle sources per lane). Bit n * 4 + e of lane q is
    element e of n-tile n: row n_row[e // 2], key k0 + n * 8 + 2q + e % 2."""
    every4 = ((1 << (4 * nt)) - 1) // 15  # bits 0, 4, ..
    bits, calls, sources = [0] * 4, [0] * 4, [[] for _ in range(4)]
    if sk % 4 == 0:
        own = [0] * 4
        for q in range(4):
            odd, c = q & 1, 2 * q
            for t in range(nt // 2):
                for r in range(2):
                    n = n_row[r] + k0 + (2 * t + odd) * 8 + (c & ~3)
                    nib = int(philox_nibbles(seed, np.array([n >> 2]),
                                             threshold)[0])
                    calls[q] += 1
                    own[q] |= nib << ((t * 2 + r) * 4)
        for q in range(4):
            odd = q & 1
            partner = own[q ^ 1]
            sources[q].append(q ^ 1)
            for n in range(nt):
                src = own[q] if (n & 1) == odd else partner
                for r in range(2):
                    bits[q] |= ((src >> (((n // 2) * 2 + r) * 4 + 2 * odd))
                                & 3) << (n * 4 + 2 * r)
        return bits, calls, sources
    own = [0] * 4
    for q in range(4):
        first = n_row[q >> 1] + k0
        ctrs = (first >> 2) + 2 * np.arange(nt + 1) + (q & 1)
        nibs = philox_nibbles(seed, ctrs, threshold)
        calls[q] = len(ctrs)
        own[q] = sum(int(x) << (4 * i) for i, x in enumerate(nibs))
    for q in range(4):
        c = 2 * q
        for r in range(2):
            ph = (n_row[r] + k0) % 4
            for e in range(2):
                u = ph + c + e
                src = 2 * r + ((u >> 2) & 1)
                sources[q].append(src)
                got = own[src]
                bits[q] |= (((got >> (4 * (u >> 3) + (u & 3))) & every4)
                            << (2 * r + e))
    return bits, calls, sources


def plain_bits(keep_flat: np.ndarray, n0: int, n_row, k0: int, nt: int, q: int):
    """The same bits from the plain mask, flattened from offset n0."""
    bits = 0
    for n in range(nt):
        for e in range(4):
            el = n_row[e >> 1] + k0 + n * 8 + 2 * q + (e & 1)
            bits |= int(keep_flat[el - n0]) << (n * 4 + e)
    return bits


def check_quads(b, h, sq, sk, nt, first_row=0):
    """Every quad's rows (g, g + 8 of each 16-row warp tile) and key tiles
    of NT * 8 keys of batch rows first_row.. of [b, h, sq, sk], the last
    tile included: the model's bits equal the plain mask's. The plain mask
    is drawn one batch row further, so the keys past Sk of the last row
    have their elements (the next row's first keys)."""
    threshold = dropout_threshold(RATE)
    keep = philox_keep_plain(SEED, b + 1, h, sq, sk, RATE,
                             first_row=first_row).numpy().reshape(-1)
    n0 = first_row * h * sq * sk
    phases = set()
    tiles = range(0, sk, nt * 8)
    for bh in range(first_row * h, b * h):
        for base in range(0, sq, 16):
            for g in range(8):
                rows = [base + g, base + g + 8]
                n_row = [(bh * sq + i) * sk for i in rows]
                for k0 in tiles:
                    bits, calls, sources = keep_bits_model(
                        n_row, k0, nt, sk, SEED, threshold)
                    assert len(set(calls)) == 1, calls
                    assert calls[0] == (nt if sk % 4 == 0 else nt + 1)
                    assert len({len(s) for s in sources}) == 1
                    assert all(0 <= x < 4 for s in sources for x in s)
                    for q in range(4):
                        assert bits[q] == plain_bits(keep, n0, n_row, k0,
                                                     nt, q), (bh, rows, k0, q)
                    phases.update((x + k0) % 4 for x in n_row)
    return phases


@pytest.mark.parametrize("nt", [4, 8])
@pytest.mark.parametrize("sk", [22, 90, 17, 131, 387, 20])
def test_quad_draw_matches_the_plain_mask(sk, nt):
    """Key counts of the model's sites that are not a multiple of 4 (22,
    90: phases 0 and 2), odd ones (every phase), and 20 (the aligned
    path): every lane's decisions equal the plain mask's, in every tile of
    every row, the last tile's keys past Sk included."""
    phases = check_quads(1, 2, 32, sk, nt)
    assert phases == ({0} if sk % 4 == 0 else
                      {0, 2} if sk % 2 == 0 else {0, 1, 2, 3})


@pytest.mark.parametrize("nt", [4, 8])
@pytest.mark.parametrize("sk", [490, 2090])
def test_quad_draw_matches_the_plain_mask_at_flickr_encoder_keys(sk, nt):
    """flickr's encoder at one and two feature levels (490, 2090 keys),
    one 16-row warp tile of queries from row 37 on (a row offset that is
    not a multiple of 4 rows)."""
    threshold = dropout_threshold(RATE)
    sq, h = 64, 1
    keep = philox_keep_plain(SEED, 1, h, sq, sk, RATE).numpy().reshape(-1)
    for g in range(8):
        rows = [37 + g, 45 + g]
        n_row = [i * sk for i in rows]
        for k0 in range(0, sk - nt * 8, nt * 8):
            bits, calls, _ = keep_bits_model(n_row, k0, nt, sk, SEED,
                                             threshold)
            assert calls == [nt + 1] * 4
            for q in range(4):
                assert bits[q] == plain_bits(keep, 0, n_row, k0, nt, q)


@pytest.mark.parametrize("nt", [4, 8])
@pytest.mark.parametrize("sk", [1027, 1026, 1025])
def test_quad_draw_matches_the_plain_mask_past_2_to_the_32(sk, nt):
    """A batch row whose element offsets run past 2^32 (B * Sk > 2^32
    with H = Sq = 16: the counters' high words are not 0), at each odd and
    even key count's phases, the last tile included."""
    b = (1 << 32) // (16 * 16 * sk) + 1
    first = b - 1
    assert first * 16 * 16 * sk < (1 << 32) < b * 16 * 16 * sk
    threshold = dropout_threshold(RATE)
    keep = philox_keep_plain(SEED, b + 1, 16, 16, sk, RATE,
                             first_row=first).numpy().reshape(-1)
    n0 = first * 16 * 16 * sk
    crossed = False
    for bh in (first * 16, b * 16 - 1):
        for g in range(8):
            n_row = [(bh * 16 + i) * sk for i in (g, g + 8)]
            for k0 in (0, (sk // (nt * 8)) * nt * 8):  # first, last tile
                bits, calls, _ = keep_bits_model(n_row, k0, nt, sk, SEED,
                                                 threshold)
                assert calls == [nt + 1] * 4
                crossed |= n_row[0] >= (1 << 32)
                for q in range(4):
                    assert bits[q] == plain_bits(keep, n0, n_row, k0, nt, q)
    assert crossed


def test_the_model_reads_the_kernels_word_order():
    """The nibble of a counter holds words 0-3 at bits 0-3, as
    philox_keep_plain assigns element n word n % 4 of counter n / 4."""
    threshold = dropout_threshold(RATE)
    keep = philox_keep_plain(SEED, 1, 1, 1, 64, RATE).numpy()[0, 0, 0]
    nibs = philox_nibbles(SEED, np.arange(16), threshold)
    got = [(int(nibs[n // 4]) >> (n % 4)) & 1 for n in range(64)]
    assert got == [int(x) for x in keep]

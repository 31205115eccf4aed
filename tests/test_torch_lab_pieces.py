"""PyTorch port, the Hopper lab's slice probes #8-#10 (`ops/lab.py`,
`csrc/lab_mosaic.cu`) on the CPU: the rule that cuts each slice into the
pieces a CTA copies (`col_pieces`, `row_pieces`), and
numpy models of the kernels' addressing, held against the plain versions.

- #8/#9: piece p of tile t is the TMA box [R, C/P] at column start + p *
  C/P of the source map, stored through the map of the tiles as [grid*R,
  C] at (t*R, p * C/P). The model cuts those boxes out of src and pastes
  them at those coordinates.
- #10: piece p of tile t covers bytes [b0, b0 + C/P*K*4) of src, b0 = (off[t]
  + p*C/P)*K*4; its bulk copy reads the 16 B aligned span [lo, hi) that
  encloses them and shifts by b0 - lo. The model rebuilds each tile from
  the raw bytes of src through exactly that arithmetic.

The JAX probes (`xflow_tpu/tools/bench_lab.py` `fb`, `fc`, `fd`) are
closures built for the TPU only, so, as in `test_torch_lab.py`, the
reference is the numpy slice. Tolerance: bitwise (copies).
"""

import numpy as np
import pytest
import torch

from xflow_tpu_torch.ops import lab
from xflow_tpu_torch.tools.bench_lab import mosaic_inputs

SMS = 132  # an H100's SMs
C, K, N, GRID = 512, 11, 1 << 13, 4  # suite_mosaic's shapes


def _is_pow2(p):
    return p >= 1 and p & (p - 1) == 0


GRIDS = [1, 2, 4, 32, 33, 132, 264, 300]


@pytest.mark.parametrize("chunk", [256, 512, 768, 1024, 4096])
@pytest.mark.parametrize("sms", [SMS, 114, 8])
def test_col_pieces_are_tma_boxes_within_one_cta_a_sm(chunk, sms):
    for grid in GRIDS:
        p = lab.col_pieces(chunk, grid, sms)
        width = chunk // p
        assert _is_pow2(p) and chunk % p == 0
        assert width % 4 == 0 and width <= lab.TMA_BOX  # a 16 B multiple of 4 B words
        fewest = p == 1 or chunk // (p // 2) > lab.TMA_BOX
        assert grid * p <= sms or fewest, (grid, p)  # so within two CTAs a SM too
        # the most: one more doubling breaks a condition
        assert (grid * 2 * p > sms or chunk % (2 * p) or (chunk // (2 * p)) % 4), (grid, p)


@pytest.mark.parametrize("chunk", [4, 8, 256, 512, 1000, 1024])
@pytest.mark.parametrize("sms", [SMS, 8])
def test_row_pieces_start_every_output_on_16_bytes(chunk, sms):
    for grid in GRIDS:
        p = lab.row_pieces(chunk, grid, sms)
        rows = chunk // p
        assert _is_pow2(p) and chunk % p == 0 and rows % 4 == 0
        assert grid * p <= sms or p == 1
        assert (grid * 2 * p > sms or chunk % (2 * p) or (chunk // (2 * p)) % 4)
        for k in range(1, 25):  # every piece's output offset, whatever K
            for t in range(min(grid, 3)):
                for q in range(p):
                    assert ((t * chunk + q * rows) * k * 4) % 16 == 0


def test_probe_shapes_take_32_pieces_one_cta_a_sm():
    assert lab.col_pieces(C, GRID, SMS) == 32  # [11, 16] boxes, 64 B wide: 128 CTAs
    assert lab.row_pieces(C, GRID, SMS) == 32  # 16 rows, 704 B
    assert lab.col_pieces(C, 32, SMS) == lab.row_pieces(C, 32, SMS) == 4
    assert lab.col_pieces(C, 300, SMS) == 2  # a box holds at most 256 columns
    assert lab.row_pieces(C, 300, SMS) == 1


def test_pieces_refuse_chunks_they_cannot_cut():
    with pytest.raises(ValueError, match="multiple of 4"):
        lab.col_pieces(258, 4, SMS)  # 129-wide halves
    with pytest.raises(ValueError, match="multiple of 4 rows"):
        lab.row_pieces(510, 4, SMS)


# ----------------------------------------------------------- the models


def model_col_slices(src, off, chunk, grid, pieces):
    """#8/#9 as its CTAs address it: piece (p, t) loads the box [R, w] at
    column start + p*w (w = chunk // pieces) and stores it through the
    tiles' map [grid*R, chunk] at (t*R, p*w); an out-of-range slice zeros
    its pieces. Scalars: piece 0's first word."""
    R, n = src.shape
    w = chunk // pieces
    out = np.full((grid * R, chunk), 0x7F, src.dtype)  # poison: every word is written
    scalars = np.full(grid, 0x7F, src.dtype)
    for t in range(grid):
        o = int(off[t])
        start = (o // chunk) * chunk if o >= 0 else n
        for p in range(pieces):
            if start + chunk > n:
                out[t * R:(t + 1) * R, p * w:(p + 1) * w] = 0
                scalars[t] = 0 if p == 0 else scalars[t]
                continue
            c0 = start + p * w
            assert 0 <= c0 and c0 + w <= n  # no box relies on the map's out-of-bounds fill
            box = src[0:R, c0:c0 + w]
            out[t * R:(t + 1) * R, p * w:(p + 1) * w] = box
            if p == 0:
                scalars[t] = box[0, 0]
    return out.reshape(grid, R, chunk), scalars


def model_row_slices(src, off, chunk, grid, pieces):
    """#10 as its CTAs address it, on the raw bytes of src: piece (p, t)
    reads the enclosing span [lo, hi) of its bytes, shifts by b0 - lo and
    writes its bytes at (t*chunk + p*rows)*K*4 of the tiles."""
    n, k = src.shape
    raw = src.tobytes()
    rows = chunk // pieces
    piece = rows * k * 4
    out = bytearray(b"\x7f" * (grid * chunk * k * 4))
    scalars = np.full(grid, np.nan, np.float32)
    for t in range(grid):
        o = int(off[t])
        for p in range(pieces):
            dst = (t * chunk + p * rows) * k * 4
            assert dst % 16 == 0
            if o < 0 or o + chunk > n:
                out[dst:dst + piece] = bytes(piece)
                scalars[t] = 0.0 if p == 0 else scalars[t]
                continue
            b0 = (o + p * rows) * k * 4
            lo, hi = b0 & ~15, (b0 + piece + 15) & ~15
            shift = b0 - lo
            assert lo % 16 == 0 and hi % 16 == 0 and hi <= len(raw)
            assert shift in (0, 4, 8, 12) and hi - lo <= piece + 16
            span = raw[lo:hi]  # one bulk copy
            out[dst:dst + piece] = span[shift:shift + piece]
            if p == 0:
                scalars[t] = np.frombuffer(span[shift:shift + 4], np.float32)[0]
    return np.frombuffer(bytes(out), np.float32).reshape(grid, chunk, k), scalars


def _row_offsets(n, chunk):
    """Row residues 0-3, the last in-range row, one past it, below 0, n."""
    return np.array([1000, 1001, 1002, 1003, n - chunk, n - chunk + 1, -1, n], np.int32)


@pytest.mark.parametrize("pieces", [1, 4, 32, 64, 128])
@pytest.mark.parametrize("k", [1, 11, 24])
def test_row_span_model_rebuilds_the_plain_tiles(k, pieces):
    rng = np.random.default_rng(k + pieces)
    src = rng.standard_normal((N, k), dtype=np.float32)
    off = _row_offsets(N, C)
    grid = off.size
    tiles, scalars = model_row_slices(src, off, C, grid, pieces)
    want_t, want_s = lab.row_slices_plain(torch.from_numpy(src), torch.from_numpy(off), C, grid)
    assert tiles.tobytes() == want_t.numpy().tobytes()
    assert scalars.tobytes() == want_s.numpy().tobytes()
    assert (tiles[:4] != 0).any(axis=(1, 2)).all() and (tiles[5:] == 0).all()


def test_row_span_model_takes_every_shift_at_the_probe_shapes():
    """At K = 11 (44 B rows) the row residue mod 4 sets the shift: 0, 12,
    8, 4 bytes for residues 0-3; every piece of a slice shares it."""
    rows = C // lab.row_pieces(C, GRID, SMS)
    for residue, shift in zip(range(4), (0, 12, 8, 4)):
        for p in range(C // rows):
            b0 = (1000 + residue + p * rows) * K * 4
            assert b0 - (b0 & ~15) == shift


@pytest.mark.parametrize("pieces", [2, 8, 32, 64, 128])
@pytest.mark.parametrize("dtype, rows", [(np.float32, 11), (np.int32, 1), (np.float32, 24)])
def test_col_box_model_rebuilds_the_plain_tiles(dtype, rows, pieces):
    rng = np.random.default_rng(rows + pieces)
    if dtype == np.int32:
        src = rng.integers(-(1 << 31), 1 << 31, (rows, N), dtype=np.int64).astype(np.int32)
    else:
        src = rng.standard_normal((rows, N), dtype=np.float32)
    off = np.array([0, 1, 777, N - C, N - 1, N, -1, -C], np.int32)
    grid = off.size
    tiles, scalars = model_col_slices(src, off, C, grid, pieces)
    want_t, want_s = lab.col_slices_plain(torch.from_numpy(src), torch.from_numpy(off), C, grid)
    assert tiles.tobytes() == want_t.numpy().tobytes()
    assert scalars.tobytes() == want_s.numpy().tobytes()
    assert (tiles[5:] == 0).all() and (tiles[:5] != 0).any(axis=(1, 2)).all()


def test_models_at_the_suite_draws():
    """The models at `suite_mosaic`'s own draws and the rule's piece counts."""
    x = mosaic_inputs()
    d_t, d_rows, off = x["d_t"], x["d_rows"], x["off"]
    assert d_t.shape == (K, N) and d_rows.shape == (N, K)
    t_off = torch.from_numpy(off)
    tiles, _ = model_col_slices(d_t, off, C, GRID, lab.col_pieces(C, GRID, SMS))
    assert tiles.tobytes() == lab.col_slices_plain(torch.from_numpy(d_t), t_off, C,
                                                    GRID)[0].numpy().tobytes()
    tiles, _ = model_row_slices(d_rows, off, C, GRID, lab.row_pieces(C, GRID, SMS))
    assert tiles.tobytes() == lab.row_slices_plain(torch.from_numpy(d_rows), t_off, C,
                                                    GRID)[0].numpy().tobytes()

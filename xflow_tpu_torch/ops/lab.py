"""Kernels of the Hopper lab (`tools/bench_lab.py`): the slice-shape
probes #7-#10 of its `mosaic` suite and the row reduction #11 of its
`rowsum` suite, each with its plain PyTorch version.

- `block_scale` (#7, `csrc/lab_mosaic.cu`): ``scale * table`` one [W, K]
  row block at a time (`suite_mosaic.fa`);
- `col_slices` (#8 f32, #9 i32): tile t is the [R, C] column slice of
  an [R, N] array at column ``(off[t] // C) * C``, copied in
  `col_pieces` column pieces by TMA boxes (`fb`, `fc`);
- `row_slices` (#10): tile t is the [C, K] row slice of an [N, K] f32
  array at the unaligned row ``off[t]``, copied in `row_pieces` row
  pieces by 1-D bulk copies (`fd`);
- `tma_encode`: what the driver's cuTensorMapEncodeTiled says of the
  plain 2-D tensor map of an array (0 = it encodes), the counterpart of
  the TPU probe's OK/FAIL;
- `lab_rowsum` (#11, `csrc/lab_rowsum.cu`): ``out[B, ch]`` row sums of
  occurrences in any order (`suite_rowsum.rowsum_pallas`): each nonzero
  quad of channels one vector reduction into device memory, neighbouring
  quads from neighbouring threads.

The slice probes return every block's tile and scalar: the TPU kernels
wrote one scalar at every step of an in-order grid and the last one
stayed; the card's blocks run in any order, so each block writes its own
(``scalars[-1]`` is the TPU's value). A slice that leaves its array reads
as zeros. A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. `LAUNCHES` counts
kernel launches.
"""

from __future__ import annotations

import torch

from xflow_tpu_torch.ops.sorted_table import _check, _on_cpu, _require_cuda

TMA_BOX = 256  # a TMA box dimension holds at most 256 elements

LAUNCHES = {"mosaic_a": 0, "mosaic_b": 0, "mosaic_c": 0, "mosaic_d": 0, "lab_rowsum": 0}
# the pieces each slice probe's last launch cut a slice into (0: none yet)
PIECES = {"mosaic_b": 0, "mosaic_c": 0, "mosaic_d": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _aligned16(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs and outputs must start on a 16 B boundary")


def _launch(device: torch.device, fn, *args) -> int:
    """fn(*args, stream) on `device`'s current stream; its CUDA error."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------- #7: block-wise scale

def _check_blocks(table: torch.Tensor, block_rows: int) -> None:
    _check(table, "table", torch.float32, 2)
    S, K = table.shape
    if block_rows < 1 or S % block_rows or (block_rows * K * 4) % 16:
        raise ValueError(
            f"table {tuple(table.shape)} does not split into [{block_rows}, {K}] blocks "
            "of a multiple of 16 B"
        )


def block_scale_plain(table: torch.Tensor, block_rows: int = 512, scale: float = 2.0) -> torch.Tensor:
    """Plain PyTorch version of #7: ``scale * table``."""
    _check_blocks(table, block_rows)
    return table * scale


def block_scale_cuda(table: torch.Tensor, block_rows: int = 512, scale: float = 2.0) -> torch.Tensor:
    """Launch #7 (`csrc/lab_mosaic.cu`) on a CUDA table: each [block_rows,
    K] row block cut into 16 B aligned pieces (8 of 2,816 B at the probe's
    shapes on an H100: 256 CTAs on 132 SMs), a CTA a piece, copied into
    shared memory by one 1-D bulk copy, scaled, stored with 16 B stores.

    Replaces `suite_mosaic.fa` (xflow_tpu/tools/bench_lab.py:441). At the
    probe's 720 KB each CTA's copy-in, wait and store run one after
    another, far over the bytes bound (the table read and written once);
    the pieces spread those chains over the card's SMs."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(table)
    _check_blocks(table, block_rows)
    out = torch.empty_like(table)
    _aligned16(table, out)
    lib = kernels.load("lab_mosaic")
    S, K = table.shape
    err = _launch(table.device, lib.xf_lab_scale_blocks, table.data_ptr(), out.data_ptr(),
                  S // block_rows, block_rows * K, scale)
    kernels.check(err, "lab block_scale")
    LAUNCHES["mosaic_a"] += 1
    return out


def block_scale(table: torch.Tensor, block_rows: int = 512, scale: float = 2.0) -> torch.Tensor:
    if _on_cpu(table):
        return block_scale_plain(table, block_rows, scale)
    return block_scale_cuda(table, block_rows, scale)


# ------------------------------------------ #8, #9: column slices via TMA

def _check_slices(src: torch.Tensor, off: torch.Tensor, grid: int) -> None:
    _check(off, "off", torch.int32, 1)
    if not 1 <= grid <= off.shape[0]:
        raise ValueError(f"grid {grid} needs 1..{off.shape[0]} offsets")
    if src.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"src: expected float32 or int32, got {src.dtype}")
    if src.ndim != 2 or not src.is_contiguous():
        raise ValueError(f"src: expected a contiguous 2-D array, got {tuple(src.shape)}")


def col_slices_plain(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    """Plain PyTorch version of #8/#9: for t < grid, tile t = ``src[:,
    start:start + chunk]`` at ``start = (off[t] // chunk) * chunk`` (zeros
    where off[t] < 0 or the slice leaves src), scalar t = ``tile[0, 0]``.
    Returns (tiles [grid, R, chunk], scalars [grid])."""
    _check_slices(src, off, grid)
    R, N = src.shape
    tiles = torch.zeros((grid, R, chunk), dtype=src.dtype, device=src.device)
    for t, o in enumerate(off[:grid].tolist()):
        start = (o // chunk) * chunk
        if o >= 0 and start + chunk <= N:
            tiles[t] = src[:, start:start + chunk]
    return tiles, tiles[:, 0, 0].clone()


def _pieces(chunk: int, grid: int, sms: int, p: int) -> int:
    """Double `p` while the grid of grid * 2p CTAs stays within one a SM and
    each of the 2p pieces of `chunk` stays a whole multiple of 4 words.

    One CTA a SM, where #7 takes two: a piece's CTA is one warp running one
    serial chain (offset, copy in, store), and at the probe's shapes 32
    pieces a slice (128 CTAs) beat 64 (256) by 0.03-0.07 us for #8, #9
    and #10 alike on an H100 80GB HBM3 at 700.00 W (PERF.md §6)."""
    while grid * 2 * p <= sms and chunk % (2 * p) == 0 and (chunk // (2 * p)) % 4 == 0:
        p *= 2
    return p


def col_pieces(chunk: int, grid: int, sms: int) -> int:
    """Column pieces a slice of #8/#9 is cut into, a power of two: the fewest
    whose width ``chunk // P`` fits a TMA box (256 elements), doubled while
    ``grid * P`` stays within one CTA a SM and the width a multiple of 4
    words (16 B). 32 pieces of [R, 16] at the probe's grid 4, chunk 512 on
    132 SMs (128 CTAs)."""
    p = 1
    while chunk // p > TMA_BOX:
        p *= 2
    if chunk % p or (chunk // p) % 4:
        raise ValueError(f"chunk {chunk} does not cut into TMA boxes of at most {TMA_BOX} "
                         "elements, a multiple of 4")
    return _pieces(chunk, grid, sms, p)


def row_pieces(chunk: int, grid: int, sms: int) -> int:
    """Row pieces a slice of #10 is cut into, a power of two: doubled from 1
    while ``grid * P`` stays within one CTA a SM and ``chunk // P`` a
    multiple of 4 rows (so each piece's output starts on 16 B whatever K).
    32 pieces of 16 rows at the probe's grid 4, chunk 512 on 132 SMs."""
    if chunk % 4:
        raise ValueError(f"chunk {chunk}: a row slice's pieces need a multiple of 4 rows")
    return _pieces(chunk, grid, sms, 1)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def col_slices_cuda(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    """Launch #8 (f32) or #9 (i32) of `csrc/lab_mosaic.cu`: a CTA of one warp
    for each of the `col_pieces` column pieces P of each slice; the piece
    comes in as one [R, chunk / P] box of a 2-D TMA tensor map over src
    [R, N] and leaves by one TMA store through a map over the tiles. P is
    left in `PIECES`.

    Replaces `suite_mosaic.fb` / `fc` (xflow_tpu/tools/bench_lab.py:462,
    :484). At the probe's 4 slices of 22.5 KB or 2 KB the bytes bound lies
    far under the launch floor; the pieces spread the slices over the SMs,
    so each CTA's chain (offset, box in, store) is short. Raises where a
    tensor map does not encode (R <= 256, N * 4 a multiple of 16 and a
    16 B aligned src are what it needs)."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(src, off)
    _check_slices(src, off, grid)
    R, N = src.shape
    if chunk % TMA_BOX or N % chunk or R > TMA_BOX:
        raise ValueError(
            f"src {tuple(src.shape)}: the slice needs N a multiple of chunk {chunk}, chunk a "
            f"multiple of {TMA_BOX} and at most {TMA_BOX} rows"
        )
    pieces = col_pieces(chunk, grid, _sms(src.device))
    tiles = torch.empty((grid, R, chunk), dtype=src.dtype, device=src.device)
    scalars = torch.empty((grid,), dtype=src.dtype, device=src.device)
    _aligned16(src, tiles)
    lib = kernels.load("lab_mosaic")
    is_int = int(src.dtype == torch.int32)
    err = _launch(src.device, lib.xf_lab_dma_cols, src.data_ptr(), is_int, off.data_ptr(),
                  tiles.data_ptr(), scalars.data_ptr(), R, N, chunk, grid, pieces)
    if err < 0:
        raise RuntimeError(f"lab col_slices: the tensor maps of {tuple(src.shape)} and its "
                           f"tiles did not encode ({tma_result(-err)})")
    kernels.check(err, "lab col_slices")
    key = "mosaic_c" if is_int else "mosaic_b"
    LAUNCHES[key] += 1
    PIECES[key] = pieces
    return tiles, scalars


def col_slices(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    if _on_cpu(src, off):
        return col_slices_plain(src, off, chunk, grid)
    return col_slices_cuda(src, off, chunk, grid)


# ---------------------------------------- #10: unaligned row slices, bulk

def _check_rows(src: torch.Tensor, off: torch.Tensor, grid: int) -> None:
    _check(src, "src", torch.float32, 2)
    _check_slices(src, off, grid)


def row_slices_plain(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    """Plain PyTorch version of #10: for t < grid, tile t = ``src[off[t]:
    off[t] + chunk]`` (zeros where the slice leaves src), scalar t =
    ``tile[0, 0]``. Returns (tiles [grid, chunk, K], scalars [grid])."""
    _check_rows(src, off, grid)
    N, K = src.shape
    tiles = torch.zeros((grid, chunk, K), dtype=src.dtype, device=src.device)
    for t, o in enumerate(off[:grid].tolist()):
        if 0 <= o and o + chunk <= N:
            tiles[t] = src[o:o + chunk]
    return tiles, tiles[:, 0, 0].clone()


def row_slices_cuda(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    """Launch #10 of `csrc/lab_mosaic.cu`: a CTA of one warp for each of the
    `row_pieces` row pieces P of each slice; one 1-D bulk copy of the 16 B
    aligned span enclosing the piece, then the shift in registers and 16 B
    stores. A 44 B row stride has no tensor map. P is left in `PIECES`.

    Replaces `suite_mosaic.fd` (xflow_tpu/tools/bench_lab.py:506). At the
    probe's 4 slices of 22.5 KB the bytes bound lies far under the launch
    floor; the pieces spread the slices over the SMs."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(src, off)
    _check_rows(src, off, grid)
    N, K = src.shape
    if (N * K * 4) % 16:
        raise ValueError(f"src {tuple(src.shape)}: its bytes must be a multiple of 16")
    pieces = row_pieces(chunk, grid, _sms(src.device))
    tiles = torch.empty((grid, chunk, K), dtype=src.dtype, device=src.device)
    scalars = torch.empty((grid,), dtype=src.dtype, device=src.device)
    _aligned16(src, tiles)
    lib = kernels.load("lab_mosaic")
    err = _launch(src.device, lib.xf_lab_dma_rows, src.data_ptr(), off.data_ptr(),
                  tiles.data_ptr(), scalars.data_ptr(), N, K, chunk, grid, pieces)
    kernels.check(err, "lab row_slices")
    LAUNCHES["mosaic_d"] += 1
    PIECES["mosaic_d"] = pieces
    return tiles, scalars


def row_slices(src: torch.Tensor, off: torch.Tensor, chunk: int = 512, grid: int = 4):
    if _on_cpu(src, off):
        return row_slices_plain(src, off, chunk, grid)
    return row_slices_cuda(src, off, chunk, grid)


# ------------------------------------------------------- TMA encode probe

CU_RESULTS = {1: "CUDA_ERROR_INVALID_VALUE", 1000: "the driver has no cuTensorMapEncodeTiled"}


def tma_result(code: int) -> str:
    return "OK" if code == 0 else f"FAIL {code} {CU_RESULTS.get(code, 'CUresult')}"


def tma_encode(src: torch.Tensor, box: tuple) -> int:
    """The CUresult of cuTensorMapEncodeTiled for the plain 2-D tensor map
    of CUDA array src [rows, cols] (f32 or i32, its own row stride) in
    boxes of `box` = (box_rows, box_cols): 0 where it encodes."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(src)
    if src.ndim != 2 or src.dtype not in (torch.float32, torch.int32):
        raise ValueError(f"src: expected a 2-D f32 or i32 array, got {tuple(src.shape)} {src.dtype}")
    rows, cols = src.shape
    lib = kernels.load("lab_mosaic")
    with torch.cuda.device(src.device):
        return lib.xf_lab_tma_encode(src.data_ptr(), int(src.dtype == torch.int32), cols, rows,
                                     src.stride(0) * 4, box[1], box[0])


# ------------------------------------------------------ #11: row reduction

def _check_rowsum(vals: torch.Tensor, rows: torch.Tensor) -> None:
    _check(vals, "vals", torch.float32, 2)
    _check(rows, "rows", torch.int32, 1)
    if rows.shape[0] != vals.shape[1]:
        raise ValueError(f"rows has {rows.shape[0]} entries, vals {vals.shape[1]} columns")


def rowsum_plain(vals: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain PyTorch version of #11, in the TPU kernel's order: the even
    occurrences and the odd ones summed apart with `index_add_`, then
    added; rows outside [0, num_rows) skipped."""
    _check_rowsum(vals, rows)
    j = torch.arange(rows.shape[0], device=rows.device)
    keep = (rows >= 0) & (rows < num_rows)
    halves = []
    for parity in (0, 1):
        sel = keep & (j % 2 == parity)
        out = torch.zeros((num_rows, vals.shape[0]), dtype=vals.dtype, device=vals.device)
        halves.append(out.index_add_(0, rows[sel].long(), vals[:, sel].T))
    return halves[0] + halves[1]


def rowsum_cuda(vals: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Launch #11 (`csrc/lab_rowsum.cu`): a grid-stride loop over
    (position, quad) pairs, quads fastest, each nonzero quad added into
    its output row with one `red.global.add.v4.f32`, so a warp's
    reductions fall on neighbouring addresses.

    Replaces `suite_rowsum.rowsum_pallas` (xflow_tpu/tools/bench_lab.py:714).
    Bound by bytes on the H100: (ch + 1) * 4 B read per occurrence, the
    [B, ch] sums written once. Float reductions reorder the sums
    (tolerance: the float32 reorder bound, `bench_lab.reorder_err`)."""
    from xflow_tpu_torch.ops import kernels

    _require_cuda(vals, rows)
    _check_rowsum(vals, rows)
    ch, np_ = vals.shape
    if ch % 4:
        raise ValueError(f"lab_rowsum: ch={ch} must be a multiple of 4 (16 B output rows)")
    out = torch.zeros((num_rows, ch), dtype=torch.float32, device=vals.device)
    _aligned16(out)
    lib = kernels.load("lab_rowsum")
    if np_ and num_rows and ch:
        err = _launch(vals.device, lib.xf_lab_rowsum, vals.data_ptr(), rows.data_ptr(),
                      out.data_ptr(), ch, np_, num_rows)
        kernels.check(err, "lab_rowsum")
        LAUNCHES["lab_rowsum"] += 1
    return out


def rowsum_l2_reductions(vals: torch.Tensor, rows: torch.Tensor, num_rows: int) -> int:
    """The L2 vector reductions #11 sends for these inputs, computed from
    them: one a nonzero quad of an occurrence whose row is in [0,
    num_rows)."""
    keep = (rows >= 0) & (rows < num_rows)
    quads = vals.reshape(vals.shape[0] // 4, 4, -1).ne(0).any(1)
    return int((quads & keep[None, :]).sum().item())


def lab_rowsum(vals: torch.Tensor, rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """out[r, c] = sum of vals[c, j] over occurrences j with rows[j] = r."""
    if _on_cpu(vals, rows):
        return rowsum_plain(vals, rows, num_rows)
    return rowsum_cuda(vals, rows, num_rows)

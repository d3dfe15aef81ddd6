"""The grid of the galerkin kernels (``ops/cuda/galerkin.py``), on the CPU.

Each kernel walks a CTA's rows in chunks of a fixed size and refuses a grid
whose CTAs do not own whole chunks, or whose last CTA has no rows; the
wrapper's `split_grid` must only give grids the kernels take.
"""
import math
import re
from pathlib import Path

import pytest

from galerkin_transformer_torch.ops.cuda import galerkin as GS

CSRC = Path(GS.__file__).resolve().parents[2] / "csrc"

# (B*H, n) on the main paths: ex1 at n = 8192 and 2048, ex2 serving at
# (n_f, n_c) = (141, 43) and (211, 71), ex2 training at (211, 43) with
# subsample_attn 5; then ragged n, single rows and wide batches
MAIN = [(8, 8192), (8, 2048), (16, 43 ** 2), (16, 71 ** 2), (16, 1849)]
RAGGED = [(1, 1), (3, 5), (2, 63), (2, 65), (5, 2100), (64, 4097), (200, 129)]
# (SMs, CTAs per SM): the H100 SXM's 132 SMs at the occupancies the kernels
# report, and a card with fewer SMs
CARDS = [(132, 1), (132, 2), (132, 4), (114, 3)]


@pytest.mark.parametrize("name", sorted(GS.CHUNK_ROWS))
@pytest.mark.parametrize("bh,n", MAIN + RAGGED)
def test_split_grid_gives_whole_chunks_and_no_empty_cta(name, bh, n):
    chunk = GS.CHUNK_ROWS[name]
    for sms, ctas in CARDS:
        rows, splits = GS.split_grid(bh, n, sms, chunk, ctas, name in GS.COOPERATIVE)
        assert rows >= chunk and rows % chunk == 0, (sms, ctas, rows)
        assert (splits - 1) * rows < n <= splits * rows, (sms, ctas, rows, splits)
        # no more CTAs per bh than the card holds at once, rounded up
        assert splits <= math.ceil(ctas * sms / bh), (sms, ctas, splits)


@pytest.mark.parametrize("bh,n", MAIN + RAGGED + [(300, 5041), (264, 1849), (133, 4097)])
def test_a_cooperative_grid_of_several_splits_fits_the_card(bh, n):
    """A grid that fits keeps the other grids' whole chunks and rows, and
    has more than one split only where all its CTAs are on the card at once."""
    for name in GS.COOPERATIVE:
        chunk = GS.CHUNK_ROWS[name]
        for sms, ctas in CARDS:
            rows, splits = GS.split_grid(bh, n, sms, chunk, ctas, fit=True)
            assert rows % chunk == 0 and (splits - 1) * rows < n <= splits * rows
            assert splits == 1 or bh * splits <= ctas * sms, (sms, ctas, splits)
            assert splits <= GS.split_grid(bh, n, sms, chunk, ctas)[1]


def test_split_grid_of_the_bfloat16_forward_on_the_main_paths():
    """Fitting the card leaves the main paths' grids as they were rounded up:
    two CTAs per SM, 64-row chunks, 132 SMs."""
    chunk = GS.CHUNK_ROWS["galerkin_scores_bf16"]
    for bh, n, grid in [(8, 8192, (256, 32)), (16, 5041, (320, 16)), (16, 1849, (128, 15))]:
        assert GS.split_grid(bh, n, 132, chunk, 2, fit=True) == grid
        assert GS.split_grid(bh, n, 132, chunk, 2) == grid


def test_split_grid_of_the_float32_forward():
    """The float32 forward keeps its grid: two CTAs per SM, 32-row chunks."""
    chunk = GS.CHUNK_ROWS["galerkin_scores"]
    assert GS.split_grid(8, 8192, 132, chunk, 2) == (256, 32)    # ex1
    assert GS.split_grid(16, 5041, 132, chunk, 2) == (320, 16)   # ex2 serving


@pytest.mark.parametrize("name", sorted(GS.CHUNK_ROWS))
def test_chunk_rows_are_what_each_kernel_declares(name):
    text = (CSRC / f"{name}.cu").read_text()
    declared = re.findall(r"constexpr int (?:kRowsPerChunk|kRows) = (\d+);", text)
    assert declared == [str(GS.CHUNK_ROWS[name])]


def test_every_galerkin_kernel_has_its_chunk_rows():
    assert sorted(GS.CHUNK_ROWS) == sorted(p.stem for p in CSRC.glob("galerkin_scores*.cu"))

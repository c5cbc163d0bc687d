"""K1's launch plans above its narrow kernel's widest band, by band width
and batch (resquiggle/banded_kernel.py NARROW_MAX_W, FULL_BATCH,
wide_plan, WIDE_PLANS) against the kernel's own table, threshold and edge
(csrc/banded_sw.cu WIDE_PLANS, FULL_BATCH, NARROW_MAX_W), and what a plan
must give at every band width in (NARROW_MAX_W, 32768] and every batch:
lanes that cover the band, a block the card can launch, shared memory a
block can hold.  No card needed: the C table is read from the source."""

import os
import re

import pytest

from nanomod_tpu_torch.resquiggle import banded_kernel as bk

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "nanomod_tpu_torch", "csrc", "banded_sw.cu")


def _c_source():
    with open(SRC) as f:
        return f.read()


def _c_plans():
    """WIDE_PLANS of csrc/banded_sw.cu: (max_w, part plan, full plan)
    rows, each plan a 3-tuple."""
    table = re.search(r"WIDE_PLANS\[\] = \{(.*?)\};", _c_source(), re.S)
    assert table, "csrc/banded_sw.cu has no WIDE_PLANS table"
    rows = re.findall(r"\{\s*(\d+),\s*\{([^{}]*)\},\s*\{([^{}]*)\}\s*\}",
                      table.group(1))
    assert rows and len(rows) == table.group(1).count("}},")
    return tuple((int(w), tuple(int(x) for x in part.split(",")),
                  tuple(int(x) for x in full.split(",")))
                 for w, part, full in rows)


def _c_int(name):
    found = re.search(rf"constexpr int {name} = (\d+);", _c_source())
    assert found, f"csrc/banded_sw.cu has no {name}"
    return int(found.group(1))


def test_python_plans_are_the_kernels_table():
    assert bk.WIDE_PLANS == _c_plans()
    assert _c_int("NARROW_MAX_W") == bk.NARROW_MAX_W
    assert _c_int("FULL_BATCH") == bk.FULL_BATCH


def test_plans_cover_the_wide_range_in_order():
    max_ws = [p[0] for p in bk.WIDE_PLANS]
    assert max_ws == sorted(max_ws)
    assert len(set(max_ws)) == len(max_ws)
    assert max_ws[-1] == bk.MAX_W
    assert bk.NARROW_MAX_W < max_ws[0]
    assert bk.NARROW_MAX_W <= 1024   # one warp of 32 lanes a thread at most
    assert 1 < bk.FULL_BATCH <= 256  # both plans of a row are reachable
    for _, *plans in bk.WIDE_PLANS:
        for lanes, max_threads, min_blocks in plans:
            assert lanes in (2, 4, 8, 16, 32)   # the nibble window's words
            assert max_threads % 32 == 0 and max_threads <= 1024
            assert min_blocks >= 1


def test_static_shared_memory_is_the_kernels():
    """WIDE_STATIC_SMEM counts the wide kernel's __shared__ arrays."""
    src = _c_source()
    body = src[src.index("banded_sw_wide_kernel(const"):]
    body = body[:body.index("const int nt = blockDim.x;")]
    rc = int(re.search(r"constexpr int RC = (\d+);", src).group(1))
    sizes = {"uint32_t": 4, "float": 4, "int": 4}
    total = 0
    for typ, names in re.findall(
            r"__shared__ (?:__align__\(\d+\) )?(uint32_t|float|int) ([^;]+);",
            body):
        for dims in re.findall(r"\w+((?:\[\w+\])+)", names):
            n = 1
            for d in re.findall(r"\[(\w+)\]", dims):
                n *= rc if d == "RC" else int(d)
            total += sizes[typ] * n
    assert total == bk.WIDE_STATIC_SMEM


@pytest.mark.parametrize("lo,hi", [(bk.NARROW_MAX_W + 1, 9217),
                                   (9217, 17409), (17409, 25601),
                                   (25601, 32769)])
def test_every_wide_band_width_has_a_launch(lo, hi):
    """For every W and both of its plans (a batch below FULL_BATCH and one
    at it): the lanes cover W and no whole warp lies past it, the block is
    within the instantiation's threads bound and 1,024 threads, its shared
    memory within 227 KB, and the plan is of the first row whose largest W
    is at least W (the C dispatch's rule)."""
    rows = _c_plans()
    for w in range(lo, hi):
        first = next(row for row in rows if w <= row[0])
        for bsz, want in ((bk.FULL_BATCH - 1, first[1]),
                          (bk.FULL_BATCH, first[2])):
            p = bk.wide_plan(w, bsz)
            assert (p["lanes"], p["max_threads"], p["min_blocks"]) == want
            assert p["threads"] == 32 * p["warps"]
            assert p["threads"] * p["lanes"] >= w
            assert (p["threads"] - 32) * p["lanes"] < w
            assert p["threads"] <= p["max_threads"] <= 1024
            assert p["warps"] <= 32              # one redux lane a warp
            assert p["smem_bytes"] <= bk.SMEM_PER_BLOCK


@pytest.mark.parametrize("row", range(len(bk.WIDE_PLANS)))
def test_every_batch_has_exactly_one_plan(row):
    """Of a row's two plans, exactly one holds each batch of 1 to 256
    reads (the part plan below FULL_BATCH, the full plan from it), and
    every W of the row in exactly one row: wide_plan(w, b) is that plan
    at the row's edges and on a grid of its widths."""
    max_w, part, full = bk.WIDE_PLANS[row]
    lo = bk.WIDE_PLANS[row - 1][0] + 1 if row else bk.NARROW_MAX_W + 1
    widths = sorted({w for w in (lo, lo + 1, max_w - 1, max_w)
                     if lo <= w <= max_w} | set(range(lo, max_w + 1, 97)))
    for w in widths:
        assert sum(r_lo < w <= r[0] for r_lo, r in zip(
            [bk.NARROW_MAX_W] + [r[0] for r in bk.WIDE_PLANS],
            bk.WIDE_PLANS)) == 1
    for bsz in range(1, 257):
        holds = [bsz < bk.FULL_BATCH, bsz >= bk.FULL_BATCH]
        assert sum(holds) == 1
        want = part if holds[0] else full
        for w in widths:
            p = bk.wide_plan(w, bsz)
            assert (p["lanes"], p["max_threads"], p["min_blocks"]) == want


def test_no_plan_for_an_empty_batch():
    with pytest.raises(ValueError, match="a batch of 0"):
        bk.wide_plan(bk.NARROW_MAX_W + 1, 0)


@pytest.mark.parametrize("w", [1, bk.NARROW_MAX_W, 32769, 65536])
def test_narrow_and_too_wide_bands_have_no_wide_plan(w):
    with pytest.raises(ValueError, match="is not in"):
        bk.wide_plan(w, 256)

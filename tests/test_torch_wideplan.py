"""K1's launch plans above its narrow kernel's widest band
(resquiggle/banded_kernel.py NARROW_MAX_W, wide_plan, WIDE_PLANS) against
the kernel's own table and edge (csrc/banded_sw.cu WIDE_PLANS,
NARROW_MAX_W), and what a plan must give at every band width in
(NARROW_MAX_W, 32768]: lanes that cover the band, a block the card can
launch, shared memory a block can hold.  No card needed: the C table is
read from the source."""

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
    """WIDE_PLANS of csrc/banded_sw.cu as a tuple of 4-tuples."""
    table = re.search(r"WIDE_PLANS\[\] = \{(.*?)\};", _c_source(), re.S)
    assert table, "csrc/banded_sw.cu has no WIDE_PLANS table"
    return tuple(tuple(int(x) for x in row) for row in re.findall(
        r"\{\s*(\d+),\s*(\d+),\s*(\d+),\s*(\d+)\s*\}", table.group(1)))


def test_python_plans_are_the_kernels_table():
    assert bk.WIDE_PLANS == _c_plans()
    edge = re.search(r"constexpr int NARROW_MAX_W = (\d+);", _c_source())
    assert edge and int(edge.group(1)) == bk.NARROW_MAX_W


def test_plans_cover_the_wide_range_in_order():
    max_ws = [p[0] for p in bk.WIDE_PLANS]
    assert max_ws == sorted(max_ws)
    assert max_ws[-1] == bk.MAX_W
    assert bk.NARROW_MAX_W < max_ws[0]
    assert bk.NARROW_MAX_W <= 1024   # one warp of 32 lanes a thread at most
    for _, lanes, max_threads, min_blocks in bk.WIDE_PLANS:
        assert lanes in (2, 4, 8, 16, 32)       # the nibble window's words
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
    """For every W: the lanes cover W and no whole warp lies past it, the
    block is within the instantiation's threads bound and 1,024 threads,
    its shared memory within 227 KB, and the plan is the first whose
    largest W is at least W (the C dispatch's rule)."""
    for w in range(lo, hi):
        p = bk.wide_plan(w)
        first = next(row for row in _c_plans() if w <= row[0])
        assert (p["lanes"], p["max_threads"], p["min_blocks"]) == first[1:]
        assert p["threads"] == 32 * p["warps"]
        assert p["threads"] * p["lanes"] >= w
        assert (p["threads"] - 32) * p["lanes"] < w
        assert p["threads"] <= p["max_threads"] <= 1024
        assert p["warps"] <= 32                  # one redux lane a warp
        assert p["smem_bytes"] <= bk.SMEM_PER_BLOCK


@pytest.mark.parametrize("w", [1, bk.NARROW_MAX_W, 32769, 65536])
def test_narrow_and_too_wide_bands_have_no_wide_plan(w):
    with pytest.raises(ValueError, match="is not in"):
        bk.wide_plan(w)

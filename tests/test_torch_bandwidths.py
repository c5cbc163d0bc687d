"""Band widths off the grids of 32 and 4, and above 1024: the port's
banded DP and walk (plain versions of kernels K1 and K2) and its Annotate
against the JAX package on the same inputs.

Off the grid of 32, K1 has a ragged last thread; off the grid of 4, the
step count 2M+W is not a multiple of 4 and the walk's codes stay one a
byte (the reference's mode "codes").  The DP outputs must be array-equal
to JAX ``banded_sw`` and to ``banded_sw_pallas`` in interpret mode, the
walk codes to ``walk_device``, and Annotate's corrected FAST5s byte-equal
to the JAX package's.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from fixtures import make_genome, make_raw_dataset
from test_torch_refnative import ALL_LIBS, require_reference_native
from nanomod_tpu import config as jcfg
from nanomod_tpu.resquiggle import banded as jb
from nanomod_tpu.resquiggle.banded_pallas import banded_sw_pallas
from nanomod_tpu.resquiggle.pipeline import annotate_folder as jax_annotate
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.resquiggle import banded as tb
from nanomod_tpu_torch.resquiggle.pipeline import (
    annotate_folder as torch_annotate)

# B = 8 and M = 32 (the Pallas kernel's 8 reads and 32 rows a step);
# 2M+W is a multiple of 4 at W = 4 and 100 only
WIDTHS = (4, 31, 33, 100, 130)
B, M = 8, 32


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


def _inputs(w):
    """Reads copied from their windows at offset W/2 with 5 % substitutions
    and 2 % N codes, one read shorter than M."""
    rng = np.random.default_rng(10 + w)
    ref = rng.integers(0, 4, (B, M + w)).astype(np.uint8)
    read = np.empty((B, M), np.uint8)
    for i in range(B):
        read[i] = ref[i, w // 2: w // 2 + M]
        mut = rng.random(M) < 0.05
        read[i, mut] = rng.integers(0, 4, mut.sum())
    read[rng.random((B, M)) < 0.02] = 4
    lens = np.full(B, M, np.int32)
    lens[3] = M - 9
    read[3, M - 9:] = 4
    return read, ref, lens


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module", params=WIDTHS, ids=lambda w: f"w{w}")
def dp(request):
    read, ref, lens = _inputs(request.param)
    want = [np.asarray(x) for x in jb.banded_sw(read, ref, lens)]
    got = [x.numpy() for x in tb.banded_sw(*_torch(read, ref, lens))]
    return read, ref, lens, want, got


def test_banded_sw_plain_matches_jax_and_pallas(dp):
    read, ref, lens, want, got = dp
    pal = [np.asarray(x) for x in banded_sw_pallas(read, ref, lens)]
    for name, a, p, b in zip(("tb", "best", "best_i", "best_k"), want, pal,
                             got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(p, b, err_msg=f"pallas {name}")
    assert got[1].min() > 0                    # every read aligned


def test_walk_matches_jax_both_modes(dp):
    """The unpacked walk equals walk_device at every width; where 2M+W is
    a multiple of 4 the packed walk equals pack_codes2 of it (elsewhere it
    raises), and the native decoder reads both layouts alike and agrees
    with the native traceback of the matrix.  Unforced, the walk takes the
    reference's mode: packed exactly where 2M+W is a multiple of 4."""
    *_, want, got = dp
    codes_j = np.asarray(jb.walk_device(want[0], want[2], want[3]))
    t_tb, _, t_bi, t_bk = _torch(*got)
    codes_t, packed_mode = tb.walk(t_tb, t_bi, t_bk, packed=False)
    assert not packed_mode and codes_t.dtype == torch.uint8
    mode_codes, mode = tb.walk(t_tb, t_bi, t_bk)
    assert mode == (codes_j.shape[1] % 4 == 0)
    np.testing.assert_array_equal(codes_j, codes_t.numpy())
    ops = tb.decode_walk_native(codes_t.numpy(), got[2], got[3],
                                packed=False)
    if codes_j.shape[1] % 4 == 0:
        packed = tb.walk(t_tb, t_bi, t_bk, packed=True)[0].numpy()
        np.testing.assert_array_equal(np.asarray(jb.pack_codes2(codes_j)),
                                      packed)
        np.testing.assert_array_equal(mode_codes.numpy(), packed)
        ops_p = tb.decode_walk_native(packed, got[2], got[3], packed=True)
        for a, b in zip(ops, ops_p):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    else:
        with pytest.raises(ValueError, match="four a byte"):
            tb.walk(t_tb, t_bi, t_bk, packed=True)
    trace = tb.traceback_batch_native(got[0], got[2], got[3], packed=False)
    for a, b in zip(ops, trace):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_banded_sw_plain_matches_jax_and_pallas_at_2048():
    """Above 1024 (where K1 runs a block of warps a read) the plain
    version is array-equal to JAX banded_sw and to banded_sw_pallas in
    interpret mode, at B 8, M 32, W 2048, reads anywhere in the band."""
    w, m = 2048, M
    rng = np.random.default_rng(2048)
    ref = rng.integers(0, 4, (B, m + w)).astype(np.uint8)
    read = np.empty((B, m), np.uint8)
    for i in range(B):
        off = int(rng.integers(0, w))
        read[i] = ref[i, off: off + m]
        mut = rng.random(m) < 0.05
        read[i, mut] = rng.integers(0, 5, mut.sum())
    lens = np.full(B, m, np.int32)
    lens[5] = m - 9
    want = [np.asarray(x) for x in jb.banded_sw(read, ref, lens)]
    pal = [np.asarray(x) for x in banded_sw_pallas(read, ref, lens)]
    got = [x.numpy() for x in tb.banded_sw(*_torch(read, ref, lens))]
    for name, a, p, b in zip(("tb", "best", "best_i", "best_k"), want, pal,
                             got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(p, b, err_msg=f"pallas {name}")
    assert got[1].min() > 0 and got[3].max() > 1024
    codes = np.asarray(jb.walk_device(want[0], want[2], want[3]))
    np.testing.assert_array_equal(
        codes, tb.walk(*_torch(got[0], got[2], got[3]), packed=False)[0])


@pytest.fixture(scope="module")
def raw_reads(tmp_path_factory):
    """The case group of test_torch_e2e.py's chain: 12 raw reads of a
    420-bp genome with a planted site."""
    root = str(tmp_path_factory.mktemp("torch_bandwidths"))
    chrom, genome = make_genome(length=420, seed=3)
    fasta = os.path.join(root, "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    raw = os.path.join(root, "raw")
    make_raw_dataset(raw, chrom, genome, n_reads=12, seed=20, mod_pos=201,
                     mod_delta_pa=12.0, error_rate=0.02)
    return root, fasta, raw


@pytest.mark.parametrize("width", [130, 132, 1100, 2050])
def test_annotate_band_width_matches_jax(raw_reads, width):
    """Annotate at a band width off the grid of 32, with 2M+W off (130,
    2050: mode "codes") and on (132, 1100: "codes2") the grid of 4, and
    above 1024 (1100, 2050: K1's block of warps a read on the card),
    writes the JAX package's corrected FAST5s byte for byte."""
    root, fasta, raw = raw_reads
    dirs = {}
    for impl in ("jax", "torch"):
        dirs[impl] = os.path.join(root, f"{impl}_{width}")
        shutil.copytree(raw, dirs[impl])
    n_j, err_j = jax_annotate(jcfg.AnnotateConfig(
        wrk_base1=dirs["jax"], ref_fasta=fasta, band_width=width))
    n_t, err_t = torch_annotate(tcfg.AnnotateConfig(
        wrk_base1=dirs["torch"], ref_fasta=fasta, band_width=width),
        device="cpu")
    assert n_j >= 10 and n_t == n_j, (err_j, err_t)
    for name in sorted(os.listdir(raw)):
        with open(os.path.join(dirs["jax"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(dirs["torch"], name), "rb") as f:
            got = f.read()
        assert got == want, f"{name} differs at band_width={width}"


@pytest.mark.parametrize("m,w,sub,want", [
    (1024, 128, 256, 256), (4096, 2048, 256, 256), (4096, 4096, 256, 256),
    (4096, 4100, 256, 128), (8192, 8192, 256, 64), (16384, 32768, 256, 8),
    (256, 32768, 8, 8)])
def test_dp_sub_batch_fits_the_traceback_budget(m, w, sub, want):
    """The DP sub-batch stays dp_batch_size until its [B, M, tb_pitch(W)]
    traceback would pass TB_BUDGET; then it halves until it fits."""
    from nanomod_tpu_torch.resquiggle.banded_kernel import tb_pitch
    from nanomod_tpu_torch.resquiggle.pipeline import TB_BUDGET, _fit_batch
    got = _fit_batch(sub, m, w)
    assert got == want
    assert got * m * tb_pitch(w) <= TB_BUDGET or got == 1

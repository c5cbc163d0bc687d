"""The capped detect on chip_smoke.py's data, JAX package against the port.

chip_smoke.py phase 5 runs ``cli detect --coverages 200-200`` on the
committed smoke groups (16 reads a group, each copied 64 times, so an
interior position holds 512 observations a strand and group) and requires
a fixed site first.  Here both packages' detect CLIs run on the CPU on the
same corrected data at two caps: their sign-test and meanstd tables must be
byte-equal and their first site the one named below.  At a cap of 100 the
genome's end (one case read against two or three control reads, D = 1
across the neighbor window) outranks the planted site (spel 501); at 200
the planted site's minus strand is first.
"""

import os
import shutil

import pytest

from nanomod_tpu import cli as jax_cli
from nanomod_tpu_torch import cli as torch_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
COPIES = 64
RANK1 = {100: "spel + 981 A", 200: "spel - 501 T"}


@pytest.fixture(scope="module")
def smoke_groups(tmp_path_factory):
    """Both smoke groups corrected by the port on the CPU, each corrected
    file copied COPIES times as chip_smoke.py copies the raw ones."""
    root = tmp_path_factory.mktemp("capped_smoke")
    groups = {}
    for group in ("ctrl", "case"):
        one = root / f"one_{group}"
        one.mkdir()
        for name in sorted(os.listdir(os.path.join(DATA, group))):
            shutil.copyfile(os.path.join(DATA, group, name), one / name)
        torch_cli.main(["Annotate", "--wrkBase1", str(one), "--Ref",
                        os.path.join(DATA, "ref.fa"), "--device", "cpu"])
        big = root / group
        big.mkdir()
        for name in sorted(os.listdir(one)):
            if name.endswith(".fast5"):
                for k in range(COPIES):
                    shutil.copyfile(one / name,
                                    big / f"{name[:-6]}_{k:02d}.fast5")
        groups[group] = str(big)
    return root, groups


@pytest.mark.parametrize("cov", sorted(RANK1))
def test_capped_smoke_rank1_matches_jax(smoke_groups, cov, capsys):
    root, groups = smoke_groups
    args = ["detect", "--wrkBase1", groups["ctrl"], "--wrkBase2",
            groups["case"], "--min_lr", "0", "--coverages", f"{cov}-{cov}",
            "--downsampling", "100", "--mstd", "1"]
    rank1 = {}
    tables = {}
    for impl, main, extra in (("jax", jax_cli.main, ["--tile_positions", "64"]),
                              ("torch", torch_cli.main, ["--device", "cpu"])):
        out = str(root / f"out_{impl}_{cov}")
        capsys.readouterr()
        main(args + ["--outFolder", out] + extra)
        printed = capsys.readouterr().out
        rank1[impl] = printed.split("Rank 1:")[1].split("\n")[0].strip()
        tables[impl] = []
        for name in ("mod_sign_test.txt", "mod_meanstd.cvs"):
            with open(os.path.join(out, name), "rb") as f:
                tables[impl].append(f.read())
    assert len(tables["jax"][0].splitlines()) > 1000
    assert tables["torch"] == tables["jax"]
    assert rank1 == {"jax": RANK1[cov], "torch": RANK1[cov]}

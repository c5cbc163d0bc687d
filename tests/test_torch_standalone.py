"""The port stands alone: it holds its own copies of the reference modules
it needs (config, io, signal, accum.pools, utils.observe, the native C++
sources and their binds), and those copies must not drift from the
reference.  Each copy is held to its source here on seeded inputs, and the
port's native loader builds only into nanomod_tpu_torch/_build/."""

import dataclasses
import filecmp
import os
import subprocess
import types

import numpy as np
import pytest

from nanomod_tpu import config as jcfg
from nanomod_tpu.accum import pools as jpools
from nanomod_tpu.io.fasta import FastaIndex as JaxFastaIndex
from nanomod_tpu.io.fasta import revcomp as jax_revcomp
from nanomod_tpu.signal import events as jevents
from nanomod_tpu.signal import normalize as jnorm
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.accum import pools as tpools
from nanomod_tpu_torch.io.fasta import FastaIndex, revcomp
from nanomod_tpu_torch.native import build as native
from nanomod_tpu_torch.signal import events as tevents
from nanomod_tpu_torch.signal import normalize as tnorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(ROOT, "nanomod_tpu", "native")
PORT_NATIVE = os.path.join(ROOT, "nanomod_tpu_torch", "native")
SOURCES = ("annotate_core", "fast5_ingest", "fast5_write", "format_core",
           "seed_core", "sort_core", "traceback")


@pytest.mark.parametrize("name", SOURCES)
def test_native_source_is_the_reference_byte_for_byte(name):
    port = os.path.join(PORT_NATIVE, f"{name}.cpp")
    assert native.source_path(name) == port
    assert filecmp.cmp(port, os.path.join(REF_NATIVE, f"{name}.cpp"),
                       shallow=False)


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        else:
            default = f.default_factory()
        if dataclasses.is_dataclass(default):
            default = dataclasses.asdict(default)
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["StatConfig", "RankConfig", "DetectConfig",
                                  "AnnotateConfig", "SimulateConfig"])
def test_config_fields_and_defaults(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))
    for level in ("OUTPUT_DEBUG", "OUTPUT_INFO", "OUTPUT_WARNING",
                  "OUTPUT_ERROR"):
        assert getattr(tcfg, level) == getattr(jcfg, level)


def _reads(rng, n):
    for _ in range(n):
        chrom = ("chr1", "chr2")[int(rng.integers(0, 2))]
        strand = "+-"[int(rng.integers(0, 2))]
        length = int(rng.integers(20, 80))
        start = int(rng.integers(0, 300))
        vals = np.round(rng.normal(0, 1, length), 3).astype(np.float32)
        bases = rng.choice(np.array(list("ACGT"), dtype="S1"), length)
        yield chrom, strand, start, vals, bases


def _pools(mod, seed):
    rng = np.random.default_rng(seed)
    b = mod.PoolBuilder()
    for chrom, strand, start, vals, bases in _reads(rng, 60):
        b.add_read(chrom, strand, start, vals, bases)
    return b.finalize()


def test_pool_builder_and_join_match_the_reference():
    want = [_pools(jpools, s) for s in (1, 2)]
    got = [_pools(tpools, s) for s in (1, 2)]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            for f in ("positions", "values", "counts", "base"):
                np.testing.assert_array_equal(getattr(g[key], f),
                                              getattr(w[key], f), err_msg=f)
    jj = list(jpools.join_pools(*want))
    tj = list(tpools.join_pools(*got))
    assert [k for k, *_ in tj] == [k for k, *_ in jj] and jj
    for (_, *a), (_, *b) in zip(tj, jj):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


A2_DTYPE = np.dtype([("mean", "<f8"), ("stdv", "<f8"), ("start", "<u8"),
                     ("length", "<u8"), ("model_state", "S5"),
                     ("move", "<i4")])


def _raw_reads(seed):
    """An albacore-2 and a guppy read made from a seed."""
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), 60))
    ev = np.zeros(len(seq) + 6, dtype=A2_DTYPE)
    ev["move"] = rng.integers(0, 2, len(ev))
    ev["move"][0] = 0
    ev["length"] = rng.integers(4, 20, len(ev))
    ev["start"] = np.concatenate([[0], np.cumsum(ev["length"][:-1])])
    ev["mean"] = rng.normal(90, 10, len(ev))
    ctx = "NN" + seq + "NNNNNNNN"
    for i in range(len(ev)):
        ev["model_state"][i] = ctx[i: i + 5].encode()
    a2 = types.SimpleNamespace(basecaller="albacore2", events=ev)
    move = np.zeros(400, np.int8)
    move[rng.choice(400, 50, replace=False)] = 1
    move[0] = 1
    raw = rng.normal(100, 12, 1200)
    guppy = types.SimpleNamespace(
        basecaller="guppy", move=move, fastq_seq=seq, raw_signal=raw,
        first_sample_template=int(rng.integers(0, 10)))
    return [a2, guppy], raw


@pytest.mark.parametrize("seed", [3, 4])
def test_extract_events_and_mad_normalize_match_the_reference(seed):
    reads, raw = _raw_reads(seed)
    for rd in reads:
        a = tevents.extract_events(rd)
        b = jevents.extract_events(rd)
        assert a.seq == b.seq and len(a.seq) > 10
        for f in ("mean", "start", "length"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for shift_scale in (None, (3.5, 1.25)):
        np.testing.assert_array_equal(
            tnorm.mad_normalize(raw, (40, 1100), shift_scale),
            jnorm.mad_normalize(raw, (40, 1100), shift_scale))


def test_fasta_index_matches_the_reference(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "ref.fa"
    seqs = {f"c{i}": "".join(rng.choice(list("ACGTNacgt"), 150 + 37 * i))
            for i in range(3)}
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name} description\n")
            for lo in range(0, len(s), 60):
                f.write(s[lo: lo + 60] + "\n")
    got, want = FastaIndex(str(path)), JaxFastaIndex(str(path))
    assert list(got.names()) == list(want.names()) == list(seqs)
    for name in seqs:
        assert got.get(name) == want.get(name)
        np.testing.assert_array_equal(got.get_bytes(name),
                                      want.get_bytes(name))
        assert revcomp(got.get(name)) == jax_revcomp(want.get(name))
    assert ("c1" in got) and ("c9" not in got)


def _snapshot(d):
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns
            for n in os.listdir(d) if n.endswith(".cpp")}


def test_loader_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """The default library path is nanomod_tpu_torch/_build/; a build
    compiles the port's own source and writes nothing into the reference's
    native folder."""
    build_dir = os.path.join(ROOT, "nanomod_tpu_torch", "_build")
    assert native.BUILD_DIR == build_dir
    assert native.lib_path("traceback") == os.path.join(build_dir,
                                                         "libtraceback.so")
    lib = native.load_native("traceback")
    assert lib is not None and lib._name == native.lib_path("traceback")
    cmds = []
    run = subprocess.run

    def spy(cmd, **kw):
        cmds.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    before = _snapshot(REF_NATIVE)
    out = native.build("traceback", build_dir=str(tmp_path))
    assert out == os.path.join(str(tmp_path), "libtraceback.so")
    assert len(cmds) == 1
    cmd = cmds[0]
    assert cmd[cmd.index("-o") + 1].startswith(str(tmp_path))
    assert native.source_path("traceback") in cmd
    assert not any(REF_NATIVE in a for a in cmd)
    assert _snapshot(REF_NATIVE) == before

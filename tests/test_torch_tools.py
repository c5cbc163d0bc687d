"""The port's scale tools (nanomod_tpu_torch/tools/) against the JAX
package's tools/ at tiny sizes, on the CPU.

Each port tool must draw the reference tool's genome, planted sites and
reads (same seeds, same order); the seeds' genome digests must be those
of tools/scale_manifest.json; the native raw writer's files must read back
through h5py as the reference's h5py-written ones do; a tiny full chain
(raw FAST5 -> Annotate -> detect) must give the JAX pipeline's sign-test
table byte for byte; and scale_sharded's two CPU ranks must give equal
union and sharded tables.  The sizes are set on the tools' module
constants (the environment variables they read at import).
"""

import hashlib
import json
import os

import h5py
import numpy as np
import pytest

from tools import scale_fullchain as jfc
from test_torch_refnative import ALL_LIBS, require_reference_native
from tools import scale_quality as jsq
from nanomod_tpu_torch.tools import scale_fullchain as tfc
from nanomod_tpu_torch.tools import scale_quality as tsq
from nanomod_tpu_torch.tools import scale_run as tsr
from nanomod_tpu_torch.tools import scale_sharded as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "tools", "scale_manifest.json")
# tiny: reads of 1,000 bases over 5,000 (full chain) or 6,000 bases
FC_SIZES = dict(GENOME_LEN=5_000, N_READS=30, READ_LEN=1_000)
SQ_SIZES = dict(GENOME_LEN=6_000, N_READS=24, READ_LEN=600)


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


def _read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _h5_dump(path):
    """Every group's attributes and every dataset (dtype, shape, values)
    as h5py reads them back, with the attributes' stored types."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: (np.asarray(v).tolist()
                         if not isinstance(v, (str, bytes)) else v,
                         str(obj.attrs.get_id(k).dtype))
                     for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                val = obj[()]
                out[name] = (str(obj.dtype), obj.shape,
                             val.tobytes() if isinstance(val, np.ndarray)
                             else val, attrs,
                             h5py.check_string_dtype(obj.dtype))
            else:
                out[name] = attrs
        f.visititems(visit)
    return out


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, n), folder)
                  for d, _, names in os.walk(folder) for n in names)


def _set(monkeypatch, module, sizes):
    for k, v in sizes.items():
        monkeypatch.setattr(module, k, v)


def test_manifest_genomes_and_sites():
    """The port's generator gives tools/scale_manifest.json's genome digest
    and planted sites for seeds 0, 1 and 2 at the manifest's size."""
    with open(MANIFEST) as f:
        ref = json.load(f)
    for seed in (0, 1, 2):
        g, _, planted = tsr.genome(seed, ref["genome_len"], ref["n_sites"])
        entry = ref["seeds"][str(seed)]
        assert hashlib.sha256(g.tobytes()).hexdigest() == \
            entry["genome_sha256"]
        assert planted == entry["planted"]


def test_scale_quality_reads_equal_jax(tmp_path, monkeypatch):
    """scale_quality's (and so scale_run's) genome, planted sites and every
    corrected read equal the JAX tool's at a tiny size."""
    _set(monkeypatch, jsq, SQ_SIZES)
    _set(monkeypatch, tsq, SQ_SIZES)
    want = jsq.dataset_for_seed(str(tmp_path / "jax"), 1)
    got = tsq.dataset_for_seed(str(tmp_path / "port"), 1)
    assert got[2] == [int(p) for p in want[2]] and got[3] == want[3]
    for w_dir, g_dir in zip(want[:2], got[:2]):
        names = _files(w_dir)
        assert names == _files(g_dir) and len(names) == SQ_SIZES["N_READS"]
        for n in names:
            w = _h5_dump(os.path.join(w_dir, n))
            g = _h5_dump(os.path.join(g_dir, n))
            corrected = [k for k in w if "NanomoCorrected_000" in k]
            assert corrected and all(g[k] == w[k] for k in corrected), n


@pytest.fixture(scope="module")
def fullchain(tmp_path_factory):
    """A tiny full chain: the JAX tool's raw groups (h5py) annotated and
    detected by the JAX package, and the port tool's main on the CPU."""
    mp = pytest.MonkeyPatch()
    _set(mp, jfc, FC_SIZES)
    _set(mp, tfc, FC_SIZES)
    root = tmp_path_factory.mktemp("fullchain")
    jroot, troot = str(root / "jax"), str(root / "port")
    try:
        # the draws of the JAX tool's main, in its order
        rng = np.random.default_rng(0)
        genome_u8 = rng.choice(jfc.BASES_U8, jfc.GENOME_LEN)
        comp_u8 = np.frombuffer(b"TGCA", np.uint8)[
            np.searchsorted(jfc.BASES_U8, genome_u8)]
        lvl_tbl = np.clip(rng.normal(100.0, 15.0, 1024), 55, 145)
        planted = sorted(int(p) for p in rng.choice(
            jfc.GENOME_LEN - 100, jfc.N_SITES, replace=False) + 50)
        ctrl, case = os.path.join(jroot, "ctrl"), os.path.join(jroot, "case")
        jfc.gen_raw_group(ctrl, genome_u8, comp_u8, lvl_tbl,
                          np.random.default_rng(1))
        jfc.gen_raw_group(case, genome_u8, comp_u8, lvl_tbl,
                          np.random.default_rng(2), planted=planted)
        raw = {n: _h5_dump(os.path.join(ctrl, n)) for n in _files(ctrl)}
        fasta_p = os.path.join(jroot, "ref.fa")
        with open(fasta_p, "w") as f:
            f.write(f">{jfc.CHROM}\n")
            g = genome_u8.tobytes().decode()
            for lo in range(0, jfc.GENOME_LEN, 80):
                f.write(g[lo: lo + 80] + "\n")

        from nanomod_tpu.config import (AnnotateConfig, DetectConfig,
                                        RankConfig)
        from nanomod_tpu.detect import run_detect
        from nanomod_tpu.io.fast5 import iter_fast5_files
        from nanomod_tpu.io.fasta import FastaIndex
        from nanomod_tpu.resquiggle import annotate_files
        from nanomod_tpu.resquiggle.seed import SeedIndex
        fasta = FastaIndex(fasta_p)
        acfg = AnnotateConfig(wrk_base1=ctrl, ref_fasta=fasta_p, out_level=2)
        sidx = SeedIndex(fasta.seqs, k=acfg.seed_k)
        for folder in (ctrl, case):
            annotate_files(list(iter_fast5_files(folder, recursive=True)),
                           acfg, fasta, sidx)
        run_detect(DetectConfig(
            wrk_base1=ctrl, wrk_base2=case,
            out_folder=os.path.join(jroot, "out"), file_id="fullchain",
            min_lr=500, rank=RankConfig(window=10), out_level=2))

        port_genome = tfc.genome()
        tfc.make_dataset(troot)
        port_raw = {n: _h5_dump(os.path.join(troot, "ctrl", n))
                    for n in _files(os.path.join(troot, "ctrl"))}
        summary = tfc.main([troot, "--device", "cpu"])
        yield dict(jroot=jroot, troot=troot, raw=raw, port_raw=port_raw,
                   summary=summary, genome=genome_u8, planted=planted,
                   port_genome=port_genome)
    finally:
        mp.undo()


def test_fullchain_genome_and_raw_files_equal_jax(fullchain):
    """The port's genome and planted sites are the JAX tool's, and its raw
    files, written by the native writer, read back through h5py with the
    JAX tool's h5py-written datasets and attributes."""
    g, _, _, planted = fullchain["port_genome"]
    assert np.array_equal(g, fullchain["genome"])
    assert planted == fullchain["planted"]
    assert _read_bytes(os.path.join(fullchain["jroot"], "ref.fa")) == \
        _read_bytes(os.path.join(fullchain["troot"], "ref.fa"))
    assert fullchain["raw"].keys() == fullchain["port_raw"].keys()
    assert len(fullchain["raw"]) > 0
    for name, want in fullchain["raw"].items():
        assert fullchain["port_raw"][name] == want, name


def test_fullchain_sign_test_equals_jax(fullchain):
    """Annotate then detect of the port's raw files on the CPU gives the
    JAX pipeline's _sign_test.txt on its h5py-written files, and the port
    annotated every read the JAX package did."""
    want = _read_bytes(os.path.join(fullchain["jroot"], "out",
                                    "fullchain_sign_test.txt"))
    got = _read_bytes(os.path.join(fullchain["troot"], "out",
                                   "fullchain_sign_test.txt"))
    assert len(want.splitlines()) > 100
    assert got == want
    s = fullchain["summary"]
    assert s["annotate_ctrl"]["annotated"] > 0.8 * FC_SIZES["N_READS"]
    assert s["detect"]["positions_tested"] == len(want.splitlines())


def test_scale_quality_main_writes_under_its_root(tmp_path, monkeypatch):
    """scale_quality on the CPU: four modes a seed, its manifest and
    summary under its own root, the reference's manifest left as it was
    (not compared at this size)."""
    _set(monkeypatch, tsq, SQ_SIZES)
    before = _read_bytes(MANIFEST)
    res = tsq.main([str(tmp_path), "3", "--device", "cpu"])
    assert _read_bytes(MANIFEST) == before
    assert set(res[3]) == {"stouffer", "fisher", "capped", "region"}
    assert res[3]["capped"]["kernel_launches"] is not None
    with open(tmp_path / "scale_manifest.json") as f:
        own = json.load(f)
    assert own["seeds"]["3"]["matches_reference_manifest"] is False
    assert (tmp_path / "quality_summary.json").exists()


def test_scale_quality_refuses_a_manifest_mismatch(tmp_path, monkeypatch):
    """At the manifest's size a seed whose digest differs fails."""
    with open(MANIFEST) as f:
        ref = json.load(f)
    monkeypatch.setattr(tsq, "GENOME_LEN", ref["genome_len"])
    entry = ref["seeds"]["0"]
    assert tsq.check_manifest(0, entry["genome_sha256"], entry["planted"])
    with pytest.raises(AssertionError, match="differ"):
        tsq.check_manifest(0, "0" * 64, entry["planted"])
    with pytest.raises(AssertionError, match="differ"):
        tsq.check_manifest(0, entry["genome_sha256"],
                           entry["planted"][::-1])


def test_scale_run_main_on_cpu(tmp_path, monkeypatch):
    """scale_run end to end on the CPU at a tiny size: its summary, and
    the same table as the JAX tool's detect on the JAX tool's reads."""
    from tools import scale_run as jsr
    sizes = dict(GENOME_LEN=6_000, N_READS=150, READ_LEN=600)
    _set(monkeypatch, tsr, sizes)
    _set(monkeypatch, jsr, sizes)
    s = tsr.main([str(tmp_path / "port"), "--device", "cpu"])
    assert s["positions_tested"] > 1000 and "ingest" in s["stages_s"]

    from nanomod_tpu.config import DetectConfig, RankConfig
    from nanomod_tpu.detect import run_detect
    genome_arr, levels, planted = tsr.genome(0)
    jroot = tmp_path / "jax"
    jsr.gen_group(str(jroot / "ctrl"), genome_arr, levels,
                  np.random.default_rng(1))
    jsr.gen_group(str(jroot / "case"), genome_arr, levels,
                  np.random.default_rng(2), planted=planted)
    run_detect(DetectConfig(
        wrk_base1=str(jroot / "ctrl"), wrk_base2=str(jroot / "case"),
        out_folder=str(jroot / "out"), file_id="scale", min_lr=0,
        rank=RankConfig(window=10), out_level=1))
    assert _read_bytes(tmp_path / "port" / "out" / "scale_sign_test.txt") \
        == _read_bytes(jroot / "out" / "scale_sign_test.txt")


def test_scale_sharded_cpu_ranks_equal(tmp_path, monkeypatch):
    """Two gloo ranks on the CPU (torch.distributed.run): the union and
    sharded tables byte-equal, the sharded exchange's routed bytes
    recorded a rank."""
    _set(monkeypatch, tss, dict(GENOME_LEN=6_000, N_READS=150,
                                READ_LEN=600))
    s = tss.main([str(tmp_path), "--device", "cpu"])
    assert s["identical"] and s["table_bytes"] > 100_000
    sharded = [r for r in s["results"] if r["mode"] == "sharded"][0]
    assert all(b is not None and b > 0 for b in sharded["dcn_payload_bytes"])
    assert all(x is not None for x in sharded["rss_gb"])


@pytest.mark.parametrize("what", ["no_folder", "empty_signal"])
def test_raw_writer_raises(tmp_path, what):
    """A raw file the native writer cannot write raises: no h5py path."""
    from nanomod_tpu_torch.native.fast5_rawwrite_bind import (
        ALBACORE2_EVENT_DTYPE, write_raw_batch)
    read = dict(read_number=1, read_id="read-000001",
                signal=np.arange(100, dtype=np.int16),
                events=np.zeros(10, ALBACORE2_EVENT_DTYPE),
                fastq=b"@read-000001\nACGT\n+\n!!!!\n",
                channel=(8192.0, 10.0, 1400.0, 4000.0))
    path = str(tmp_path / "r.fast5")
    if what == "no_folder":
        path = str(tmp_path / "missing" / "r.fast5")
    else:
        read["signal"] = np.zeros(0, np.int16)
    with pytest.raises(RuntimeError, match="raw FAST5 writer failed"):
        write_raw_batch([path], [read])

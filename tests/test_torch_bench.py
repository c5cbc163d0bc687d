"""The port's bench (nanomod_tpu_torch.bench) and its fixtures
(nanomod_tpu_torch/tools/fixtures.py) against the repository's bench.py
and tests/fixtures.py, on the CPU at small sizes.

The fixtures must write, without h5py, files whose datasets and
attributes (read back with h5py) equal the reference fixtures' for the
same seeds.  The bench's Annotate and e2e parts, at sizes set through the
bench's own environment variables, must annotate as many reads as
bench.py's and give its table length and top site; the JSON line must
carry bench.py's keys plus "device".  bench.py is imported by path and
left as it is.
"""

import importlib.util
import json
import os

import h5py
import numpy as np
import pytest
import torch

import fixtures as jfix
from test_torch_refnative import ALL_LIBS, require_reference_native
from nanomod_tpu_torch import bench as tbench
from nanomod_tpu_torch.tools import fixtures as tfix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {"BENCH_POSITIONS": "3000", "BENCH_READS": "12",
         "BENCH_READ_LEN": "400", "BENCH_E2E_GENOME": "600",
         "BENCH_E2E_READS": "16", "BENCH_ANNOTATE_REPEAT": "1",
         "BENCH_E2E_REPEAT": "1"}


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump(path):
    """Every group's and dataset's attributes, and every dataset's dtype,
    shape and bytes, as h5py reads them."""
    out = {}

    def visit(name, obj):
        attrs = {k: obj.attrs[k] for k in obj.attrs}
        attrs = {k: v.tolist() if hasattr(v, "tolist") else v
                 for k, v in attrs.items()}
        if isinstance(obj, h5py.Dataset):
            data = obj[()]
            out[name] = (attrs, obj.dtype.descr if obj.dtype.names
                         else obj.dtype.str, obj.shape,
                         data.tobytes() if hasattr(data, "tobytes")
                         else data)
        else:
            out[name] = (attrs,)
    with h5py.File(path, "r") as f:
        f.visititems(visit)
        out["/"] = ({k: f.attrs[k] for k in f.attrs},)
    return out


def _assert_same_tree(want_dir, got_dir):
    n = 0
    for dirpath, _, files in os.walk(want_dir):
        for name in files:
            want = os.path.join(dirpath, name)
            got = os.path.join(got_dir, os.path.relpath(want, want_dir))
            a, b = _dump(want), _dump(got)
            assert a.keys() == b.keys(), (name, a.keys() ^ b.keys())
            for key in a:
                assert a[key] == b[key], (name, key)
            n += 1
    assert n and n == sum(len(f) for _, _, f in os.walk(got_dir))


def test_make_genome_matches():
    for length, seed in ((400, 7), (2500, 1), (4000, 11)):
        assert tfix.make_genome(length, seed) == jfix.make_genome(length,
                                                                  seed)


@pytest.mark.parametrize("kw", [
    dict(n_reads=6, seed=2, read_len=300, error_rate=0.03),
    dict(n_reads=5, seed=6, read_len=None, error_rate=0.0,
         mod_pos=120, mod_delta_pa=12.0),
])
def test_raw_fixture_files_match(tmp_path, kw):
    """Raw FAST5s: signal, albacore2 events, Fastq, the channel's
    calibration and number, start_time and read_id."""
    chrom, genome = jfix.make_genome(length=500, seed=1)
    jfix.make_raw_dataset(str(tmp_path / "jax"), chrom, genome, **kw)
    tfix.make_raw_dataset(str(tmp_path / "torch"), chrom, genome, **kw)
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.mark.parametrize("kw", [
    dict(n_reads=6, seed=1),
    dict(n_reads=7, seed=2, mod_pos=200, mod_delta=1.5, read_len=250,
         n_subfolders=3),
])
def test_corrected_fixture_files_match(tmp_path, kw):
    """Corrected FAST5s: the NanomoCorrected_000 group written into a file
    that held only its root group."""
    chrom, genome = jfix.make_genome(length=600, seed=11)
    jfix.make_corrected_dataset(str(tmp_path / "jax"), chrom, genome, **kw)
    tfix.make_corrected_dataset(str(tmp_path / "torch"), chrom, genome, **kw)
    _assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))


@pytest.fixture(scope="module")
def parts():
    """bench.py's and the port's Annotate and e2e parts at SMALL sizes;
    bench.py's read count and table length caught from the functions it
    calls."""
    import nanomod_tpu.detect
    import nanomod_tpu.resquiggle
    jb = _jax_bench()
    seen = {}
    j_annotate = nanomod_tpu.resquiggle.annotate_files
    j_detect = nanomod_tpu.detect.run_detect

    def annotate_files(*a, **k):
        out = j_annotate(*a, **k)
        seen["n_ok"] = out[0]
        return out

    def run_detect(*a, **k):
        out = j_detect(*a, **k)
        seen["positions"] = len(out[0])
        return out
    with pytest.MonkeyPatch.context() as mp:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        mp.setattr(nanomod_tpu.resquiggle, "annotate_files", annotate_files)
        mp.setattr(nanomod_tpu.detect, "run_detect", run_detect)
        jax_parts = {"secondary": jb.bench_annotate(),
                     "e2e": jb.bench_e2e_detect()}
        dev = torch.device("cpu")
        port_parts = {"secondary": tbench.bench_annotate(dev),
                      "e2e": tbench.bench_e2e_detect(dev)}
    return jb, jax_parts, port_parts, seen


def test_bench_annotate_matches_jax(parts):
    _, jax_parts, port_parts, seen = parts
    got, want = port_parts["secondary"], jax_parts["secondary"]
    assert got["n_ok"] == seen["n_ok"] == int(SMALL["BENCH_READS"])
    assert set(got) == set(want) | {"n_ok"}
    assert set(got["dispersion"]) == set(want["dispersion"])
    assert {"prepare", "align_dp", "annotate", "write"} <= \
        set(got["stage_seconds"])


def test_bench_e2e_matches_jax(parts):
    _, jax_parts, port_parts, seen = parts
    got, want = port_parts["e2e"], jax_parts["e2e"]
    assert got["positions"] == seen["positions"] > 0
    assert got["top_site_pos"] == want["top_site_pos"] == \
        int(SMALL["BENCH_E2E_GENOME"]) // 3
    assert set(got) == set(want) | {"positions"}


def test_bench_line_has_the_reference_keys(parts, monkeypatch, capsys):
    """``python -m nanomod_tpu_torch.bench --device cpu``'s one JSON line
    against bench.py's main (both with the Annotate and e2e parts taken
    from the runs above): bench.py's keys plus "device"."""
    jb, jax_parts, port_parts, _ = parts
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(jb, "bench_annotate", lambda: jax_parts["secondary"])
    monkeypatch.setattr(jb, "bench_e2e_detect", lambda: jax_parts["e2e"])
    jb.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(tbench, "bench_annotate",
                        lambda dev: port_parts["secondary"])
    monkeypatch.setattr(tbench, "bench_e2e_detect",
                        lambda dev: port_parts["e2e"])
    line = tbench.main(["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == line
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key in ("split", "dispersion"):
        assert set(got[key]) == set(want[key])
    assert got["split"]["backend"] == "device"
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert got["value"] > 0 and np.isfinite(got["vs_baseline"])


def test_bench_never_falls_back_to_the_cpu():
    """Without a card, ``--device cuda`` raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        tbench.main(["--device", "cuda"])

"""The port's multi-device paths against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's mesh is a list of 8 CPU devices (``make_mesh(8, devices=["cpu"] *
8)``, or ``mesh.DEVICES`` for detect), so every shard runs the kernels'
plain versions.
Inputs are made with numpy from a seed and handed to both:

  * K7's plain version (the neighbor stencil with its halo; the whole
    step, the CUDA path's twin) against ``_stencil_fn``: k in {0, 1, 2,
    5}, cov 0 and > 0, a join boundary, padding, valid columns at both
    mesh edges and shards of 4 columns with k up to 4; array-equal;
  * K9's plain version against ``_accumulate`` on uniform and read-major
    draws with negative and out-of-range positions;
  * ``sharded_join_battery``: every float64 column equal;
  * ``detect`` with 8 shards: the ``_sign_test.txt`` / ``_meanstd.cvs``
    byte-equal to the JAX package's ``--n_devices 8`` files;
  * ``distributed_detect_step`` and ``pooled_rank_components`` at the
    reference's tolerances (tests/test_parallel.py);
  * the multi-process merges (shard_list, merge_pools_across_hosts,
    merge_annotate_stats) under thread-fake gathers, equal to the JAX
    package's under the same fakes;
  * ``detect_from_pools(row_offsets=...)``: a mid-join row offset draws the
    capped KS subsamples the JAX package draws.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from fixtures import make_corrected_dataset, make_genome
from test_torch_refnative import ALL_LIBS, require_reference_native
from nanomod_tpu import config as jcfg
from nanomod_tpu.accum.pools import PoolBuilder as JaxPoolBuilder
from nanomod_tpu.parallel import dist as jdist
from nanomod_tpu.parallel.mesh import distributed_detect_step as jax_step
from nanomod_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nanomod_tpu.parallel.sharded import _stencil_fn
from nanomod_tpu.parallel.sharded import sharded_join_battery as jax_sjb
from nanomod_tpu.stats.kernels import (
    pooled_rank_components as jax_pooled_rank_components)
from nanomod_tpu_torch import config as tcfg
from nanomod_tpu_torch.accum.pools import PoolBuilder
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.kernels import hardcases
from nanomod_tpu_torch.parallel import dist, mesh, sharded
from nanomod_tpu_torch.stats import kernels

NSH = 8


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The JAX package's native libraries loaded, so that its paths
    here never take their Python fallback (test_torch_refnative.py)."""
    require_reference_native(*ALL_LIBS)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= NSH, "conftest must provide 8 CPU devices"
    return jax_make_mesh(NSH, data=2)


@pytest.fixture(scope="module")
def tmesh():
    return mesh.make_mesh(NSH, devices=["cpu"] * NSH)


@pytest.fixture
def cpu_shards(monkeypatch):
    """make_mesh's default devices: 8 CPU shards, as the JAX side's 8
    virtual CPU devices."""
    monkeypatch.setattr(mesh, "DEVICES", ["cpu"] * NSH)


def test_mesh_shape(tmesh, jmesh):
    assert tmesh.shape == dict(jmesh.shape) == {"data": 2, "pos": 4}
    assert mesh.make_mesh(6, devices=["cpu"] * 6).shape == {"data": 2,
                                                            "pos": 3}
    assert mesh.make_mesh(3, devices=["cpu"] * 3).shape == {"data": 1,
                                                            "pos": 3}


def test_make_mesh_raises_without_enough_cuda_devices():
    want = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="CUDA device"):
        mesh.make_mesh(want)


def test_make_mesh_takes_the_default_device_list(cpu_shards):
    m = mesh.make_mesh(4)
    assert m.devices == [torch.device("cpu")] * 4
    assert m.shape == {"data": 2, "pos": 2}
    with pytest.raises(ValueError, match="CUDA device"):
        mesh.make_mesh(NSH + 1)


# ---------------------------------------------------------------------------
# K7: the neighbor stencil
# ---------------------------------------------------------------------------

def _stencil_inputs(rng, p, cov):
    hi = 2 * cov if cov else 60
    num = rng.integers(0, 5000, p).astype(np.int32)
    cap = rng.integers(0, 5000, p).astype(np.int32)
    n1c = rng.integers(1, hi + 1, p).astype(np.int32)
    n2c = rng.integers(1, hi + 1, p).astype(np.int32)
    # two joins: a run with gaps, then positions starting again (a join
    # boundary inside a shard), then padding
    n_valid = p - 11
    first = np.cumsum(rng.integers(1, 3, 53))
    second = 7 + np.cumsum(rng.integers(1, 3, n_valid - 53))
    pos = np.full(p, -(2 ** 30), np.int32)
    pos[:n_valid] = np.concatenate([first, second])
    valid = np.zeros(p, bool)
    valid[:n_valid] = True
    return num, cap, n1c, n2c, pos, valid


@pytest.mark.parametrize("k", [0, 1, 2, 5])
@pytest.mark.parametrize("cov", [0, 30])
def test_stencil_plain_equals_jax(jmesh, k, cov):
    rng = np.random.default_rng(10 * k + cov)
    p = NSH * 16
    arrays = _stencil_inputs(rng, p, cov)
    want = [np.asarray(x) for x in _stencil_fn(jmesh, k, cov)(*arrays)]
    tensors = [torch.from_numpy(a) for a in arrays]
    shards = [tuple(t[s * 16:(s + 1) * 16] for t in tensors)
              for s in range(NSH)]
    got = sharded.sharded_stencil(shards, k, cov)
    for i, name in enumerate(("d", "ne1", "ne2", "ok")):
        cat = torch.cat([g[i] for g in got], dim=1).numpy()
        np.testing.assert_array_equal(cat, want[i], err_msg=name)
    assert want[3].any() and not want[3].all()


def _step_inputs(rng, p, cov):
    """Every column valid, a join boundary in the middle: the mesh's first
    and last shards hold real positions at its edges."""
    hi = 2 * cov if cov else 60
    num = rng.integers(0, 1 << 20, p).astype(np.int32)
    cap = rng.integers(0, 1 << 20, p).astype(np.int32)
    n1c = rng.integers(1, hi + 1, p).astype(np.int32)
    n2c = rng.integers(1, hi + 1, p).astype(np.int32)
    cut = p // 2 + 3
    pos = np.concatenate([np.cumsum(rng.integers(1, 3, cut)),
                          np.cumsum(rng.integers(1, 3, p - cut))])
    return num, cap, n1c, n2c, pos.astype(np.int32), np.ones(p, bool)


def _shards_of(arrays, nsh):
    length = len(arrays[0]) // nsh
    tensors = [torch.from_numpy(a) for a in arrays]
    return [tuple(t[s * length:(s + 1) * length] for t in tensors)
            for s in range(nsh)]


def _assert_step_equals_jax(got, want):
    for i, name in enumerate(("d", "ne1", "ne2", "ok")):
        cat = torch.cat([g[i] for g in got], dim=1).numpy()
        np.testing.assert_array_equal(cat, want[i], err_msg=name)


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("cov", [0, 200])
def test_sharded_stencil_plain_equals_jax(jmesh, k, cov):
    """The whole step's plain version (the CUDA path's twin: halo blocks,
    then each shard's stencil) on 8 CPU shards against _stencil_fn, with
    valid columns at both mesh edges: their missing neighbours are not
    ok."""
    rng = np.random.default_rng(1000 + 10 * k + cov)
    length = 24
    arrays = _step_inputs(rng, NSH * length, cov)
    want = [np.asarray(x) for x in _stencil_fn(jmesh, k, cov)(*arrays)]
    got = sharded.sharded_stencil_plain(_shards_of(arrays, NSH), k, cov)
    _assert_step_equals_jax(got, want)
    ok = want[3]
    assert not ok[:k, 0].any() and not ok[k + 1:, -1].any()
    assert ok[k - 1, 1:].any() and ok[k + 1, :-1].any()
    if cov:
        capped = (arrays[2] > cov) | (arrays[3] > cov)
        assert capped.any() and not capped.all()
        np.testing.assert_array_equal(want[0][k], np.where(
            capped, arrays[1], arrays[0]))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_stencil_short_shards_equal_jax(jmesh, k):
    """Shards of 4 columns with k >= L / 2 (k = L: the window reaches the
    far edge of each neighbour)."""
    rng = np.random.default_rng(2000 + k)
    arrays = _step_inputs(rng, NSH * 4, 30)
    want = [np.asarray(x) for x in _stencil_fn(jmesh, k, 30)(*arrays)]
    got = sharded.sharded_stencil(_shards_of(arrays, NSH), k, 30)
    _assert_step_equals_jax(got, want)


def test_stencil_window_wider_than_shard_raises():
    t = [torch.zeros(4, dtype=torch.int32)] * 5 + [torch.ones(4, dtype=bool)]
    with pytest.raises(ValueError, match="shard length"):
        sharded.sharded_stencil([tuple(t)] * 2, 5, 0)


# ---------------------------------------------------------------------------
# the sharded battery
# ---------------------------------------------------------------------------

def _join(rng, p, c1, c2):
    v1 = np.round(rng.normal(0, 1, (p, c1)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.2, 1, (p, c2)), 3).astype(np.float32)
    n1 = rng.integers(2, c1 + 1, p).astype(np.int32)
    n2 = rng.integers(2, c2 + 1, p).astype(np.int32)
    pos = np.cumsum(rng.integers(1, 3, p)).astype(np.int64) + 100
    return v1, n1, v2, n2, pos


@pytest.mark.parametrize("method,cov,offset", [
    ("stouffer", 0, 0), ("fisher", 12, 0), ("stouffer", 12, 1000),
    ("ks", 0, 0)])
def test_sharded_join_battery_equals_jax(jmesh, tmesh, method, cov, offset):
    rng = np.random.default_rng(len(method) + cov)
    v1, n1, v2, n2, pos = _join(rng, 203, 24, 20)
    kw = dict(test_method=method, coverages=(cov, cov), downsampling=10)
    want = jax_sjb(jmesh, v1, n1, v2, n2, pos, strand="+",
                   cfg=jcfg.StatConfig(**kw), want_mstd=True,
                   row_offset=offset)
    got = sharded.sharded_join_battery(
        tmesh, v1, n1, v2, n2, pos, strand="+", cfg=tcfg.StatConfig(**kw),
        want_mstd=True, row_offset=offset)
    for key in ("stu", "pu", "stt", "pt", "stks", "pks", "stcomb", "pcomb",
                "mstd"):
        a, b = getattr(got, key), getattr(want, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=key)


# ---------------------------------------------------------------------------
# detect with 8 shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corrected_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_shds"))
    chrom, genome = make_genome(length=400, seed=7)
    ctrl = os.path.join(root, "control")
    case = os.path.join(root, "case")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=24, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=24, seed=2,
                           mod_pos=173, mod_delta=1.0)
    return root, ctrl, case


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _both_detects(dataset, file_id, **kw):
    """The JAX package's --n_devices 8 detect and the port's on 8 CPU
    shards (the cpu_shards fixture): their output folders."""
    from nanomod_tpu.detect import run_detect as jax_run_detect
    from nanomod_tpu_torch.detect import run_detect

    root, ctrl, case = dataset
    outs = {}
    for impl, mod in (("jax", jcfg), ("torch", tcfg)):
        out = os.path.join(root, f"out_{impl}")
        cfg = mod.replace(mod.DetectConfig(
            wrk_base1=ctrl, wrk_base2=case, out_folder=out, file_id=file_id,
            min_lr=0, rank=mod.RankConfig(window=4), n_devices=NSH), **kw)
        if impl == "jax":
            jax_run_detect(cfg)
        else:
            kbuild.reset_launches()
            run_detect(cfg, device="cpu")
            assert sum(kbuild.launch_counts().values()) == 0
        outs[impl] = out
    return outs


@pytest.mark.parametrize("method", ["stouffer", "fisher", "ks"])
def test_sharded_detect_byte_equal_to_jax(corrected_dataset, cpu_shards,
                                          method):
    outs = _both_detects(corrected_dataset, f"sh_{method}",
                         **{"stats.test_method": method})
    name = f"sh_{method}_sign_test.txt"
    want = _read(os.path.join(outs["jax"], name))
    assert len(want) > 1000
    assert _read(os.path.join(outs["torch"], name)) == want


def test_sharded_detect_capped_mstd_byte_equal_to_jax(corrected_dataset,
                                                      cpu_shards):
    outs = _both_detects(corrected_dataset, "sh_cap",
                         **{"stats.coverages": (10, 10), "mstd": True})
    for suffix in ("_sign_test.txt", "_meanstd.cvs"):
        want = _read(os.path.join(outs["jax"], "sh_cap" + suffix))
        assert len(want) > 100
        assert _read(os.path.join(outs["torch"], "sh_cap" + suffix)) == want


def test_row_offsets_capped_ks_equals_jax(corrected_dataset):
    """detect_from_pools(row_offsets=...): a mid-join row offset gives the
    capped KS the JAX package gives with the same offset."""
    from nanomod_tpu.detect import detect_from_pools as jax_dfp
    from nanomod_tpu.detect import ingest_group as jax_ingest
    from nanomod_tpu_torch.detect import detect_from_pools, ingest_group

    _, ctrl, case = corrected_dataset
    kw = dict(wrk_base1=ctrl, wrk_base2=case, min_lr=0)
    stats = dict(coverages=(10, 10), downsampling=10)
    jc = jcfg.DetectConfig(stats=jcfg.StatConfig(**stats), **kw)
    tc = tcfg.DetectConfig(stats=tcfg.StatConfig(**stats), **kw)
    jp = [jax_ingest(d, jc) for d in (ctrl, case)]
    tp = [ingest_group(d, tc) for d in (ctrl, case)]
    offsets = {key: 37 + 5 * i for i, key in enumerate(sorted(tp[0]))}
    want, _ = jax_dfp(*jp, jc, row_offsets=offsets)
    got, _ = detect_from_pools(*tp, tc, device="cpu", row_offsets=offsets)
    base, _ = detect_from_pools(*tp, tc, device="cpu")
    np.testing.assert_array_equal(got.res.stks, want.res.stks)
    np.testing.assert_array_equal(got.res.pks, want.res.pks)
    assert not np.array_equal(got.res.pks, base.res.pks)


# ---------------------------------------------------------------------------
# the mesh demo step and the pooled rank components
# ---------------------------------------------------------------------------

def _pooled(p, n, seed=0):
    rng = np.random.default_rng(seed)
    z = np.where(rng.random((p, n)) < 0.8, rng.normal(0, 1, (p, n)), np.inf)
    z = np.sort(z, axis=1).astype(np.float32)
    lab = (rng.random((p, n)) < 0.5).astype(np.float32)
    lab[~np.isfinite(z)] = 0.0
    n1 = np.maximum((lab * np.isfinite(z)).sum(1), 1).astype(np.float32)
    n2 = np.maximum(((1 - lab) * np.isfinite(z)).sum(1), 1).astype(np.float32)
    return z, lab, n1, n2


def test_pooled_rank_components_plain_equals_jax():
    z, lab, n1, n2 = _pooled(64, 32)
    want = [np.asarray(x) for x in jax_pooled_rank_components(z, lab, n1,
                                                               n2)]
    got = kernels.pooled_rank_components(
        *(torch.from_numpy(x) for x in (z, lab, n1, n2)))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("case", hardcases.POOLED_CASES)
def test_pooled_rank_components_cases_equal_jax(case):
    """The pooled hard cases (kernels/hardcases.py: an empty group with n =
    max(count, 1), counts off the masks and 0, NaN and -inf in z, NaN
    labels, N = 1, 256, 257, P = 0): two_rank_sum and tie_sum
    array-equal, d bit-equal (NaN equal to NaN) to the JAX package, whose
    d is the exact f32 quotient f32(ks_num) / (n1 * n2) too."""
    arrays = hardcases.pooled_tile(case, seed=11)
    want = [np.asarray(x) for x in jax_pooled_rank_components(*arrays)]
    got = kernels.pooled_rank_components(
        *(torch.from_numpy(x) for x in arrays))
    torch.testing.assert_close(got[0], torch.from_numpy(want[0].copy()),
                               rtol=0, atol=0, equal_nan=True)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    if case == "empty_group1":
        # group 1 empty, n1 = 1: ks_num = n1 * (every group-2 value) = n2,
        # so d = n2 / (1 * n2) = 1 where group 2 has members
        z, lab, n1, n2 = arrays
        empty = ((z < np.inf) & (lab > 0.5)).sum(1) == 0
        assert (got[0].numpy()[empty & (n2 > 0)] == 1.0).all()
        assert empty.sum() >= 16


def test_distributed_detect_step_equals_jax(jmesh, tmesh):
    genome_len = 128
    rng = np.random.default_rng(1)
    read_pos = rng.integers(0, genome_len, (8, 32)).astype(np.int32)
    read_val = rng.normal(0, 1, (8, 32)).astype(np.float32)
    read_ok = rng.random((8, 32)) < 0.9
    pooled = _pooled(64, 32)
    want = [np.asarray(x) for x in jax_step(jmesh, genome_len, read_pos,
                                            read_val, read_ok, *pooled)]
    got = [t.numpy() for t in mesh.distributed_detect_step(
        tmesh, genome_len, read_pos, read_val, read_ok, *pooled)]
    np.testing.assert_array_equal(got[0], want[0])
    for i in (1, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[5], want[5])


def _accumulate_cases():
    hand = (np.array([[0, 3, 3, -1, 4, 2, -2, -4, -5, -6, -9, 5, 7]],
                     np.int32),
            np.arange(1, 14, dtype=np.float32)[None],
            np.arange(13)[None] != 5, 4)
    rng = np.random.default_rng(5)
    g = 64
    wide = (rng.integers(-2 * g - 3, g + 4, (6, 40)).astype(np.int32),
            rng.normal(0, 1, (6, 40)).astype(np.float32),
            rng.random((6, 40)) < 0.8, g)
    return {"hand": hand, "wide": wide}


@pytest.mark.parametrize("case", ["hand", "wide"])
def test_accumulate_plain_drops_like_the_reference(case):
    """Against the JAX package's _accumulate: events not ok go to its
    dropped slot; a negative position counts from the end of [G + 1] (-1
    is the dropped slot, -2 the last position), and what is still outside
    [0, G + 1) is dropped, as its scatter does."""
    from nanomod_tpu.parallel.mesh import _accumulate as jax_accumulate
    pos, val, ok, g = _accumulate_cases()[case]
    want = [np.asarray(x) for x in jax_accumulate(pos, val, ok,
                                                  genome_len=g)]
    got = [t.numpy() for t in mesh.accumulate(
        *(torch.from_numpy(x) for x in (pos, val, ok)), g)]
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    if case == "hand":
        assert got[0].tolist() == [2, 1, 0, 3]
    assert (pos < -1).any() and (pos >= g).any()


def _draw(kind, rng, g):
    """Events as distributed_detect_step gets them, [R, L]: ``uniform``
    positions over [-g - 3, g + 3), or ``read_major`` reads of consecutive
    positions (one or two events a base) starting uniformly over [-L, g):
    both hold negative positions and positions past the genome."""
    r, length = 24, 40
    if kind == "uniform":
        pos = rng.integers(-g - 3, g + 3, (r, length))
    else:
        start = rng.integers(-length, g, (r, 1))
        pos = start + np.cumsum(rng.integers(0, 2, (r, length)), axis=1)
    return (pos.astype(np.int32),
            rng.normal(0, 1, (r, length)).astype(np.float32),
            rng.random((r, length)) < 0.9)


@pytest.mark.parametrize("kind", ["uniform", "read_major"])
def test_accumulate_plain_equals_jax_draws(kind):
    from nanomod_tpu.parallel.mesh import _accumulate as jax_accumulate
    g = 300
    pos, val, ok = _draw(kind, np.random.default_rng(7), g)
    assert (pos < -1).any() and (pos >= g).any()
    want = [np.asarray(x) for x in jax_accumulate(pos, val, ok,
                                                  genome_len=g)]
    got = [t.numpy() for t in mesh.accumulate_plain(
        *(torch.from_numpy(x) for x in (pos, val, ok)), g)]
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert want[0].sum() > 0.5 * ok.sum()


# ---------------------------------------------------------------------------
# launches on a card that is not the current one, and the Annotate fan-out
# ---------------------------------------------------------------------------

class _FakeCard:
    """Stands in for torch.cuda's device guard and streams and for the
    kernel library, recording what is current when an entry point runs."""

    def __init__(self, rc=0):
        self.rc = rc
        self.current = torch.device("cuda", 0)
        self.calls = []

    def device(self, dev):
        card = self

        class Guard:
            def __enter__(self):
                self.prev, card.current = card.current, torch.device(dev)

            def __exit__(self, *exc):
                card.current = self.prev
        return Guard()

    def current_stream(self, dev):
        class Stream:
            cuda_stream = 1000 + torch.device(dev).index
        return Stream()

    def nm_fake(self, *args):
        self.calls.append((self.current, args))
        return self.rc

    def nm_error_string(self, rc):
        return b"invalid resource handle"

    def nm_enable_peer_access(self, peer):
        self.calls.append((self.current, peer))
        return self.rc


@pytest.mark.parametrize("rc", [0, 400])
def test_launch_makes_the_tensors_card_current(monkeypatch, rc):
    """kbuild.launch runs the entry point with the tensors' card current
    and that card's stream, then puts the previous card back; a failed
    launch raises with the kernel's name."""
    card = _FakeCard(rc)
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setattr(torch.cuda, "current_stream", card.current_stream)
    monkeypatch.setitem(kbuild._LIB, "lib", card)
    dev = torch.device("cuda", 1)
    if rc:
        with pytest.raises(RuntimeError, match="fake failed to launch"):
            kbuild.launch("fake", "nm_fake", dev, 7, 8)
    else:
        kbuild.launch("fake", "nm_fake", dev, 7, 8)
    assert card.calls == [(dev, (7, 8, 1001))]
    assert card.current == torch.device("cuda", 0)


@pytest.mark.parametrize("rc", [0, -1, 400])
def test_peer_access_enabled_once_or_raises(monkeypatch, rc):
    """kbuild.enable_peer_access asks with the reading card current, once
    a pair; two cards that cannot reach each other (-1) raise naming both,
    and so does a CUDA error."""
    card = _FakeCard(rc)
    monkeypatch.setattr(torch.cuda, "device", card.device)
    monkeypatch.setitem(kbuild._LIB, "lib", card)
    monkeypatch.setattr(kbuild, "_PEERS", set())
    a, b = torch.device("cuda", 2), torch.device("cuda", 3)
    kbuild.enable_peer_access(a, a)
    assert card.calls == []
    if rc == -1:
        with pytest.raises(RuntimeError, match="cuda:2 cannot read the "
                                               "memory of cuda:3"):
            kbuild.enable_peer_access(a, b)
    elif rc:
        with pytest.raises(RuntimeError, match="invalid resource handle"):
            kbuild.enable_peer_access(a, b)
    else:
        kbuild.enable_peer_access(a, b)
        kbuild.enable_peer_access(a, b)
        assert kbuild._PEERS == {(2, 3)}
    assert card.calls == [(a, 3)]
    assert card.current == torch.device("cuda", 0)


class _CardShard:
    """A stand-in for a shard's first tensor on CUDA card ``card``."""

    def __init__(self, card):
        self.card = card

    def get_device(self):
        return self.card


@pytest.mark.parametrize("reach", ["all", "none", "one_way"])
def test_stencil_stages_only_pairs_without_peer_access(monkeypatch, reach):
    """sharded_stencil_cuda copies a neighbour's columns exactly for the
    (reader, neighbour) pairs of cards that cudaDeviceCanAccessPeer says
    cannot reach each other; the others read in place."""
    can = {"all": lambda a, b: True, "none": lambda a, b: False,
           "one_way": lambda a, b: a < b}[reach]
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can)
    seen = []
    monkeypatch.setattr(sharded, "_stencil_step_cuda",
                        lambda shards, k, cov, staged: seen.append(staged))
    shards = [(_CardShard(c),) for c in (0, 0, 1, 2)]
    sharded.sharded_stencil_cuda(shards, 2, 0)
    pairs = {(a, b) for a in range(3) for b in range(3) if a != b}
    assert seen == [{p for p in pairs if not can(*p)}]


@pytest.mark.parametrize("lo,hi", [(0, 3), (7, 10), (10, 10)])
def test_staged_edge_copies_the_columns(lo, hi):
    """_staged_edge: the columns lo..hi of a shard's six vectors copied,
    then their pointers and the first column's index, lo."""
    rng = np.random.default_rng(lo + hi)
    shard = tuple(torch.from_numpy(rng.integers(0, 99, 10).astype(np.int32))
                  for _ in range(5)) + (torch.arange(10) % 3 == 0,)
    words, (ints, valid) = sharded._staged_edge(shard, lo, hi,
                                                torch.device("cpu"))
    for row, t in zip(ints, shard[:5]):
        assert torch.equal(row, t[lo:hi])
    assert valid.dtype == torch.bool and torch.equal(valid, shard[5][lo:hi])
    assert words[6] == lo
    if hi > lo:
        assert words[:6] == [r.data_ptr() for r in ints] + [valid.data_ptr()]
        assert valid.data_ptr() != shard[5].data_ptr()


def test_annotate_fan_out_devices(monkeypatch):
    from nanomod_tpu_torch.resquiggle import pipeline
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]

    def fan(n, device="cuda:0"):
        return pipeline._fan_out_devices(tcfg.AnnotateConfig(n_devices=n),
                                         device)
    assert fan(2) == cards[:2]
    assert fan(8) == cards                 # clamped to the cards there are
    assert fan(1) == fan(0) == [cards[0]]
    assert fan(4, "cpu") == [torch.device("cpu")]


def test_annotate_fan_out_equals_jax(tmp_path, monkeypatch):
    """DP sub-batches dealt round-robin over two devices (two CPU devices
    standing for two cards) give the corrected FAST5s of the JAX
    package's one-device Annotate."""
    import shutil

    from fixtures import make_raw_dataset
    from nanomod_tpu.resquiggle import annotate_folder as jax_annotate
    from nanomod_tpu_torch.resquiggle import pipeline

    chrom, genome = make_genome(length=500, seed=13)
    fasta = str(tmp_path / "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    jax_dir, torch_dir = str(tmp_path / "jax"), str(tmp_path / "torch")
    make_raw_dataset(jax_dir, chrom, genome, n_reads=20, seed=5,
                     read_len=400, error_rate=0.03)
    shutil.copytree(jax_dir, torch_dir)
    n_ok, _ = jax_annotate(jcfg.AnnotateConfig(wrk_base1=jax_dir,
                                               ref_fasta=fasta))
    assert n_ok >= 16

    fanned = []
    dispatch = pipeline.dispatch_dp

    def spy(part, fasta_, cfg, device, **kw):
        fanned.append((len(part), device.index))
        return dispatch(part, fasta_, cfg, device, **kw)

    two = [torch.device("cpu", 0), torch.device("cpu", 1)]
    monkeypatch.setattr(pipeline, "_fan_out_devices", lambda cfg, dev: two)
    monkeypatch.setattr(pipeline, "dispatch_dp", spy)
    got_ok, _ = pipeline.annotate_folder(tcfg.AnnotateConfig(
        wrk_base1=torch_dir, ref_fasta=fasta, n_devices=2), device="cpu")
    assert got_ok == n_ok
    assert [d for _, d in fanned][:2] == [0, 1], fanned
    for name in sorted(os.listdir(jax_dir)):
        assert _read(os.path.join(torch_dir, name)) == \
            _read(os.path.join(jax_dir, name)), name


# ---------------------------------------------------------------------------
# the multi-process merges under thread fakes
# ---------------------------------------------------------------------------

def _thread_gather(n):
    barrier = threading.Barrier(n)
    slots = [None] * n

    def gather_for(rank):
        def g(x):
            slots[rank] = np.asarray(x)
            barrier.wait()
            out = np.concatenate([slots[i] for i in range(n)])
            barrier.wait()
            return out
        return g
    return gather_for


def _run_ranks(inputs, fn):
    n = len(inputs)
    gather_for = _thread_gather(n)
    results, errors = [None] * n, []

    def worker(rank):
        try:
            results[rank] = fn(inputs[rank], gather_for(rank))
        except BaseException as e:
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return results


def _reads(seed, chroms=("cA", "cB")):
    rng = np.random.default_rng(seed)
    genome = np.random.default_rng(99).choice(
        [b"A", b"C", b"G", b"T"], 64).astype("S1")
    reads = []
    for _ in range(12):
        chrom = chroms[int(rng.integers(len(chroms)))]
        strand = "+-"[int(rng.integers(2))]
        start = int(rng.integers(0, 30))
        n = int(rng.integers(5, 15))
        vals = np.round(rng.normal(0, 1, n), 3).astype(np.float32)
        gpos = (start + np.arange(n) if strand == "+"
                else start + n - 1 - np.arange(n))
        reads.append((chrom, strand, start, vals, genome[gpos]))
    return reads


def _build(builder_cls, reads):
    b = builder_cls()
    for r in reads:
        b.add_read(*r)
    return b.finalize()


def test_shard_list_defaults_and_round_robin():
    items = list(range(10))
    assert dist.shard_list(items) == items
    for pc in (2, 3):
        for pid in range(pc):
            assert dist.shard_list(items, pid, pc) == \
                jdist.shard_list(items, pid, pc)


def test_world_size_without_process_group_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="process group"):
        dist.process_info()
    with pytest.raises(RuntimeError, match="process group"):
        dist.shard_list([1, 2, 3])


@pytest.mark.parametrize("hosts", [
    ((1, ("cA", "cB")), (2, ("cA", "cC"))),
    ((3, ("cA", "cB")), None, (4, ("cA", "cD")))])
def test_merge_pools_equals_jax(hosts, max_capacity=6):
    reads = [[] if h is None else _reads(*h) for h in hosts]
    kw = dict(process_count=len(hosts), max_capacity=max_capacity)
    want = _run_ranks([_build(JaxPoolBuilder, r) if r else {} for r in reads],
                      lambda p, g: jdist.merge_pools_across_hosts(
                          p, gather=g, **kw))
    got = _run_ranks([_build(PoolBuilder, r) if r else {} for r in reads],
                     lambda p, g: dist.merge_pools_across_hosts(
                         p, gather=g, **kw))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and len(w) >= 3
        for key in w:
            for attr in ("positions", "counts", "base", "values"):
                np.testing.assert_array_equal(getattr(g[key], attr),
                                              getattr(w[key], attr))


def test_merge_annotate_stats_equals_jax():
    per_host = [
        (5, {"Not in alignment sam": ["a.fast5"], "X": ["b.fast5"]}, {4: 3}),
        (0, {}, {}),
        (7, {"Not in alignment sam": ["c.fast5"]}, {4: 1, 1: 2}),
    ]
    want = _run_ranks(per_host, lambda s, g: jdist.merge_annotate_stats(
        *s, gather=g, process_count=3))
    got = _run_ranks(per_host, lambda s, g: dist.merge_annotate_stats(
        *s, gather=g, process_count=3))
    assert got == want
    assert got[0][0] == 12 and got[0][2] == {4: 4, 1: 2}
    assert dist.merge_annotate_stats(3, {"k": ["p"]}, {2: 1}) == \
        (3, {"k": ["p"]}, {2: 1})

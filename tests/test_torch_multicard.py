"""The port's multi-card paths, on a machine with two or more CUDA cards.

  * every kernel (K1, K2, K3, K6, K7, K9) launched on a card that is not
    the current one, against its plain version; K7 with its neighbours on
    other cards (read through peer access, and copied across cards first,
    the route for cards without peer access);
  * the sharded battery and the mesh step over the cards, against one card;
  * Annotate with its DP batches dealt over the cards, and detect with its
    joins sharded over them (``n_devices``), byte-equal to one card;
  * two ranks, each on its own card (``--device cuda``: rank r takes
    cuda:{r}), union and sharded detect byte-equal to one process.

Without two cards every test skips.  Run them on such a machine with
``python -m pytest tests/test_torch_multicard.py -q``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "nanomod_tpu_torch", "smoke_data")
COPIES = 8


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    kbuild.lib()
    torch.cuda.set_device(0)
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


def _elsewhere(cards, fn, *arrays):
    """``fn`` on the arrays copied to the last card while cuda:0 stays
    current, and ``fn`` on the arrays on the CPU (the plain versions): both
    results on the CPU."""
    other = cards[-1]
    assert torch.cuda.current_device() == 0
    got = fn(*(torch.from_numpy(a).to(other) for a in arrays))
    torch.cuda.synchronize(other)
    assert torch.cuda.current_device() == 0
    want = fn(*(torch.from_numpy(a) for a in arrays))
    listed = (lambda x: list(x) if isinstance(x, (tuple, list)) else [x])
    return [g.cpu() for g in listed(got)], listed(want)


@pytest.mark.parametrize("w", [128, 2048, 4097])
def test_k1_k2_on_a_card_that_is_not_current(cards, w):
    """A warp a read (W 128) and a block of warps a read with the windowed
    walk (W 2048; W 4097: the wide kernel's 16-lane plan, ragged); K2 also
    with the DP header."""
    from nanomod_tpu_torch.resquiggle import banded
    rng = np.random.default_rng(1)
    b, m = 37, 256
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = ref[:, w // 2: w // 2 + m].copy()
    lens = rng.integers(1, m + 1, b).astype(np.int32)

    def k1_k2(rd, rf, ln):
        tb, best, bi, bk = banded.banded_sw(rd, rf, ln)
        return (best, bi, bk, banded.walk(tb, bi, bk, packed=False)[0],
                banded.walk_outputs(tb, best, bi, bk)[0])
    got, want = _elsewhere(cards, k1_k2, read, ref, lens)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_k3_k6_on_a_card_that_is_not_current(cards):
    from nanomod_tpu_torch.stats import kernels
    rng = np.random.default_rng(2)
    p, c, cov = 300, 128, 40
    v1 = (rng.integers(-20, 21, (p, c)) * 50).astype(np.int16)
    v2 = (rng.integers(-20, 21, (p, c)) * 50).astype(np.int16)
    n1 = rng.integers(1, c + 1, p).astype(np.int32)
    n2 = rng.integers(1, c + 1, p).astype(np.int32)
    rows = (np.arange(p) + 17).astype(np.int32)

    def k3_k6(a, na, b, nb, r):
        return (kernels.battery_rows(a, na, b, nb, milli=True),
                kernels.capped_ks_d(a, na, b, nb, r, cov=cov, repeats=12,
                                    quantile_idx=3, seed=4))
    got, want = _elsewhere(cards, k3_k6, v1, n1, v2, n2, rows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _stencil_arrays(rng, p, cov):
    """(num, cap, n1c, n2c, pos, valid) of p positions: two joins, capped
    and uncapped rows, 7 padding rows at the end."""
    hi = 2 * cov
    cols = [rng.integers(0, 5000, p), rng.integers(0, 5000, p),
            rng.integers(1, hi + 1, p), rng.integers(1, hi + 1, p),
            np.concatenate([np.cumsum(rng.integers(1, 3, p // 3)),
                            3 + np.cumsum(rng.integers(1, 3, p - p // 3))])]
    return [c.astype(np.int32) for c in cols] + [np.arange(p) < p - 7]


def _step_on(devices, arrays, k, cov, staged=None):
    """The sharded stencil step with shard s of ``arrays`` on devices[s],
    every output on the CPU; with ``staged``, K7's route that copies the
    neighbour columns of those pairs of cards first."""
    from nanomod_tpu_torch.parallel import sharded
    length = len(arrays[0]) // len(devices)
    shards = [tuple(torch.from_numpy(a[s * length:(s + 1) * length]).to(d)
                    for a in arrays) for s, d in enumerate(devices)]
    if staged is None:
        out = sharded.sharded_stencil(shards, k, cov)
    else:
        out = sharded._stencil_step_cuda(shards, k, cov, staged)
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return [[t.cpu() for t in o] for o in out]


def test_k7_k9_on_a_card_that_is_not_current(cards):
    """K7's step with its three shards on the last card, and K9 there,
    while cuda:0 stays current."""
    rng = np.random.default_rng(3)
    k, cov = 2, 30
    arrays = _stencil_arrays(rng, 3 * 500, cov)
    other = cards[-1]
    assert torch.cuda.current_device() == 0
    got = _step_on([other] * 3, arrays, k, cov)
    assert torch.cuda.current_device() == 0
    want = _step_on([torch.device("cpu")] * 3, arrays, k, cov)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)

    g_len = 5000
    pos = rng.integers(-3 * g_len, g_len + 5, 100_000).astype(np.int32)
    val = rng.normal(0, 1, 100_000).astype(np.float32)
    ok = rng.random(100_000) < 0.9
    got, want = _elsewhere(cards, lambda *t: mesh.accumulate(*t, g_len),
                           pos, val, ok)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,cov", [(2, 200), (5, 0)])
def test_k7_neighbours_on_other_cards_match_plain(cards, k, cov):
    """K7 with each shard on its own card: the halo columns are read over
    NVLink through peer access, one launch a card; array-equal to the
    plain step on the CPU.  Then two shards a card, in turn (every shard's
    neighbours on other cards)."""
    rng = np.random.default_rng(30 + k)
    n = len(cards)
    arrays = _stencil_arrays(rng, 2 * n * 4096, cov or 30)
    for devices in (cards, [cards[s % n] for s in range(2 * n)]):
        before = kbuild.launch_counts()["stencil"]
        got = _step_on(devices, arrays, k, cov)
        assert kbuild.launch_counts()["stencil"] == before + n
        want = _step_on([torch.device("cpu")] * len(devices), arrays, k,
                        cov)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b)


@pytest.mark.parametrize("k,cov", [(2, 200), (5, 0)])
def test_k7_staged_neighbours_on_other_cards_match_in_place(cards, k, cov):
    """K7's route for cards without peer access, forced for every pair of
    cards: each neighbour's k edge columns copied across cards onto the
    reader's card first, one launch a card; array-equal to the in-place
    route and to the plain step on the CPU, a shard a card and two a card
    in turn."""
    rng = np.random.default_rng(40 + k)
    n = len(cards)
    arrays = _stencil_arrays(rng, 2 * n * 4096, cov or 30)
    every = {(a.index, b.index) for a in cards for b in cards if a != b}
    for devices in (cards, [cards[s % n] for s in range(2 * n)]):
        before = kbuild.launch_counts()["stencil"]
        got = _step_on(devices, arrays, k, cov, staged=every)
        assert kbuild.launch_counts()["stencil"] == before + n
        in_place = _step_on(devices, arrays, k, cov)
        want = _step_on([torch.device("cpu")] * len(devices), arrays, k,
                        cov)
        for g, i, w in zip(got, in_place, want):
            for a, b, c in zip(g, i, w):
                assert torch.equal(a, b)
                assert torch.equal(a, c)


@pytest.mark.parametrize("cov", [0, 40])
def test_sharded_battery_over_cards_equals_one_card(cards, cov):
    from nanomod_tpu_torch.config import StatConfig
    from nanomod_tpu_torch.parallel import sharded
    from nanomod_tpu_torch.stats import battery
    from nanomod_tpu_torch.stats.combine import combine_neighbor_pvalues
    rng = np.random.default_rng(cov)
    p, c = 40_000, 64
    v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0.2, 1, (p, c)), 3).astype(np.float32)
    n1 = rng.integers(1, c + 1, p).astype(np.int32)
    n2 = rng.integers(1, c + 1, p).astype(np.int32)
    pos = np.cumsum(rng.integers(1, 3, p)).astype(np.int64)
    cfg = StatConfig(coverages=(cov, cov), downsampling=20)
    m = mesh.make_mesh(len(cards))
    assert m.devices == cards
    got = sharded.sharded_join_battery(m, v1, n1, v2, n2, pos, cfg=cfg,
                                       want_mstd=True)
    want = battery.run_battery(v1, n1, v2, n2, cfg=cfg, device=cards[0],
                               want_mstd=True)
    want.stcomb, want.pcomb = combine_neighbor_pvalues(
        np.zeros(p, np.int64), pos, want.pks, cfg)
    for key in ("stu", "pu", "stt", "pt", "stks", "pks", "stcomb", "pcomb",
                "mstd"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)


def test_detect_step_over_cards_equals_plain(cards):
    rng = np.random.default_rng(6)
    g_len = 4096
    read_pos = rng.integers(0, g_len, (64, 128)).astype(np.int32)
    read_val = rng.normal(0, 1, (64, 128)).astype(np.float32)
    read_ok = rng.random((64, 128)) < 0.9
    p, n = 4096, 32
    z = np.where(rng.random((p, n)) < 0.8, rng.normal(0, 1, (p, n)), np.inf)
    z = np.sort(z, axis=1).astype(np.float32)
    lab = (rng.random((p, n)) < 0.5).astype(np.float32)
    lab[:, :2] = (1.0, 0.0)
    lab[~np.isfinite(z)] = 0.0
    n1 = (lab * np.isfinite(z)).sum(1).astype(np.float32)
    n2 = ((1 - lab) * np.isfinite(z)).sum(1).astype(np.float32)
    args = (g_len, read_pos, read_val, read_ok, z, lab, n1, n2)
    got = mesh.distributed_detect_step(mesh.make_mesh(len(cards)), *args)
    want = mesh.distributed_detect_step(
        mesh.make_mesh(len(cards), devices=["cpu"] * len(cards)), *args)
    assert torch.equal(got[0].cpu(), want[0])
    for g, w in zip(got[1:3], want[1:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    for g, w in zip(got[3:], want[3:]):
        assert torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# Annotate and detect over the cards, and one rank a card
# ---------------------------------------------------------------------------

def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _copy_group(src, dst):
    os.makedirs(dst)
    for name in sorted(os.listdir(src)):
        for k in range(COPIES):
            shutil.copyfile(os.path.join(src, name), os.path.join(
                dst, f"{name[:-len('.fast5')]}_{k:02d}.fast5"))
    return dst


@pytest.fixture(scope="module")
def corrected(cards, tmp_path_factory):
    """The smoke groups corrected on one card, then again with the DP
    batches dealt over every card: the two sets of files."""
    from nanomod_tpu_torch.config import AnnotateConfig
    from nanomod_tpu_torch.resquiggle.pipeline import annotate_folder
    root = str(tmp_path_factory.mktemp("multicard"))
    out = {}
    for n in (1, len(cards)):
        for group in ("ctrl", "case"):
            folder = _copy_group(os.path.join(DATA, group),
                                 os.path.join(root, f"{group}_{n}"))
            kbuild.reset_launches()
            n_ok, _ = annotate_folder(AnnotateConfig(
                wrk_base1=folder, ref_fasta=os.path.join(DATA, "ref.fa"),
                n_devices=n, dp_batch_size=16), device=cards[0])
            assert n_ok >= 0.9 * len(os.listdir(folder))
            assert kbuild.launch_counts()["banded_sw"] >= len(cards)
            out[group, n] = folder
    return root, out


def test_annotate_over_cards_equals_one_card(cards, corrected):
    _, out = corrected
    for group in ("ctrl", "case"):
        names = sorted(os.listdir(out[group, 1]))
        for name in names:
            assert _read(os.path.join(out[group, len(cards)], name)) == \
                _read(os.path.join(out[group, 1], name)), name


def _detect_args(out, folders, *extra):
    return ["detect", "--wrkBase1", folders["ctrl", 1], "--wrkBase2",
            folders["case", 1], "--outFolder", out, "--min_lr", "0",
            "--device", "cuda", *extra]


def _cli(args, env=None, timeout=300):
    p = subprocess.run([sys.executable, "-m", "nanomod_tpu_torch.cli",
                        *args], cwd=ROOT, env=env, text=True,
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       timeout=timeout)
    assert p.returncode == 0, p.stdout[-4000:]
    return p.stdout


def _two_ranks(args, timeout=300):
    """The CLI as two ranks of one gloo group; their stdouts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nanomod_tpu_torch.cli", *args], cwd=ROOT,
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return outs


@pytest.mark.parametrize("extra", [(), ("--coverages", "50-50", "--mstd",
                                        "1", "--downsampling", "100")])
def test_detect_over_cards_and_ranks_equals_one_card(cards, corrected,
                                                     extra):
    """detect --n_devices (the joins sharded over the cards), and two ranks
    on two cards (union and sharded merge): byte-equal to one card."""
    root, folders = corrected
    tag = "capped" if extra else "plain"
    files = ["mod_sign_test.txt"] + (["mod_meanstd.cvs"] if extra else [])
    single = os.path.join(root, f"single_{tag}")
    _cli(_detect_args(single, folders, *extra))
    runs = {"mesh": _detect_args(os.path.join(root, f"mesh_{tag}"), folders,
                                 "--n_devices", str(len(cards)), *extra)}
    _cli(runs["mesh"])
    for mode in ("union", "sharded"):
        metrics = os.path.join(root, f"{mode}_{tag}.json")
        out = os.path.join(root, f"{mode}_{tag}")
        _two_ranks(_detect_args(out, folders, "--merge_mode", mode,
                                "--metricsFile", metrics, *extra))
        runs[mode] = None
        for rank in range(2):
            with open(metrics.replace(".json", f".rank{rank}.json")) as f:
                m = json.load(f)
            assert m["device"] == f"cuda:{rank}"
            assert m["kernel_launches"]["battery"] > 0
            assert m["kernel_launches"]["capped_ks"] > 0 or not extra
    for name in runs:
        for f in files:
            got = _read(os.path.join(root, f"{name}_{tag}", f))
            assert got == _read(os.path.join(single, f)), (name, f)
            assert len(got.splitlines()) > 1000

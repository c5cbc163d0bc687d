"""The port's banded DP and walk (plain versions of kernels K1 and K2)
against the JAX package on the same numpy inputs: array-equal outputs."""

import numpy as np
import pytest
import torch

from nanomod_tpu.resquiggle import banded as jb
from nanomod_tpu.resquiggle.banded_pallas import banded_sw_pallas
from nanomod_tpu_torch.kernels import build as kbuild
from nanomod_tpu_torch.resquiggle import banded as tb


def _inputs(b, m, w, seed, short=(), n_rate=0.0):
    """The inputs of tests/test_resquiggle.py::test_pallas_dp_matches_scan,
    optionally with short reads and N codes."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, (b, m + w)).astype(np.uint8)
    read = np.empty((b, m), np.uint8)
    for i in range(b):
        read[i] = ref[i, w // 2: w // 2 + m]
        mut = rng.random(m) < 0.05
        read[i, mut] = rng.integers(0, 4, mut.sum())
    if n_rate:
        read[rng.random((b, m)) < n_rate] = 4
    lens = np.full(b, m, np.int32)
    for i, n in short:
        lens[i] = n
        read[i, n:] = 4
    return read, ref, lens


CASES = {
    "resquiggle_inputs": dict(b=8, m=256, w=128, seed=0, short=((5, 200),)),
    "m256_short_n": dict(b=8, m=256, w=128, seed=1, short=((2, 37), (6, 130)),
                         n_rate=0.02),
    "m512_short_n": dict(b=8, m=512, w=128, seed=2, short=((0, 300),),
                         n_rate=0.01),
}


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module", params=sorted(CASES))
def dp(request):
    read, ref, lens = _inputs(**CASES[request.param])
    want = [np.asarray(x) for x in jb.banded_sw(read, ref, lens)]
    got = [x.numpy() for x in tb.banded_sw(*_torch(read, ref, lens))]
    return read, ref, lens, want, got


def test_banded_sw_plain_matches_jax(dp):
    *_, want, got = dp
    for name, a, b in zip(("tb", "best", "best_i", "best_k"), want, got):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_banded_sw_plain_matches_pallas_interpret(dp):
    read, ref, lens, _, got = dp
    pal = [np.asarray(x) for x in banded_sw_pallas(read, ref, lens)]
    for name, a, b in zip(("tb", "best", "best_i", "best_k"), pal, got):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_walk_and_packing_byte_equal(dp):
    *_, want, got = dp
    codes_j = np.asarray(jb.walk_device(want[0], want[2], want[3]))
    t_tb, t_best, t_bi, t_bk = _torch(*got)
    codes_t = tb.walk_device_plain(t_tb, t_bi, t_bk)
    np.testing.assert_array_equal(codes_j, codes_t.numpy())
    packed_t = tb.pack_codes2(codes_t)
    np.testing.assert_array_equal(np.asarray(jb.pack_codes2(codes_j)),
                                  packed_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jb.pack_outputs(jb.pack_codes2(codes_j), want[1], want[2],
                                   want[3])),
        tb.pack_outputs(packed_t, t_best, t_bi, t_bk).numpy())
    np.testing.assert_array_equal(
        np.asarray(jb.pack_outputs(*want)),
        tb.pack_outputs(t_tb, t_best, t_bi, t_bk).numpy())
    np.testing.assert_array_equal(np.asarray(jb.pack_tb(want[0])),
                                  tb.pack_tb(t_tb).numpy())


def test_host_decoders_agree(dp):
    *_, got = dp
    t_tb, _, t_bi, t_bk = _torch(*got)
    codes = tb.walk_device_plain(t_tb, t_bi, t_bk).numpy()
    packed = tb.pack_codes2(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tb.unpack_codes2(packed), codes)
    nat = tb.decode_walk_native(packed, got[2], got[3], packed=True)
    trace = tb.traceback_batch_native(got[0], got[2], got[3], packed=False)
    for i in range(len(codes)):
        ops = tb.decode_walk(codes[i], got[2][i], got[3][i])
        ot = np.array([{"M": 0, "I": 1, "D": 2}[o[0]] for o in ops], np.int32)
        np.testing.assert_array_equal(nat[i][0], ot)
        np.testing.assert_array_equal(nat[i][0], trace[i][0])
        np.testing.assert_array_equal(nat[i][1], trace[i][1])


def test_packed_walk_equals_packed_jax_walk(dp):
    """The packed walk (K2's plain version) is pack_codes2 of the JAX
    walk_device, byte for byte."""
    *_, want, got = dp
    codes_j = jb.walk_device(want[0], want[2], want[3])
    t_tb, _, t_bi, t_bk = _torch(*got)
    packed, _ = tb.walk(t_tb, t_bi, t_bk, packed=True)
    assert packed.dtype == torch.uint8
    assert packed.shape == (t_tb.shape[0], (2 * t_tb.shape[1]
                                            + t_tb.shape[2]) // 4)
    np.testing.assert_array_equal(np.asarray(jb.pack_codes2(codes_j)),
                                  packed.numpy())
    np.testing.assert_array_equal(
        tb.walk_packed_plain(t_tb, t_bi, t_bk).numpy(), packed.numpy())


def test_pack_outputs_rounds_half_to_even():
    best = torch.tensor([0.5, 1.5, 2.5, -0.5, 7.0], dtype=torch.float32)
    z = torch.zeros(5, dtype=torch.int32)
    tbm = torch.zeros((5, 4), dtype=torch.uint8)
    packed = tb.pack_outputs(tbm, best, z, z).numpy()
    _, b, _, _ = tb.unpack_outputs(packed, (4,))
    np.testing.assert_array_equal(b, [0, 2, 2, 0, 7])
    ref = np.asarray(jb.pack_outputs(tbm.numpy(), best.numpy(), z.numpy(),
                                     z.numpy()))
    np.testing.assert_array_equal(ref, packed)


def test_cpu_tensors_take_the_plain_version():
    read, ref, lens = _inputs(b=2, m=256, w=128, seed=5)
    before = kbuild.launch_counts()
    out = tb.banded_sw(*_torch(read, ref, lens))
    tb.walk(out[0], out[2], out[3], packed=True)
    assert kbuild.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    read, ref, lens = _torch(*_inputs(b=2, m=256, w=128, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        banded_sw_cuda(read, ref, lens)
    with pytest.raises(ValueError, match="CUDA"):
        tb._walk_cuda(torch.zeros((2, 4, 32), dtype=torch.uint8),
                      torch.zeros(2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), packed=True)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper's checks
    run up to the launch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_cuda(t):
    return t.as_subclass(_OnCuda)


@pytest.mark.parametrize("bad", ["read_dtype", "ref_dtype", "len_dtype"])
def test_k1_wrapper_refuses_wrong_dtypes(bad):
    from nanomod_tpu_torch.resquiggle.banded_kernel import banded_sw_cuda
    read, ref, lens = _torch(*_inputs(b=2, m=64, w=32, seed=7))
    if bad == "read_dtype":
        read = read.to(torch.int32)
    elif bad == "ref_dtype":
        ref = ref.to(torch.int64)
    else:
        lens = lens.to(torch.int64)
    with pytest.raises(ValueError, match="uint8|int32"):
        banded_sw_cuda(*map(_on_cuda, (read, ref, lens)))


@pytest.mark.parametrize("bad", ["tb_dtype", "best_dtype", "unpackable"])
def test_k2_wrapper_refuses_wrong_dtypes(bad):
    tbm = torch.zeros((2, 64, 32), dtype=torch.uint8)
    bi = torch.zeros(2, dtype=torch.int32)
    bk = torch.zeros(2, dtype=torch.int32)
    if bad == "tb_dtype":
        tbm = tbm.to(torch.int16)
    elif bad == "best_dtype":
        bi = bi.to(torch.int64)
    else:
        tbm = torch.zeros((2, 63, 32), dtype=torch.uint8)   # 2M+W = 158
    with pytest.raises(ValueError, match="uint8|int32|pack"):
        tb._walk_cuda(*map(_on_cuda, (tbm, bi, bk)), packed=True)

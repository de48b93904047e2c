"""PyTorch port vs the JAX package: the two kernel modules on the serving
path, through their plain PyTorch versions (what the wrappers run on CPU
tensors) against the Pallas kernels in interpret mode."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu.ops.pallas import packed as JP
from shiftedscalequantization_tpu.ops.pallas.stem import stem_fused as j_stem
from shiftedscalequantization_tpu_torch.ops.cuda import packed as TP
from shiftedscalequantization_tpu_torch.ops.cuda import stem as TS


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k", [64, 67, 130])
def test_pack_unpack_roundtrip(bits, k):
    """The port's own packing round-trips exactly, ragged K included."""
    rng = np.random.default_rng(bits * 1000 + k)
    q = torch.as_tensor(rng.integers(0, 2 ** bits, (k, 24)), dtype=torch.int32)
    w = TP.pack_codes(q, bits)
    f = 32 // bits
    assert w.dtype == torch.int32 and tuple(w.shape) == (24, -(-k // f))
    assert torch.equal(TP.unpack_codes(w, bits, k), q)


def test_pack_uses_the_top_bit():
    """Codes in the top slot set bit 31: the int32 word must wrap, not
    overflow."""
    q = torch.full((16, 3), 3, dtype=torch.int32)
    w = TP.pack_codes(q, 2)
    assert int(w[0, 0]) == -1
    assert torch.equal(TP.unpack_codes(w, 2, 16), q)


@pytest.mark.parametrize("bits,k,relu,feed", [
    (2, 64, False, "f32"), (2, 72, True, "f32"), (4, 130, False, "f32"),
    (4, 48, True, "codes"), (2, 256, False, "codes")])
def test_packed_plain_matches_pallas(bits, k, relu, feed):
    """Plain version vs packed_quant_matmul(interpret=True), each package
    packing the same raw codes its own way. The int32 accumulation is
    exact on both sides, so only the f32 epilogue can differ: atol 1e-4,
    rtol 1e-5 (tests/test_pallas.py:112). K = 72 and 130 are not multiples
    of 16, so the last packed word is partial. 'codes' feeds integer codes
    with delta 1, as deploy does for an int8 producer."""
    rng = np.random.default_rng(bits * 100 + k)
    m, n = 40, 48
    if feed == "codes":
        x = rng.integers(-7, 9, (m, k)).astype(np.float32)
        delta, zp = 1.0, 7.0
    else:
        x = rng.normal(size=(m, k)).astype(np.float32)
        delta, zp = 0.05, 7.0
    q_raw = rng.integers(0, 2 ** bits, (k, n))
    w_zp = rng.integers(0, 2 ** bits, (n,)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    want = np.asarray(JP.packed_quant_matmul(
        jnp.asarray(x), JP.pack_codes(jnp.asarray(q_raw, jnp.int32), bits),
        jnp.asarray(w_zp), jnp.asarray(scale), jnp.asarray(bias), delta, zp,
        bits, 4, relu=relu, interpret=True))
    got = TP.packed_quant_matmul(
        torch.as_tensor(x), TP.pack_codes(torch.as_tensor(q_raw,
                                                          dtype=torch.int32),
                                          bits),
        torch.as_tensor(w_zp), torch.as_tensor(scale), torch.as_tensor(bias),
        delta, zp, bits, 4, relu=relu)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_packed_wrapper_uses_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    before = TP.packed_quant_matmul.launches
    x = torch.zeros((20, 16))
    w = TP.pack_codes(torch.zeros((16, 8), dtype=torch.int32), 2)
    out = TP.packed_quant_matmul(x, w, torch.zeros(8), torch.ones(8),
                                 torch.zeros(8), 0.1, 0.0, 2)
    assert TP.packed_quant_matmul.launches == before
    assert torch.equal(out, torch.zeros((20, 8)))


@pytest.mark.parametrize("h,oc,biased,seed", [(32, 16, True, 0),
                                              (64, 64, True, 1),
                                              (64, 16, False, 3)])
def test_stem_plain_matches_pallas(h, oc, biased, seed):
    """Plain f32 stem vs stem_fused(interpret=True), whose conv is a 2-pass
    bf16 split: codes may differ by one step at rounding boundaries only,
    on at most 2e-3 of outputs (tests/test_pallas_fused.py:51). Biased is
    the 8-bit serving site (center_off 128); centered a 4-bit site."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h, 3)).astype(np.float32)
    w = rng.integers(-120, 121, (oc, 3, 7, 7)).astype(np.float32)
    scale = rng.uniform(0.001, 0.004, oc).astype(np.float32)
    bias = (rng.normal(size=oc) * 0.1).astype(np.float32)
    if biased:
        delta, zp, qmax, coff = 0.02, 0.0, 255.0, 128.0
    else:
        delta, zp, qmax, coff = 0.1, 0.0, 15.0, 0.0
    want = np.asarray(j_stem(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(scale), jnp.asarray(bias), delta,
                             zp, qmax, coff, interpret=True))
    before = TS.stem_fused.launches
    got = TS.stem_fused(torch.as_tensor(x), torch.as_tensor(w),
                        torch.as_tensor(scale), torch.as_tensor(bias), delta,
                        zp, qmax, coff)
    assert TS.stem_fused.launches == before
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 2e-3, (diff != 0).mean()

"""PyTorch port vs the JAX package: the non-gradient selection searches
(``recon/search.py``), each case of ``tests/test_search.py``, on the CPU.

The quantizer parameters come from the JAX package and are carried
across. Tolerances: candidates bit for bit (the same ops in the same
order); the weight-greedy, distance and output-greedy selections equal
to the JAX package's and their losses within rtol 1e-5; the random
selection, which draws from a ``torch.Generator`` and cannot repeat
JAX's draws, to the JAX test's distribution (base share within 0.1 of
1 - prob_nonbase, indices below the candidate count) and determinism.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from shiftedscalequantization_tpu.graph import UnitSpec as JUnitSpec
from shiftedscalequantization_tpu.ops import quant as JQ
from shiftedscalequantization_tpu.recon import search as JS
from shiftedscalequantization_tpu_torch.graph import UnitSpec
from shiftedscalequantization_tpu_torch.recon import search as TS
from shiftedscalequantization_tpu_torch.utils import jax_import as JI

LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs (several test workers
    share the cores, and small ops on threads that wait for busy cores
    run hundreds of times slower)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _qp(w, n_bits=4):
    """(JAX QParams, port QParams): per-out-channel max scales."""
    qp, _ = JQ.init_weight_qparams(jnp.asarray(w.reshape(w.shape[0], -1)),
                                   n_bits, False, True, scale_method="max")
    return qp, JI.qparams_from_numpy(qp, "cpu")


def _cands(w, targets=(0.5, 1.0)):
    jqp, tqp = _qp(w)
    want = JS.candidate_weights(jqp, jnp.asarray(w), targets)
    got = TS.candidate_weights(tqp, torch.tensor(w), targets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return want, got


@pytest.mark.parametrize("shape", [(6, 4, 3, 3), (5, 8)], ids=["conv", "fc"])
@pytest.mark.parametrize("p", [2.4, 2.0])
def test_weight_greedy_matches_jax(shape, p):
    """TestWeightGreedy: the per-pair argmin, checked by brute force too."""
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jc, tc = _cands(w)
    jsel, jloss = JS.weight_greedy_selection(jnp.asarray(w), jc, p=p)
    tsel, tloss = TS.weight_greedy_selection(torch.tensor(w), tc, p=p)
    assert tsel.dtype == torch.int32 and tuple(tsel.shape) == shape[:2]
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    err = (np.abs(tc.numpy() - w[None]) ** p).reshape(2, *shape[:2], -1) \
        .sum(-1)
    np.testing.assert_array_equal(tsel.numpy(), err.argmin(0))
    np.testing.assert_allclose(float(tloss), err.min(0).sum(), rtol=1e-5)
    # apply_selection picks each pair's candidate
    sel = TS.apply_selection(tc, tsel)
    np.testing.assert_array_equal(
        sel.numpy(), np.asarray(JS.apply_selection(jc, jsel)))


def test_dist_selection_matches_jax():
    """TestDistSelection: per-pair L2 argmin over the steps delta /
    qParam[k], qParam = (1.0, 0.5), against the JAX package and the
    reference rule by brute force."""
    rng = np.random.default_rng(2)
    w = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    jqp, tqp = _qp(w)
    jsel, jloss = JS.dist_selection(jqp, jnp.asarray(w))
    tsel, tloss = TS.dist_selection(tqp, torch.tensor(w))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    delta = np.asarray(jqp.delta).reshape(5, 1, 1, 1)
    zp = np.asarray(jqp.zero_point).reshape(5, 1, 1, 1)
    losses = []
    for q in (1.0, 0.5):
        step = delta / q
        xq = np.clip(np.round(w / step) + zp, 0, 2 ** 4 - 1)
        losses.append((np.abs((xq - zp) * step - w) ** 2)
                      .reshape(5, 3, -1).sum(-1))
    np.testing.assert_array_equal(tsel.numpy(), np.stack(losses).argmin(0))


def _output_case(kind):
    """(port spec, JAX spec, w, x) of TestOutputGreedy's two cases."""
    rng = np.random.default_rng(1 if kind == "linear" else 2)
    if kind == "linear":
        w = (rng.normal(size=(5, 8)) * 0.3).astype(np.float32)
        x = rng.normal(size=(32, 8)).astype(np.float32)
        return UnitSpec("u", "linear", 8, 5), JUnitSpec("u", "linear", 8, 5), \
            w, x
    w = (rng.normal(size=(4, 3, 3, 3)) * 0.3).astype(np.float32)
    x = rng.normal(size=(8, 6, 6, 3)).astype(np.float32)
    kw = dict(kernel=(3, 3), padding=(1, 1))
    return UnitSpec("u", "conv", 3, 4, **kw), JUnitSpec("u", "conv", 3, 4,
                                                        **kw), w, x


@pytest.mark.parametrize("kind", ["linear", "conv"])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_output_greedy_matches_jax(kind, sweeps):
    """TestOutputGreedy: the coordinate descent's selection equals the JAX
    package's, its loss within LOSS_RTOL of it and no worse than the
    all-base selection's."""
    spec, jspec, w, x = _output_case(kind)
    jc, tc = _cands(w)
    jtgt = JS._unit_out(jspec, jnp.asarray(w), jnp.asarray(x))
    tgt = TS._unit_out(spec, torch.tensor(w), torch.tensor(x))
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=1e-5,
                               atol=1e-6)
    jsel, jloss = JS.output_greedy_selection(jspec, jc, jnp.asarray(x),
                                             jtgt, sweeps=sweeps)
    tsel, tloss = TS.output_greedy_selection(spec, tc, torch.tensor(x),
                                             torch.tensor(np.asarray(jtgt)),
                                             sweeps=sweeps)
    assert tsel.dtype == torch.int32 and tuple(tsel.shape) == w.shape[:2]
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    base = TS._unit_out(spec, TS.apply_selection(
        tc, torch.zeros(w.shape[:2], dtype=torch.int32)), torch.tensor(x))
    base_loss = float((torch.abs(base - tgt) ** 2).sum(-1).mean())
    assert float(tloss) <= base_loss + 1e-6


def test_random_selection_distribution_and_determinism():
    """TestRandomSelection: base share near 1 - prob_nonbase, indices
    below the candidate count, the same draws from the same seed, other
    draws from another."""
    def draw(seed, **kw):
        return TS.random_selection(torch.Generator().manual_seed(seed), 64,
                                   64, 3, **kw)

    sel = draw(0, prob_nonbase=0.5)
    assert sel.dtype == torch.int32 and tuple(sel.shape) == (64, 64)
    assert 0.4 < float((sel == 0).double().mean()) < 0.6
    assert int(sel.min()) == 0 and int(sel.max()) <= 2
    assert {1, 2} <= set(sel.unique().tolist())
    assert torch.equal(sel, draw(0, prob_nonbase=0.5))
    assert not torch.equal(sel, draw(1, prob_nonbase=0.5))
    assert 0.15 < float((draw(2, prob_nonbase=0.8) == 0).double().mean()) \
        < 0.25
    assert int(TS.random_selection(torch.Generator().manual_seed(0), 8, 8,
                                   1).max()) <= 1

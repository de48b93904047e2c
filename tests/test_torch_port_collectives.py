"""PyTorch port vs the JAX package: ``parallel/collectives`` (the int8-wire
mean ``quantized_pmean`` and ``pmean_tree``), on the CPU.

The port runs in ``world`` gloo rank processes (``torch_port_ranks``, one
group per world size for the whole module); the JAX package runs here
under ``shard_map`` on ``world`` of the faked CPU devices. Row r of every
input (numpy seeds) is rank r's, and device r's, contribution. The
quantized mean is integer arithmetic between one f32 quantize and one f32
dequantize, so it must equal the JAX package's bit for bit; the plain f32
mean (the wire 'f32' and the small-tensor fallback) sums in each
backend's order, so it is held to JAX's own tolerance, rtol 1e-6, and
where values cancel to ``world`` f32 steps of the largest input
(``_f32_atol``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from shiftedscalequantization_tpu.parallel import collectives as JCO
from shiftedscalequantization_tpu.parallel.mesh import make_mesh
from shiftedscalequantization_tpu_torch.parallel import collectives as TCO
from torch_port_ranks import run_ranks

WORLDS = (2, 4)
SHAPES = {"3x257": (3, 257), "640": (640,), "small": (2,)}


def _inputs(world):
    rng = np.random.default_rng(world)
    xs = {k: rng.standard_normal((world,) + s).astype(np.float32)
          for k, s in SHAPES.items()}
    # integer codes with amax 127 (delta exactly 1): columns where every
    # rank sends +127 or -127 put the int16 sums at +-127 * world
    codes = rng.integers(-127, 128, size=(world, 300)).astype(np.float32)
    codes[:, :50] = 127.0
    codes[:, 50:100] = -127.0
    tree = {"conv1": {"alpha": rng.standard_normal((world, 16, 8, 3, 3)),
                      "beta": rng.standard_normal((world, 16, 8, 3, 3))},
            "conv2": {"alpha": rng.standard_normal((world, 8, 16, 1, 1)),
                      "scale": rng.standard_normal((world, 1))}}
    tree = {u: {k: v.astype(np.float32) for k, v in t.items()}
            for u, t in tree.items()}
    return dict(xs=xs, codes=codes, tree=tree)


def _f32_atol(x, world):
    """How far two orders of summing ``world`` rows of ``x`` may part."""
    return world * float(np.finfo(np.float32).eps) * float(np.abs(x).max())


def _jax(fn, x, world):
    """``fn`` under shard_map over ``world`` devices, each given its row;
    the rows of the result."""
    mesh = make_mesh(n_data=world, devices=jax.devices()[:world])
    f = shard_map(fn, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                  check_vma=False)
    with mesh:
        return jax.tree.map(np.asarray, f(x))


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    world = request.param
    spec = _inputs(world)
    res = run_ranks("collectives", world,
                    tmp_path_factory.mktemp(f"coll{world}"), spec)
    return world, spec, res


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_quantized_pmean_equals_jax(ranks, shape):
    world, spec, res = ranks
    x = spec["xs"][shape]
    want = _jax(lambda v: JCO.quantized_pmean(v[0], "data")[None], x, world)
    for r in range(world):
        got = res[r][f"qpm/{shape}"]
        if shape == "small":    # under 4n elements: the plain f32 mean
            np.testing.assert_allclose(got, want[r], rtol=1e-6,
                                       atol=_f32_atol(x, world))
        else:
            np.testing.assert_array_equal(got, want[r])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ranks_bit_identical_and_within_one_step(ranks, shape):
    world, spec, res = ranks
    x = spec["xs"][shape]
    got = res[0][f"qpm/{shape}"]
    for r in range(1, world):
        np.testing.assert_array_equal(res[r][f"qpm/{shape}"], got)
    tol = float(np.abs(x).max()) / 254.0 + 1e-7
    np.testing.assert_allclose(got, x.mean(axis=0), atol=tol)


def test_int16_sums_cross_as_int8_bytes_and_exact(ranks):
    """Gloo refuses int16: the chunk sums travel as an int8 view. Every
    payload on the wire is int8 but the f32 amax, and codes summing to
    +-127 * world come back exact."""
    world, spec, res = ranks
    for r in range(world):
        assert res[r]["wire_dtypes"] == [
            ("all_reduce", "torch.float32"),
            ("all_to_all_single", "torch.int8"),
            ("all_gather_into_tensor", "torch.int8")]
        np.testing.assert_array_equal(res[r]["codes"],
                                      spec["codes"].mean(axis=0))
    assert res[0]["backend"] == "gloo"


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_pmean_tree_equals_jax(ranks, wire):
    world, spec, res = ranks
    want = _jax(lambda t: jax.tree.map(
        lambda a: a[None],
        JCO.pmean_tree(jax.tree.map(lambda a: a[0], t), "data", wire)),
        jax.tree.map(jnp.asarray, spec["tree"]), world)
    for r in range(world):
        got = res[r][f"tree/{wire}"]
        for u, t in want.items():
            for k, v in t.items():
                if wire == "int8" and v[r].size >= 4 * world:
                    np.testing.assert_array_equal(got[u][k], v[r])
                else:
                    np.testing.assert_allclose(
                        got[u][k], v[r], rtol=1e-6,
                        atol=_f32_atol(spec["tree"][u][k], world))


def test_unknown_wire_raises():
    import torch
    with pytest.raises(ValueError, match="unknown wire format 'bf16'"):
        TCO.pmean_tree({"a": torch.zeros(4)}, None, "bf16")

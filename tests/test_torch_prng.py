"""The port's threefry stream (repro_torch.core.prng) against
``jax.random`` under threefry2x32 with the partitionable layout:
bitwise, for keys, scalar and row-batched fold-ins and bit blocks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, 2 ** 32 - 1]


def _key(seed):
    return tuple(int(v) for v in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert prng.PRNGKey(seed) == _key(seed)


@pytest.mark.parametrize("seed", [2 ** 32, -2 ** 31 - 1])
def test_prng_key_rejects_seeds_beyond_32_bits(seed):
    with pytest.raises(ValueError):
        prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("data", [0, 5, 131071 * 3 + 2, 2 ** 31,
                                  2 ** 32 - 1])
def test_scalar_fold_in_matches_jax(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    assert prng.fold_in(prng.PRNGKey(seed), data) == tuple(int(v)
                                                           for v in want)


def test_chained_fold_in_matches_sampler_keys():
    """The sampler's per-(step, layer, edge block) key recipe."""
    base = jax.random.PRNGKey(3)
    tbase = prng.PRNGKey(3)
    for step in (0, 1, 1000):
        for li, ei in ((0, 0), (1, 6), (2, 3)):
            want = jax.random.fold_in(jax.random.fold_in(base, step),
                                      li * 131071 + ei)
            got = prng.fold_in(prng.fold_in(tbase, step), li * 131071 + ei)
            assert got == tuple(int(v) for v in np.asarray(want))


@pytest.mark.parametrize("ids", [
    np.array([0], np.int32),
    np.array([0, 3, 2 ** 31 - 1, 17, 99999, 3], np.int32),
    np.random.default_rng(0).integers(0, 2 ** 31 - 1, 257).astype(np.int32),
])
def test_row_batched_fold_in_matches_vmap(ids):
    key = jax.random.PRNGKey(11)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, ids)
    got = prng.fold_in(prng.PRNGKey(11), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (3,), (5, 7), (2, 3, 4), (128, 5),
                                   (7, 13)])
def test_bits_match_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = prng.bits(prng.fold_in(prng.PRNGKey(5), 9), shape,
                    device=torch.device("cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("fanout", [1, 2, 5])
def test_row_key_bits_match_vmapped_bits(fanout):
    """Serving's seed-keyed draw: one fanout block of words per row key."""
    ids = np.array([4, 0, 79, 4, 2 ** 31 - 1], np.int32)
    key = jax.random.PRNGKey(0)
    rk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, ids)
    want = jax.vmap(lambda k: jax.random.bits(k, (fanout,),
                                              jnp.uint32))(rk)
    got = prng.bits(prng.fold_in(prng.PRNGKey(0), torch.from_numpy(ids)),
                    (fanout,))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_threefry_on_ints_equals_threefry_on_tensors():
    x = torch.tensor([0, 1, 2 ** 32 - 1], dtype=torch.int64)
    y1, y2 = prng.threefry2x32(7, 2 ** 31, x, x.flip(0))
    for i, v in enumerate(x.tolist()):
        assert prng.threefry2x32(7, 2 ** 31, v, x.flip(0)[i].item()) == \
            (y1[i].item(), y2[i].item())

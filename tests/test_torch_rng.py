"""The port's threefry RNG (repro_torch.core.rng) reproduces jax.random bit
for bit: keys, fold_in, randint's range reduction, and the fused chooser's
per-slot random table."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transition as jtx
from repro_torch.core import rng
from repro_torch.core import transition as ttx

SEEDS = [0, 1, 3, 12345, 2**31 - 1, -1, -7]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    kt = rng.prng_key(seed, "cpu")
    assert kt.dtype == torch.uint32 and tuple(kt.shape) == (2,)
    np.testing.assert_array_equal(np.asarray(key), kt.numpy())
    idx = np.array([0, 1, 2, 5, 255, 1000, 2**31 - 1])
    want = np.stack([np.asarray(jax.random.fold_in(key, int(i))) for i in idx])
    np.testing.assert_array_equal(want, rng.fold_in(kt, torch.as_tensor(idx)).numpy())
    np.testing.assert_array_equal(want[3], rng.fold_in(kt, 5).numpy())


_JAX_ROW = jax.jit(lambda k, i: jnp.stack(
    [jax.random.randint(jax.random.fold_in(k, i), (), 0, m)
     for m in range(1, 17)]))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_randint_grid(seed):
    """randint(fold_in(key, i), (), 0, m) for m in 1..16 over event indices."""
    key = jax.random.PRNGKey(seed)
    kt = rng.prng_key(seed, "cpu")
    for i in [0, 1, 17, 4096, 2**30]:
        want = np.asarray(_JAX_ROW(key, i))
        got = [int(rng.randint(rng.fold_in(kt, i), 0, m)) for m in range(1, 17)]
        np.testing.assert_array_equal(want, got)
        hi, lo = rng.draw_words(kt, torch.tensor([i]))
        got_w = rng.randint_words(hi, lo, torch.arange(1, 17)).numpy()
        np.testing.assert_array_equal(want, got_w)


def test_randint_nonzero_min_and_empty_span():
    key = jax.random.PRNGKey(4)
    kt = rng.prng_key(4, "cpu")
    for lo_, hi_ in [(3, 10), (-5, 5), (0, 0), (2, 1)]:
        want = int(jax.random.randint(key, (), lo_, hi_))
        assert int(rng.randint(kt, lo_, hi_)) == want, (lo_, hi_)


@pytest.mark.parametrize("seed,t0,w,k_max", [(0, 0, 8, 6), (3, 100, 32, 16),
                                              (9, 12345, 5, 1)])
def test_rand_index_table(seed, t0, w, k_max):
    want = np.asarray(jtx.rand_index_table(jax.random.PRNGKey(seed), t0, w,
                                           k_max))
    got = ttx.rand_index_table(rng.prng_key(seed, "cpu"), t0, w, k_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())

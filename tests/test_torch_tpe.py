"""The adaptive search's host side, carried into the port: the TPE module
(search/tpe.py) gives the JAX package's suggestions for the same rng and
trials, and the numpy seed chain (search/seed_chain.py) is the JAX
package's jax.random.split chain, bit for bit."""

import math

import jax
import numpy as np
import pytest

from cpflow_tpu.search import tpe as jtpe
from cpflow_tpu_torch.search import seed_chain
from cpflow_tpu_torch.search import tpe as ttpe


def _space(mod):
    return [mod.QUniformInt('num_cp_gates', 10, 40, 1),
            mod.LogNormal('r', math.log(0.00055), 0.5)]


def _trials(mod, n, seed):
    rng = np.random.default_rng(seed)
    trials = mod.Trials()
    for i in range(n):
        loss = float(rng.normal(10, 3)) if i % 7 else float('inf')
        trials.record([int(rng.integers(10, 41)),
                       float(np.exp(rng.normal(math.log(0.00055), 0.5)))],
                      {'loss': loss, 'status': 'ok'})
    return trials


@pytest.mark.parametrize('num_trials', [0, 5, 19, 20, 33, 60])
def test_tpe_suggestions_equal_the_jax_package(num_trials):
    """Startup phase (< 20 trials: prior draws) and after it (Parzen
    estimators, good/bad split), several draws from one rng each."""
    jt, tt = _trials(jtpe, num_trials, 1), _trials(ttpe, num_trials, 1)
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(4):
        a = jtpe.suggest(_space(jtpe), jt, jrng)
        b = ttpe.suggest(_space(ttpe), tt, trng)
        assert a == b
        assert type(a[0]) is type(b[0]) is int


def test_seed_chain_equals_jax_split_over_1000_seeds():
    split = jax.jit(lambda s: jax.random.split(jax.random.PRNGKey(s))[1][1])
    seed, expected = 0, []
    for _ in range(1000):
        seed = int(split(np.uint32(seed)))
        expected.append(seed)
    got, seed = [], 0
    for _ in range(1000):
        seed = seed_chain.next_seed(seed)
        got.append(seed)
    assert got == expected
    assert max(expected) >= 2 ** 31  # the chain leaves int32's range
    assert expected[:2] == [3453687069, 2692833188]


@pytest.mark.parametrize('seed', [0, 7, 12345, 2 ** 31 + 5, 2 ** 32 - 1, -1])
def test_next_seed_equals_jax_for_python_int_seeds(seed):
    """A user's random_seed goes into PRNGKey as a Python int, negative or
    above int32 included."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    assert seed_chain.next_seed(seed) == int(sub[1])


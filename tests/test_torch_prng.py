"""The port's threefry PRNG (cpflow_tpu_torch/ops/prng.py) and every draw
built on it, against jax.random and the JAX package on the CPU: keys,
splits, bits and uniform draws bit for bit, normal draws within 2e-6 (XLA's
erfinv polynomial against the port's copy of it, a few ulp), the initial
angles of a restart batch and of bucketed trials, the placements, and the
split chains of mynimize and mynimize_repeated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import optimize as jopt
from cpflow_tpu import topology as jtop
from cpflow_tpu.ops.trig import random_angles as j_random_angles
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu_torch import optimize as topt
from cpflow_tpu_torch import topology as ttop
from cpflow_tpu_torch.ops import prng
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.search import seed_chain

torch.set_num_threads(1)

NORMAL_ATOL = 2e-6


def _key(seed):
    return prng.PRNGKey(seed, 'cpu')


@pytest.mark.parametrize('seed', [0, 1, 2 ** 31 - 1, 2 ** 32 - 1, -1, -12345])
def test_prng_key_equals_jax(seed):
    assert _key(seed).tolist() == np.asarray(
        jax.random.PRNGKey(seed)).tolist()
    assert _key(seed).dtype == torch.int64


def test_prng_key_of_a_batch_of_seeds():
    keys = prng.PRNGKey([3, 2 ** 32 + 4, -2], 'cpu')
    assert keys.tolist() == [np.asarray(jax.random.PRNGKey(s)).tolist()
                             for s in (3, 4, -2)]


@pytest.mark.parametrize('num', [2, 5, 1025])
def test_split_equals_jax(num):
    for seed in (0, 7, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.split(_key(seed), num).numpy(),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))


def test_split_of_a_batch_of_keys():
    keys = prng.split(_key(11), 6).reshape(2, 3, 2)
    jkeys = jax.random.split(jax.random.PRNGKey(11), 6)
    got = prng.split(keys, 4)
    assert tuple(got.shape) == (2, 3, 4, 2)
    for i in range(6):
        np.testing.assert_array_equal(got.reshape(6, 4, 2)[i].numpy(),
                                      np.asarray(jax.random.split(jkeys[i], 4)))


def test_split_chain_equals_jax_sequential_splits():
    key = jax.random.PRNGKey(9)
    subs = []
    for _ in range(7):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(sub))
    got, last = prng.split_chain(_key(9), 7)
    np.testing.assert_array_equal(got.numpy(), np.stack(subs))
    np.testing.assert_array_equal(last.numpy(), np.asarray(key))


def test_hash_on_ints_equals_hash_on_tensors_and_the_seed_chain():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2 ** 32, (64, 4), dtype=np.int64)
    t = prng.threefry2x32(*(torch.tensor(words[:, i]) for i in range(4)))
    for row, a, b in zip(words.tolist(), *(x.tolist() for x in t)):
        assert prng.threefry2x32(*row) == (a, b)
    for seed in (0, 5, 2 ** 32 - 1):
        assert seed_chain.next_seed(seed) == int(
            prng.split(_key(seed))[1][1])


@pytest.mark.parametrize('shape', [(1,), (37,), (4, 9), (3, 2, 5)])
def test_random_bits_equal_jax(shape):
    np.testing.assert_array_equal(
        prng.random_bits(_key(13), shape).numpy(),
        np.asarray(jax.random.bits(jax.random.PRNGKey(13), shape)))


@pytest.mark.parametrize('minval,maxval', [(0.0, 1.0), (0.0, 2 * np.pi),
                                           (-3.0, 1.7), (0.25, 0.5)])
def test_uniform_equals_jax(minval, maxval):
    for seed in (0, 21):
        np.testing.assert_array_equal(
            prng.uniform(_key(seed), (50, 41), minval, maxval,
                         dtype=torch.float32).numpy(),
            np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (50, 41),
                                          minval=minval, maxval=maxval)))


def test_uniform_over_a_batch_of_keys_equals_one_draw_per_key():
    keys = prng.split(_key(4), 5)
    got = prng.uniform(keys, (8,), 0.0, 2 * np.pi, dtype=torch.float32)
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(4), 5)):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax.random.uniform(
                k, (8,), minval=0.0, maxval=2 * np.pi)))


def test_normal_within_2e6_of_jax():
    for seed in (0, 3):
        ours = prng.normal(_key(seed), (200_000,), dtype=torch.float32)
        ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                           (200_000,)))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=NORMAL_ATOL)


@pytest.mark.parametrize('threads', [1, 4])
def test_repeated_draws_in_one_process_equal_the_first(threads):
    """The static CCZ's 'normal' batch (seed 0, 1024 x 93) drawn again and
    again in one process, at several intra-op thread counts: every draw
    bit-equal to the first, and the first within 2e-6 of JAX's."""
    mask = _cp_mask()
    ref = np.asarray(jcand.generate_initial_angles_batch(
        jax.random.PRNGKey(0), len(mask), jnp.asarray(mask),
        cp_dist='normal', batch_size=1024))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        draws = [tcand.generate_initial_angles_batch(
            _key(0), len(mask), mask, cp_dist='normal', batch_size=1024)
            for _ in range(8)]
    finally:
        torch.set_num_threads(before)
    np.testing.assert_allclose(draws[0].numpy(), ref, rtol=0,
                               atol=NORMAL_ATOL)
    for i, d in enumerate(draws[1:], 1):
        assert torch.equal(d, draws[0]), (
            f'draw {i} differs from the first at '
            f'{torch.nonzero(d != draws[0])[:6].tolist()}')


def test_float64_draws_equal_jax_with_64_bit_integers_on():
    """In double precision (config.set_precision(True), the JAX package
    with jax_enable_x64) uniform takes JAX's 64-bit recipe, bit for bit;
    normal goes through torch.erfinv, within 1e-13 of JAX's float64
    polynomial."""
    with jax.enable_x64(True):
        jkey = jax.random.PRNGKey(7)
        uni = np.asarray(jax.random.uniform(jkey, (500,), dtype=jnp.float64,
                                            minval=0.0, maxval=2 * np.pi))
        nrm = np.asarray(jax.random.normal(jkey, (500,), dtype=jnp.float64))
    np.testing.assert_array_equal(
        prng.uniform(_key(7), (500,), 0.0, 2 * np.pi,
                     dtype=torch.float64).numpy(), uni)
    np.testing.assert_allclose(
        prng.normal(_key(7), (500,), dtype=torch.float64).numpy(), nrm,
        rtol=0, atol=1e-13)


def test_erfinv_polynomial_against_lax_erf_inv():
    """XLA's float32 polynomial: within 4 ulp of lax.erf_inv everywhere on
    a fine grid of (-1, 1), +-inf at +-1; torch.erfinv is much further off
    in the tails."""
    x = np.linspace(-1, 1, 400_001, dtype=np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    ours = prng.erfinv(torch.tensor(x)).numpy()
    finite = np.isfinite(ref)
    assert not finite[0] and not finite[-1]
    np.testing.assert_array_equal(ours[~finite], ref[~finite])
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=5e-7, atol=0)


@pytest.mark.parametrize('error', [0.0, 5e-4, -2e-3])
def test_erfinv_sqrt_is_correctly_rounded_whatever_torch_sqrt_returns(
        error, monkeypatch):
    """The square root in erfinv's tail equals numpy's float32 sqrt
    (correctly rounded, as XLA's) at every w in [1, 200), also where
    torch.sqrt is off by `error` relative, as MKL's sqrt on the CPU now and
    then is for a whole thread's share of a tensor; and the static CCZ's
    'normal' batch drawn under such a sqrt equals the one drawn without."""
    w = np.random.default_rng(3).uniform(1, 200, 300_000).astype(np.float32)
    mask = _cp_mask()
    clean = tcand.generate_initial_angles_batch(
        _key(0), len(mask), mask, cp_dist='normal', batch_size=1024)
    exact_sqrt = torch.sqrt
    monkeypatch.setattr(torch, 'sqrt', lambda t: exact_sqrt(t) * (1 + error))
    np.testing.assert_array_equal(prng._sqrt(torch.tensor(w)).numpy(),
                                  np.sqrt(w))
    again = tcand.generate_initial_angles_batch(
        _key(0), len(mask), mask, cp_dist='normal', batch_size=1024)
    assert torch.equal(again, clean)


@pytest.mark.parametrize('n', [2, 3, 5, 16, 1700])
def test_permutation_and_choice_equal_jax(n):
    for seed in (0, 8):
        key, jkey = _key(seed), jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            prng.permutation(key, n).numpy(),
            np.asarray(jax.random.permutation(jkey, n)))
        np.testing.assert_array_equal(
            prng.choice(key, n, (2,)).numpy(),
            np.asarray(jax.random.choice(jkey, jnp.arange(n), (2,),
                                         replace=False)))


def test_choice_refuses_what_it_cannot_draw():
    with pytest.raises(NotImplementedError):
        prng.choice(_key(0), 4, (2,), replace=True)
    with pytest.raises(ValueError):
        prng.choice(_key(0), 2, (3,))


def _cp_mask(P=93):
    mask = np.zeros(P, dtype=np.float32)
    mask[9::7] = 1
    return mask


def _held_to_jax(ours, ref, mask, cp_dist):
    """Bit-equal off the CP angles (and on them but for 'normal'), the
    normal CP draws within NORMAL_ATOL."""
    np.testing.assert_array_equal(ours[..., mask == 0], ref[..., mask == 0])
    np.testing.assert_allclose(
        ours, ref, rtol=0, atol=NORMAL_ATOL if cp_dist == 'normal' else 0)


@pytest.mark.parametrize('batch', [1, 17])
@pytest.mark.parametrize('cp_dist', ['uniform', '0', 'normal'])
def test_initial_angles_batch_equals_jax(cp_dist, batch):
    mask = _cp_mask()
    ours = tcand.generate_initial_angles_batch(
        _key(5), len(mask), mask, cp_dist=cp_dist, batch_size=batch)
    assert tuple(ours.shape) == (batch, len(mask))
    ref = np.asarray(jcand.generate_initial_angles_batch(
        jax.random.PRNGKey(5), len(mask), jnp.asarray(mask), cp_dist=cp_dist,
        batch_size=batch))
    _held_to_jax(ours.numpy(), ref, mask, cp_dist)


@pytest.mark.parametrize('cp_dist', ['uniform', '0', 'normal'])
def test_random_cp_angles_equals_jax(cp_dist):
    mask = _cp_mask(40)
    for seed in (0, 77):
        ours = tcand.random_cp_angles(len(mask), mask, cp_dist, _key(seed))
        ref = np.asarray(jcand.random_cp_angles(
            len(mask), jnp.asarray(mask), cp_dist, jax.random.PRNGKey(seed)))
        _held_to_jax(ours.numpy(), ref, mask, cp_dist)


def test_padding_the_batch_keeps_the_first_draws():
    mask = _cp_mask()
    a = tcand.generate_initial_angles_batch(_key(2), len(mask), mask,
                                            batch_size=10)
    b = tcand.generate_initial_angles_batch(_key(2), len(mask), mask,
                                            batch_size=16)
    assert torch.equal(a, b[:10])


def test_bucketed_trials_in_one_draw_equal_one_jax_draw_per_seed():
    mask = _cp_mask()
    seeds = [11, 4_000_000_000, 3]
    ours = tcand.generate_initial_angles_batch(
        prng.PRNGKey(seeds, 'cpu'), len(mask), mask, batch_size=6)
    assert tuple(ours.shape) == (3, 6, len(mask))
    for j, seed in enumerate(seeds):
        ref = jcand.generate_initial_angles_batch(
            jax.random.PRNGKey(jnp.asarray(seed, dtype=jnp.uint32)),
            len(mask), jnp.asarray(mask), batch_size=6)
        np.testing.assert_array_equal(ours[j].numpy(), np.asarray(ref))


@pytest.mark.parametrize('n,gates,seed', [(3, 5, 0), (5, 20, 3), (8, 40, 9)])
def test_random_placements_equal_jax(n, gates, seed):
    ours = ttop.random_placements(n, gates, key=_key(seed))
    ref = jtop.random_placements(n, gates, key=jax.random.PRNGKey(seed))
    assert ours == [[int(q) for q in p] for p in ref]
    assert ttop.random_placement(n, key=_key(seed)) == [
        int(q) for q in jtop.random_placement(n, key=jax.random.PRNGKey(seed))]


def test_mynimize_draw_equals_jax():
    """mynimize draws random_angles(P) from PRNGKey(0), no split."""
    ours = topt._draw(12, None, 'cpu')
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(j_random_angles(12)))
    np.testing.assert_array_equal(
        topt._draw(12, _key(6), 'cpu').numpy(),
        np.asarray(j_random_angles(12, key=jax.random.PRNGKey(6))))


@pytest.mark.parametrize('repeats', [1, 4])
def test_mynimize_repeated_chain_equals_jax(repeats):
    """mynimize_repeated (and so minimize_multistart's batch, and
    Ansatz.learn's) draws one restart per subkey of the chain ``key, sub =
    split(key)`` from PRNGKey(0): its first iterates are the JAX package's,
    bit for bit."""
    P = 5
    loss = lambda a: ((a - 1.0) ** 2).sum()
    ours = topt.mynimize_repeated(loss, P, num_repeats=repeats,
                                  num_iterations=3, device='cpu')
    ref = jopt.mynimize_repeated(lambda a: ((a - 1.0) ** 2).sum(), P,
                                 num_repeats=repeats, num_iterations=3)
    ours = ours if repeats > 1 else [ours]
    ref = ref if repeats > 1 else [ref]
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(o['params'])[0],
                                      np.asarray(r['params'])[0])
        # float32 Adam in two libraries: within 1e-4 after 3 steps, as in
        # tests/test_torch_optimize_api.py
        np.testing.assert_allclose(np.asarray(o['loss']),
                                   np.asarray(r['loss']), atol=1e-4)


@pytest.mark.cuda
def test_draws_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    mask = _cp_mask()
    for cp_dist in ('uniform', 'normal'):
        cpu = tcand.generate_initial_angles_batch(
            _key(0), len(mask), mask, cp_dist=cp_dist, batch_size=1024)
        card = tcand.generate_initial_angles_batch(
            prng.PRNGKey(0, 'cuda'), len(mask), mask, cp_dist=cp_dist,
            batch_size=1024).cpu()
        _held_to_jax(card.numpy(), cpu.numpy(), mask, cp_dist)

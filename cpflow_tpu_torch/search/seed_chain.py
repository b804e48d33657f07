"""The adaptive search's trial seed chain, bit for bit as the JAX package
derives it: each trial's seed is

    int(jax.random.split(jax.random.PRNGKey(seed))[1][1])

of the previous trial's seed (cpflow_tpu/api.py, ``adaptive``). Written
here as threefry2x32 on Python integers, with no JAX, so that the same options give the same
(seed, k, r) stream in both packages and a search saved by the JAX package
resumes in the port.

``PRNGKey(seed)`` with 64-bit integers switched off (the JAX package's
setting) is the key (0, seed mod 2^32). ``split`` is JAX's with
``jax_threefry_partitionable`` on, its default since JAX 0.5: subkey j
hashes the counter pair (0, j) (``_threefry_split_foldlike``). With the
flag off, an older JAX hashes other counters and gives another chain.
"""

from __future__ import annotations

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, d: int) -> int:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: tuple, x: tuple) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pair x under the
    key pair, on Python ints in [0, 2^32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x[0] + ks[0]) & _MASK, (x[1] + ks[1]) & _MASK
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def next_seed(seed: int) -> int:
    """int(jax.random.split(jax.random.PRNGKey(seed))[1][1])."""
    return threefry2x32((0, int(seed) & _MASK), (0, 1))[1]

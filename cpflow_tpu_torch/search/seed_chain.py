"""The adaptive search's trial seed chain, bit for bit as the JAX package
derives it: each trial's seed is

    int(jax.random.split(jax.random.PRNGKey(seed))[1][1])

of the previous trial's seed (cpflow_tpu/api.py, ``adaptive``). It is
ops/prng.py's threefry2x32 on Python integers, with no JAX, so that the
same options give the same (seed, k, r) stream in both packages and a
search saved by the JAX package resumes in the port.

``PRNGKey(seed)`` with 64-bit integers switched off (the JAX package's
setting) is the key (0, seed mod 2^32). ``split`` is JAX's with
``jax_threefry_partitionable`` on, its default since JAX 0.5: subkey j
hashes the counter pair (0, j). With the flag off, an older JAX hashes
other counters and gives another chain.
"""

from __future__ import annotations

from cpflow_tpu_torch.ops.prng import MASK, threefry2x32


def next_seed(seed: int) -> int:
    """int(jax.random.split(jax.random.PRNGKey(seed))[1][1])."""
    return threefry2x32(0, int(seed) & MASK, 0, 1)[1]

"""JAX's threefry PRNG on tensors: the draws of the JAX package, bit for bit
(counterpart of the ``jax.random`` calls that cpflow_tpu makes).

A key is an int64 tensor of shape (..., 2) holding two uint32 words; every
function takes a batch of keys and draws for all of them at once, on the
keys' device. The rules are those of JAX with 64-bit integers off (the JAX
package's setting) and ``jax_threefry_partitionable`` on (its default since
JAX 0.5):

  * ``PRNGKey(seed)`` is (0, seed mod 2^32);
  * ``split(key, num)``: subkey j is threefry2x32(key, (0, j));
  * ``random_bits(key, shape)``: hash[0] ^ hash[1] over the counters
    (0, i), i the flat index into `shape`;
  * ``uniform``: the top 23 bits as a float32 in [1, 2), minus 1, scaled,
    shifted, clamped below at minval;
  * ``normal``: sqrt(2) erfinv(uniform(nextafter(-1, 0), 1)), with XLA's
    float32 erfinv polynomial (``torch.erfinv`` differs by up to ~80 ulp in
    the tails);
  * ``permutation`` / ``choice(replace=False)``: JAX's ``_shuffle``, rounds
    of stable sorts by random bits.

The hash is plain int64 arithmetic on non-negative values below 2^63,
masked to 32 bits wherever a word is read, so it runs as written on Python
ints too (``next_seed`` in search/seed_chain.py, ``split_chain``). On a card,
``graphed`` replays a whole draw from a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpflow_tpu_torch import config

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under the key pair (k0, k1): uint32 words as Python ints or as int64
    tensors (broadcast together).

    Six operations a round: x0 is masked only at the key injections (four
    adds of words below 2^32 stay below 2^35), and x1 << rot, below 2^61,
    holds the rotation in its low 32 bits once its high word is or-ed in;
    the final mask drops the high bits of both."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for rot in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            y = x1 << rot
            x1 = ((y | (y >> 32)) ^ x0) & MASK
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed): the key (0, seed mod 2^32) on `device`
    (the card unless the caller names another); a sequence of N seeds
    gives the batch of their keys, (N, 2)."""
    device = config.resolve_device(device=device)
    words = [[0, int(s) & MASK] for s in np.atleast_1d(seed).tolist()]
    keys = torch.tensor(words, dtype=torch.int64, device=device)
    return keys[0] if np.ndim(seed) == 0 else keys


def _hash(key: torch.Tensor, counters: torch.Tensor):
    """threefry2x32 of every key of the batch (..., 2) with the counters
    (0, c) for c in `counters` (shape S): two (..., *S) int64 tensors."""
    lead = (1,) * counters.dim()
    k0 = key[..., 0].reshape(key.shape[:-1] + lead)
    k1 = key[..., 1].reshape(key.shape[:-1] + lead)
    return threefry2x32(k0, k1, 0, counters)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num) for every key of the batch: (..., 2) ->
    (..., num, 2)."""
    counters = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(_hash(key, counters), dim=-1)


def split_chain(key: torch.Tensor, num: int):
    """The sequential chain ``for _ in range(num): key, sub = split(key)``
    of one key (2,): returns (the subkeys (num, 2), the last key). Each
    step depends on the one before, so the chain is hashed on Python ints
    on the host and the subkeys sent to the key's device at once."""
    k = tuple(int(v) for v in key.tolist())
    subs = []
    for _ in range(num):
        k, sub = (threefry2x32(*k, 0, 0), threefry2x32(*k, 0, 1))
        subs.append(sub)
    return (torch.tensor(subs, dtype=torch.int64,
                         device=key.device).reshape(num, 2),
            torch.tensor(k, dtype=torch.int64, device=key.device))


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _hash_shape(key: torch.Tensor, shape):
    """The hash pair of every key of the batch over the counters (0, i),
    i the flat index into `shape`: two (..., *shape) tensors."""
    counters = torch.arange(math.prod(shape), dtype=torch.int64,
                            device=key.device).reshape(shape)
    return _hash(key, counters)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits (int64 in [0, 2^32)) of the given shape for every
    key of the batch: (..., 2) -> (..., *shape)."""
    h0, h1 = _hash_shape(key, _shape(shape))
    return h0 ^ h1


def uniform(key: torch.Tensor, shape=(), minval=0.0, maxval=1.0,
            dtype=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval) for every key
    of the batch: (..., 2) -> (..., *shape), float32 by default (float64
    takes JAX's 64-bit path: the words of two hashes)."""
    dtype = config.real_dtype if dtype is None else dtype
    shape = _shape(shape)
    if dtype == torch.float32:
        bits = random_bits(key, shape)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32)
    elif dtype == torch.float64:
        hi, lo = _hash_shape(key, shape)
        floats = ((hi << 20) | (lo >> 12) | 0x3FF0000000000000).view(
            torch.float64)
    else:
        raise TypeError(f'uniform draws float32 or float64, not {dtype}')
    # the bounds and their difference in the draw's precision, as Python
    # numbers (no tensor is made here, so a CUDA graph can hold the draw)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    lo = np_dtype(minval)
    scale, lo = float(np_dtype(maxval) - lo), float(lo)
    if dtype == torch.float32 and lo != 0:
        # XLA fuses the scale and the shift into one multiply-add; the
        # float32 product is exact in float64, so this rounds as the fused
        # one does (but for a rare double rounding)
        out = ((floats - 1).double() * scale + lo).float()
    else:
        out = (floats - 1) * scale + lo
    return torch.clamp(out, min=lo)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): a
# polynomial in w - 2.5 for w = -log(1 - x^2) < 5, in sqrt(w) - 3 above
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _polynomial(coefficients, t: torch.Tensor) -> torch.Tensor:
    """c0 t^8 + ... + c8 by Horner's rule, c_i + p t step by step as XLA
    runs it; the coefficients enter as Python numbers (float32 in the
    arithmetic)."""
    p = t * coefficients[0] + coefficients[1]
    for c in coefficients[2:]:
        p = p * t + c
    return p


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """sqrt(w), correctly rounded to w's dtype, as XLA's sqrt is, for w >=
    1 (below that the result is sqrt(1)). torch.sqrt on the CPU goes
    through MKL, which is not correctly rounded and now and then returns a
    whole thread's share of a tensor off by up to ~5e-4 relative; three
    Newton steps in float64 from its result leave an error far below the
    distance of a float32 square root from a rounding midpoint (2^-49), so
    the rounding back is exact whatever the first guess was (to ~2%)."""
    w64 = w.double().clamp(min=1.0)
    s = torch.sqrt(w64)
    for _ in range(3):
        s = 0.5 * (s + w64 / s)
    return s.to(w.dtype)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function as XLA computes it in float32 (the
    polynomial of lax.erf_inv); +-inf at +-1. XLA selects each
    coefficient per element; here both polynomials run on every element
    and one select picks the result, which takes each element through
    XLA's operations (the large one's sqrt only matters where w >= 5)."""
    w = -torch.log1p(-x * x)
    small = _polynomial(_ERFINV_SMALL, w - 2.5)
    large = _polynomial(_ERFINV_LARGE, _sqrt(w) - 3.0)
    p = torch.where(w < 5.0, small, large)
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype=None) -> torch.Tensor:
    """jax.random.normal(key, shape) for every key of the batch. float32
    goes through XLA's erfinv polynomial; float64 through torch.erfinv
    (not JAX's float64 polynomial)."""
    dtype = config.real_dtype if dtype is None else dtype
    single = dtype == torch.float32
    np_dtype = np.float32 if single else np.float64
    lo = float(np.nextafter(np_dtype(-1), np_dtype(0)))
    u = uniform(key, shape, lo, 1.0, dtype=dtype)
    inv = erfinv(u) if single else torch.erfinv(u)
    return inv * float(np_dtype(math.sqrt(2)))


_GRAPH = None  # (tag, graph, key, outputs) of the last draw captured


def graphed(fn, key: torch.Tensor, *args):
    """fn(key, *args), a draw made of the functions above. On a card its
    kernels are captured into a CUDA graph, after one call outside the
    capture, and replayed with the key copied in, for as long as the draws
    keep one (fn, device, key shape, the default real dtype, args): a draw
    is some 450 elementwise kernels of about a microsecond each on the
    card, and launching them one by one costs the host ten times that.
    Another draw replaces the graph. Returns copies of the outputs. On the
    CPU fn runs as it is."""
    global _GRAPH
    if key.device.type != 'cuda':
        return fn(key, *args)
    tag = (fn, key.device, tuple(key.shape), config.real_dtype, args)
    if _GRAPH is None or _GRAPH[0] != tag:
        _GRAPH = None
        with torch.cuda.device(key.device):
            key_in = key.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(key_in, *args)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(key_in, *args)
        _GRAPH = (tag, graph, key_in, out)
    _, graph, key_in, out = _GRAPH
    key_in.copy_(key)
    graph.replay()
    if isinstance(out, tuple):
        return tuple(o.clone() for o in out)
    return out.clone()


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n) for every key of the batch: (..., 2)
    -> (..., n) int64, by JAX's rounds of stable sorts on random bits."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(rounds):
        pair = split(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x


def choice(key: torch.Tensor, n: int, shape=(), replace: bool = False
           ) -> torch.Tensor:
    """jax.random.choice(key, n, shape, replace=False) (without
    replacement: the first prod(shape) entries of the permutation) for
    every key of the batch: (..., 2) -> (..., *shape)."""
    if replace:
        raise NotImplementedError('choice draws without replacement only')
    shape = _shape(shape)
    count = math.prod(shape)
    if count > n:
        raise ValueError(f'cannot take {count} of {n} without replacement')
    return permutation(key, n)[..., :count].reshape(key.shape[:-1] + shape)

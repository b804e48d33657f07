"""Qubit-connectivity layers (counterpart of cpflow_tpu/topology.py).

Plain Python lists; only ``random_placement(s)`` draws, from a threefry
key (ops/prng.py) as the JAX package does: the same key gives the same
pairs.
"""

from __future__ import annotations

from cpflow_tpu_torch.ops import prng


def connected_layer(num_qubits):
    """All-to-all pairs."""
    return [[i, j] for i in range(num_qubits) for j in range(i + 1, num_qubits)]


def chain_layer(num_qubits):
    """Nearest-neighbour chain."""
    return [[i, i + 1] for i in range(num_qubits - 1)]


def star_layer(num_qubits):
    """Star topology centered on qubit 0."""
    return [[0, i] for i in range(1, num_qubits)]


def square_layer(num_qubits=4):
    """Cycle topology."""
    return [[i, (i + 1) % num_qubits] for i in range(num_qubits)]


def kite_layer():
    """4q 'kite': triangle {1,2,3} with tail 0-1."""
    return [[0, 1], [1, 2], [1, 3], [2, 3]]


def fill_layers(layer, depth):
    """Tile `layer` to produce `depth` blocks: full repetitions under 'layers'
    plus the remainder under 'free'."""
    num_complete_layers = depth // len(layer)
    incomplete_layer = layer[:depth % len(layer)]
    return {'layers': [layer, num_complete_layers], 'free': incomplete_layer}


def random_placement(num_qubits, coupling_map=None, key=None):
    """Two distinct qubits, uniformly: jax.random.choice(key,
    arange(num_qubits), (2,), replace=False); key defaults to PRNGKey(0) on
    the CPU (coupling_map is not used, as in the JAX package)."""
    if key is None:
        key = prng.PRNGKey(0, 'cpu')
    return prng.choice(key, num_qubits, (2,)).tolist()


def random_placements(num_qubits, num_gates, coupling_map=None, key=None):
    """num_gates random placements, gate g from subkey g of the chain
    ``key, sub = split(key)`` (one draw for all gates)."""
    if key is None:
        key = prng.PRNGKey(0, 'cpu')
    subkeys = prng.split_chain(key, num_gates)[0]
    return prng.choice(subkeys, num_qubits, (2,)).tolist()


def num_qubits_from_layer(layer):
    """Max index in the coupling map, plus 1."""
    return max(item for sublist in layer for item in sublist) + 1

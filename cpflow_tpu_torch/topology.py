"""Qubit-connectivity layers (counterpart of cpflow_tpu/topology.py).

Plain Python lists; only ``random_placement(s)`` draws, from an explicit
``torch.Generator`` (the same seed gives other pairs than the JAX package).
"""

from __future__ import annotations

import torch


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


def random_placement(num_qubits, coupling_map=None, generator=None):
    """Two distinct qubits, uniformly (coupling_map is not used, as in the
    JAX package)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    i, j = torch.randperm(num_qubits, generator=generator,
                          device=generator.device)[:2].tolist()
    return [i, j]


def random_placements(num_qubits, num_gates, coupling_map=None,
                      generator=None):
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return [random_placement(num_qubits, coupling_map, generator)
            for _ in range(num_gates)]


def num_qubits_from_layer(layer):
    """Max index in the coupling map, plus 1."""
    return max(item for sublist in layer for item in sublist) + 1

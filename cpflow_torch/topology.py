"""Reference cpflow/topology.py surface."""
from cpflow_tpu_torch.topology import (chain_layer,  # noqa: F401
                                       connected_layer, fill_layers,
                                       kite_layer, num_qubits_from_layer,
                                       random_placement, random_placements,
                                       square_layer, star_layer)

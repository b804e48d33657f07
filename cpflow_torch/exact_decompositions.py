"""Reference cpflow/exact_decompositions.py surface."""
from cpflow_tpu_torch.circuits.clifford_t import solovay_kitaev  # noqa: F401
from cpflow_tpu_torch.circuits.passes import (  # noqa: F401
    check_approximation, check_loss, convert_to_zxz, cp_to_cz_circuit,
    rationalize_all_rgates, remove_zero_rgates)
from cpflow_tpu_torch.circuits.refine import reduce_angles, refine  # noqa: F401

# the reference spells the ZXZ pass in caps
convert_to_ZXZ = convert_to_zxz


def gates_count(circuit, gate_names=('cz',)):
    """The reference's gates_count(qc, names) contract on the port's
    circuits."""
    return circuit.gates_count(list(gate_names))


def gates_depth(circuit, gate_names=('cz',)):
    return circuit.gates_depth(list(gate_names))

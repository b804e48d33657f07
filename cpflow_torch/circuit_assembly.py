"""Reference cpflow/circuit_assembly.py surface."""
from cpflow_tpu_torch.sim.apply import apply_gate_to_tensor  # noqa: F401

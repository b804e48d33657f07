"""Reference cpflow/cp_utils.py surface (the reference re-exports the
regularization factory here too; the tutorial imports it from this path)."""
from cpflow_tpu_torch.ops.penalty import (  # noqa: F401
    make_regularization_function)
from cpflow_tpu_torch.optimize.candidates import (  # noqa: F401
    constrained_function, convert_cp_to_cz, evaluate_cp_result,
    filter_cp_results, insert_params, project_cp_angles, random_cp_angles,
    verify_cp_result)

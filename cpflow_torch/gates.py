"""Reference cpflow/gates.py surface (gate matrices + canned targets)."""
from cpflow_tpu_torch.ops.gates import (cp_mat, cx_mat, cz_mat,  # noqa: F401
                                        multi_controlled_sqrt_x,
                                        multi_controlled_x,
                                        multi_controlled_z, rx_mat, ry_mat,
                                        rz_mat, u_ccz3, u_cccz4, u_toff3,
                                        u_toff4, u_toff5, x_mat, y_mat,
                                        z_mat)

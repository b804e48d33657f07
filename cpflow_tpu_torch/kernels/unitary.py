"""The ansatz as a differentiable function of its angles on the card: two
hand-written Hopper kernels under one ``torch.autograd.Function``.

No TPU kernel stands behind them. They replace
cpflow_tpu/sim/batched.py:make_reversible_builder, the ``jax.custom_vjp``
whose backward rewinds the state by unitarity, which XLA fused on the TPU.
Everything that is not Adam on a built-in loss needs the ansatz in this
form: a loss given as a Python callable, a history of the optimization, the
other first-order methods.

  * ``ansatz_forward``: angles (P, B) -> U (B, d, C) complex64, C = 2^n
    columns (``columns=None``) or the |0...0> column alone (``columns=[0]``);
  * ``ansatz_vjp``: angles, that U and its cotangent -> dL/dangles (P, B),
    by the adjoint walk of the sweep kernel: nothing is stored between the
    two but U itself;
  * ``AnsatzUnitary``: the autograd.Function over the pair;
  * ``build_unitary``: the entry point. On a CUDA tensor it goes through
    ``AnsatzUnitary`` or raises (float32 only, sm_90 only, 2 to 8 qubits
    for the whole unitary and 2 to 12 for one column); it never falls back.
    On a CPU tensor it is the plain version,
    sim.batched.build_unitary_batched under ordinary autograd.

Both kernels are csrc/unitary.cu (built with nvcc for sm_90a at first use,
bound with ctypes); they share their device code with the sweep kernel
through csrc/gates.cuh. What bounds them on this card is set out at the top
of csrc/unitary.cu.

The cotangent convention. PyTorch hands a backward the gradient of a real L
with respect to a complex tensor as dL/dRe + i dL/dIm. The kernels' walk
takes the holomorphic partial M = dL/dU (an angle's gradient is
2 Re sum Gbar * dG/dtheta); the two are related by g = conj(2 M), and the
vjp kernel converts as it loads.

Layout. U is (B, d, C) in memory, one contiguous row-major d x C matrix
per restart; ``build_unitary`` hands it on as the batch-last view
(2,)*n + (C, B) of the plain path, and the backward takes a cotangent of
any strides. A kernel's block owns one restart where its layout fits one
block's shared memory; above that (7 and 8 qubits for the whole unitary)
the restart's columns are split over c = 2, 4 or 8 blocks, the smallest
that fits (csrc/unitary.cu's plan, ``cpflow_unitary_cluster``, which
``cluster_plan`` mirrors for checks without a card): the forward
pass's blocks each store their d x C / c columns, the vjp's form a thread
block cluster and sum the gates' cotangents over distributed shared
memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import build
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.sim.batched import build_unitary_batched

FORWARD_LAUNCHES = 0  # launches of the forward kernel since the last reset
VJP_LAUNCHES = 0      # launches of the vjp kernel; the plain path adds none

MAX_QUBITS_UNITARY = 8   # the whole unitary, split over at most 8 blocks
MAX_QUBITS_COLUMN = 12   # one column, on one block
ENTANGLER_CODES = {'cp': 0, 'cz': 1, 'cx': 2}
LETTER_CODES = {'x': 0, 'y': 1, 'z': 2}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
CLUSTERS = (1, 2, 4, 8)  # blocks a restart may run on


def smem_bytes(n: int, num_blocks: int, nba: int, log_c: int, vjp: bool,
               cluster: int = 1) -> int:
    """Dynamic shared memory of each block of a restart split over
    `cluster` blocks, as csrc/unitary.cu's make_layout lays it out: the
    tile of A (2^n x 2^log_c / cluster amplitudes), the gates, the angles
    and the cos and sin of each; the vjp also the tile of M, the gates'
    cotangents, the cross-warp partials and the gradient."""
    log_ct = log_c - (cluster.bit_length() - 1)
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    threads = min(max((1 << (n + log_ct)) // 16, 32), 256)
    out = (8 << (n + log_ct)) + 128 * G + 12 * P
    if vjp:
        out += (8 << (n + log_ct)) + 128 * G + 8 * threads + 4 * P
    return out


def cluster_plan(n: int, num_blocks: int, nba: int, log_c: int,
                 vjp: bool):
    """The blocks each restart's columns are split over, as
    csrc/unitary.cu's cluster_plan picks them: the smallest of 1, 2, 4, 8
    (never more than the 2^log_c columns) whose per-block layout fits one
    block's shared memory; None if none fits."""
    for c in CLUSTERS:
        if c > 1 << log_c:
            break
        if smem_bytes(n, num_blocks, nba, log_c, vjp, c) <= _SMEM_LIMIT:
            return c
    return None


def load_library() -> ctypes.CDLL:
    """Build csrc/unitary.cu (once per version of csrc/) and load it."""
    lib = build.load('unitary')
    if lib.cpflow_unitary_launch.argtypes is None:
        ptr = ctypes.c_void_p
        lib.cpflow_unitary_launch.argtypes = [ptr] * 6 + [ctypes.c_int] * 8 + [
            ptr]
        lib.cpflow_unitary_launch.restype = ctypes.c_int
        lib.cpflow_unitary_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.cpflow_unitary_smem_bytes.restype = ctypes.c_longlong
        lib.cpflow_unitary_cluster.argtypes = [ctypes.c_int] * 5
        lib.cpflow_unitary_cluster.restype = ctypes.c_int
        lib.cpflow_unitary_registers.argtypes = [ptr]
        lib.cpflow_unitary_registers.restype = ctypes.c_int
    return lib


def registers() -> dict:
    """Registers per thread of the two kernels, from the CUDA runtime; the
    vjp's cluster build (7 and 8 qubits) as 'ansatz_vjp_cluster'."""
    out = (ctypes.c_int * 3)()
    err = load_library().cpflow_unitary_registers(out)
    if err != 0:
        raise RuntimeError(f'unitary kernel attribute query failed: CUDA '
                           f'error {err}')
    return {'ansatz_forward': out[0], 'ansatz_vjp': out[1],
            'ansatz_vjp_cluster': out[2]}


@functools.lru_cache(maxsize=64)
def _tables(placements: tuple, rotation_gates: str, device: torch.device):
    """The block placements and rotation letters as int32 tensors on the
    card (never empty, so that each has an address)."""
    plc = torch.tensor([list(p) for p in placements] or [[0, 0]],
                       dtype=torch.int32, device=device).contiguous()
    letters = torch.tensor([LETTER_CODES[c] for c in rotation_gates] or [0],
                           dtype=torch.int32, device=device)
    return plc, letters


class _Shape:
    """The checked shape of one call: what the kernels take, and what they
    refuse."""

    def __init__(self, num_qubits, entangling_gate_name, rotation_gates,
                 placements, angles, columns, vjp):
        n = num_qubits
        if angles.device.type != 'cuda':
            raise ValueError(f'the unitary kernels run on a CUDA tensor, got '
                             f'one on {angles.device}')
        if angles.dtype != torch.float32:
            raise ValueError(f'the unitary kernels compute in float32, got '
                             f'{angles.dtype}')
        major, minor = torch.cuda.get_device_capability(angles.device)
        if (major, minor) != (9, 0):
            raise RuntimeError(
                f'the unitary kernels are built for sm_90a (Hopper); device '
                f'has compute capability {major}.{minor}')
        if columns is not None and list(columns) != [0]:
            raise ValueError(f'the unitary kernels build every column or '
                             f'column 0 alone, got columns={columns!r}')
        limit = MAX_QUBITS_UNITARY if columns is None else MAX_QUBITS_COLUMN
        if not 2 <= n <= limit:
            raise ValueError(
                f'the unitary kernels take 2 to {limit} qubits for '
                f'{"the whole unitary" if columns is None else "one column"}, '
                f'got {n}: above that the state and its cotangent exceed the '
                f'shared memory of {CLUSTERS[-1] if columns is None else 1} '
                f'block(s)')
        if entangling_gate_name not in ENTANGLER_CODES or \
                set(rotation_gates) - set(LETTER_CODES):
            raise ValueError(
                f'unknown template: entangler {entangling_gate_name!r} (cp, '
                f'cz or cx), rotations {rotation_gates!r} (letters of x, y, '
                f'z)')
        self.n = n
        self.ent = ENTANGLER_CODES[entangling_gate_name]
        self.rot = rotation_gates
        self.placements = tuple(tuple(p) for p in all_placements(placements))
        self.nb = len(self.placements)
        self.nba = num_block_angles(entangling_gate_name, rotation_gates)
        self.log_c = n if columns is None else 0
        P = 3 * n + self.nba * self.nb
        if angles.dim() != 2 or angles.shape[0] != P:
            raise ValueError(f'angles must be (P={P}, B), got '
                             f'{tuple(angles.shape)}')
        self.B = angles.shape[1]
        self.udims = (self.B, 1 << n, 1 << self.log_c)
        self.lib = load_library()
        self.cluster = self.lib.cpflow_unitary_cluster(
            n, self.nb, self.nba, self.log_c, int(vjp))
        if not self.cluster:
            most = min(CLUSTERS[-1], 1 << self.log_c)
            nbytes = self.lib.cpflow_unitary_smem_bytes(
                n, self.nb, self.nba, self.log_c, int(vjp), most)
            raise ValueError(
                f'{n} qubits with {self.nb} blocks need {nbytes} bytes of '
                f'shared memory per block even on {most} blocks a restart, '
                f'above {_SMEM_LIMIT}')

    def launch(self, angles, u, ubar, grad, vjp):
        plc, letters = _tables(self.placements, self.rot, angles.device)
        err = self.lib.cpflow_unitary_launch(
            angles.data_ptr(), u.data_ptr(),
            ubar.data_ptr() if ubar is not None else None,
            grad.data_ptr() if grad is not None else None,
            plc.data_ptr(), letters.data_ptr(), self.n, self.nb,
            len(self.rot), self.ent, self.nba, self.log_c, self.B, int(vjp),
            torch.cuda.current_stream(angles.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'unitary kernel launch failed: CUDA error '
                               f'{err} ({self.B} restarts on {self.cluster} '
                               f'blocks each)')


def ansatz_forward(num_qubits: int, entangling_gate_name: str,
                   rotation_gates: str, placements: dict,
                   angles: torch.Tensor, columns=None) -> torch.Tensor:
    """angles (P, B) float32 on the card -> the ansatz unitaries
    (B, d, C) complex64, one contiguous row-major d x C matrix per restart in
    the index order of sim.ansatz_kernel.build_unitary; C = 2^n, or 1 with
    columns=[0]. Launches the forward kernel, or raises."""
    global FORWARD_LAUNCHES
    angles = angles.detach().contiguous()
    shape = _Shape(num_qubits, entangling_gate_name, rotation_gates,
                   placements, angles, columns, vjp=False)
    u = torch.empty(shape.udims, dtype=torch.complex64, device=angles.device)
    if shape.B:
        shape.launch(angles, u, None, None, vjp=False)
        FORWARD_LAUNCHES += 1
    return u


def ansatz_vjp(num_qubits: int, entangling_gate_name: str,
               rotation_gates: str, placements: dict, angles: torch.Tensor,
               u: torch.Tensor, grad_u: torch.Tensor,
               columns=None) -> torch.Tensor:
    """The gradient (P, B) of a real L with respect to the angles, from
    u = ansatz_forward(angles), (B, d, C), and grad_u, (B, d, C): the
    gradient of L with respect to u in PyTorch's convention for complex
    tensors, dL/dRe u + i dL/dIm u. Launches the vjp kernel, or raises."""
    global VJP_LAUNCHES
    angles = angles.detach().contiguous()
    shape = _Shape(num_qubits, entangling_gate_name, rotation_gates,
                   placements, angles, columns, vjp=True)
    for name, t in (('u', u), ('grad_u', grad_u)):
        if tuple(t.shape) != shape.udims or t.dtype != torch.complex64 or \
                t.device != angles.device:
            raise ValueError(f'{name} must be complex64 {shape.udims} on '
                             f'{angles.device}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    u, grad_u = u.contiguous(), grad_u.contiguous()
    grad = torch.empty_like(angles)
    if shape.B:
        shape.launch(angles, u, grad_u, grad, vjp=True)
        VJP_LAUNCHES += 1
    return grad


class AnsatzUnitary(torch.autograd.Function):
    """angles (P, B) -> the batched unitary (2,)*n + (C, B) on the card; the
    backward is the vjp kernel. Only ever applied to the whole (P, B) batch:
    it is not to be vmapped."""

    @staticmethod
    def forward(ctx, angles, num_qubits, entangling_gate_name,
                rotation_gates, placements, columns):
        u = ansatz_forward(num_qubits, entangling_gate_name, rotation_gates,
                           placements, angles, columns)
        ctx.save_for_backward(angles, u)
        ctx.template = (num_qubits, entangling_gate_name, rotation_gates,
                        placements)
        ctx.columns = columns
        return u.permute(1, 2, 0).reshape([2] * num_qubits + [u.shape[2],
                                                              u.shape[0]])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        angles, u = ctx.saved_tensors
        # any strides in; the kernel reads (B, d, C) contiguous
        grad_u = grad_output.reshape(u.shape[1], u.shape[2], u.shape[0]) \
            .permute(2, 0, 1).contiguous()
        grad = ansatz_vjp(*ctx.template, angles, u, grad_u,
                          columns=ctx.columns)
        return grad, None, None, None, None, None


def build_unitary(num_qubits: int, entangling_gate_name: str,
                  rotation_gates: str, placements: dict,
                  angles: torch.Tensor, columns=None,
                  dtype=None) -> torch.Tensor:
    """angles (P, B) -> the batched unitary (2,)*n + (cols, B),
    differentiable in the angles: through the kernels for a CUDA tensor
    (float32 only; it raises otherwise and never falls back), the plain
    sim.batched.build_unitary_batched for a CPU tensor."""
    angles = torch.as_tensor(angles)
    if angles.device.type == 'cpu':
        return build_unitary_batched(num_qubits, entangling_gate_name,
                                     rotation_gates, placements, angles,
                                     columns=columns, dtype=dtype)
    dtype = dtype or config.real_dtype
    if dtype != torch.float32:
        raise ValueError(f'the unitary kernels compute in float32, asked '
                         f'for {dtype}')
    return AnsatzUnitary.apply(angles.to(dtype), num_qubits,
                               entangling_gate_name, rotation_gates,
                               placements, columns)

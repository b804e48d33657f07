"""The differentiable ansatz of the port (kernels/unitary.py) against the
JAX package's make_reversible_builder on the same numpy angles.

On the CPU ``build_unitary`` is the plain builder under autograd: its
unitary and its vector-Jacobian products (a random complex cotangent, fed to
both packages in their own conventions) agree with the JAX custom-vjp
builder within 1e-5 (float32, at most 11 gates). The kernels themselves run
only on a card: those cases are marked ``cuda`` and skip here;
chip_smoke.py phase 12 runs them at the main path's shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, connected_layer, fill_layers

torch.set_num_threads(1)

# (qubits, entangler, rotations, placements, columns)
CASES = {
    '2q-cp-xyz': (2, 'cp', 'xyz', fill_layers(chain_layer(2), 3), None),
    '3q-cp-xz': (3, 'cp', 'xz', fill_layers(chain_layer(3), 5), None),
    '3q-cz-y': (3, 'cz', 'y', fill_layers(connected_layer(3), 4), None),
    '4q-cx-zyx': (4, 'cx', 'zyx', fill_layers(chain_layer(4), 7), None),
    '4q-cp-xyz-column0': (4, 'cp', 'xyz', fill_layers(chain_layer(4), 8),
                          [0]),
    # the largest column layout on the card: two warps a restart
    '6q-cp-xyz': (6, 'cp', 'xyz', fill_layers(connected_layer(6), 5), None),
    # the whole unitary on a cluster of blocks on the card (2 and 8)
    '7q-cp-xyz': (7, 'cp', 'xyz', fill_layers(chain_layer(7), 3), None),
    '8q-cp-xz': (8, 'cp', 'xz', fill_layers(chain_layer(8), 2), None),
}


def _angles(case, B=6, seed=0):
    n, ent, rot, pl, _ = CASES[case]
    P = 3 * n + num_block_angles(ent, rot) * len(all_placements(pl))
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, (P, B)) \
        .astype(np.float32)


@pytest.mark.parametrize('case', sorted(CASES))
def test_build_unitary_on_cpu_matches_the_jax_reversible_builder(case):
    n, ent, rot, pl, cols = CASES[case]
    a = _angles(case)
    rev = jbt.make_reversible_builder(n, ent, rot, pl, columns=cols)
    ju, pull = jax.vjp(rev, jnp.asarray(a))
    before = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
    ta = torch.tensor(a, requires_grad=True)
    tu = uk.build_unitary(n, ent, rot, pl, ta, columns=cols)
    assert tuple(tu.shape) == tuple(ju.shape)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), atol=1e-5)
    # one random cotangent: L = Re sum conj(w) U. JAX pulls back w as it
    # is (its cotangent of a complex output is conjugated once more by the
    # convention of jax.vjp), PyTorch takes dL/dRe + i dL/dIm = w
    rng = np.random.default_rng(1)
    w = (rng.normal(size=ju.shape) + 1j * rng.normal(size=ju.shape)) \
        .astype(np.complex64)
    (jg,) = pull(jnp.asarray(w).conj())
    (tg,) = torch.autograd.grad(tu, ta, grad_outputs=torch.tensor(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5 * max(
        1.0, float(np.abs(np.asarray(jg)).max())))
    # and the gradient of that real L taken by jax.grad agrees
    jl = jax.grad(lambda x: jnp.real(jnp.sum(jnp.asarray(w).conj() *
                                             rev(x))))(jnp.asarray(a))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jl), atol=1e-5 * max(
        1.0, float(np.abs(np.asarray(jl)).max())))
    assert (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES) == before  # plain on CPU


def test_build_unitary_on_cpu_follows_the_dtype():
    n, ent, rot, pl, cols = CASES['3q-cp-xz']
    a = torch.tensor(_angles('3q-cp-xz'))
    u32 = uk.build_unitary(n, ent, rot, pl, a)
    u64 = uk.build_unitary(n, ent, rot, pl, a.double(), dtype=torch.float64)
    assert u32.dtype == torch.complex64 and u64.dtype == torch.complex128
    assert torch.equal(u32, tbt.build_unitary_batched(n, ent, rot, pl, a))
    assert (u64 - u32).abs().max() < 1e-5


def test_the_kernel_wrappers_refuse_a_cpu_tensor_and_never_fall_back():
    n, ent, rot, pl, _ = CASES['3q-cp-xz']
    a = torch.tensor(_angles('3q-cp-xz'))
    with pytest.raises(ValueError, match='CUDA tensor'):
        uk.ansatz_forward(n, ent, rot, pl, a)
    u = torch.zeros((a.shape[1], 8, 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match='CUDA tensor'):
        uk.ansatz_vjp(n, ent, rot, pl, a, u, u)


def test_the_objective_builds_through_the_entry_point(monkeypatch):
    """BatchedRegloss takes its unitary from kernels.unitary.build_unitary
    (which dispatches on the tensor's device) unless made with plain=True."""
    from cpflow_tpu_torch.api import LossSpec
    n, ent, rot, pl, _ = CASES['3q-cp-xz']
    calls = []
    real = uk.build_unitary

    def watched(*args, **kw):
        calls.append(kw.get('columns'))
        return real(*args, **kw)

    monkeypatch.setattr(uk, 'build_unitary', watched)
    a = torch.tensor(_angles('3q-cp-xz'))
    spec = LossSpec('hst', target=np.eye(8))
    routed = tbt.make_batched_regloss(n, ent, rot, pl, spec)
    plain = tbt.make_batched_regloss(n, ent, rot, pl, spec, plain=True)
    assert torch.equal(routed(a)[0], plain(a)[0])
    assert calls == [None] and not routed.plain and plain.plain


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernels_match_the_plain_version_on_card(case):
    """Tolerances as chip_smoke.py phase 12: the unitary within 2e-5, the
    gradient of a random complex cotangent within 1e-4 scaled by
    max(1, |gradient|). The whole unitary at 2 to 6 qubits goes through
    the column design (csrc/columns.cuh), the rest through the row-split
    one."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py phase 12 '
                    'runs this comparison at the main path\'s shapes')
    n, ent, rot, pl, cols = CASES[case]
    a = torch.tensor(_angles(case, B=37), device='cuda')
    before = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES, uk.COLUMN_LAUNCHES)
    ak = a.clone().requires_grad_(True)
    uk_out = uk.build_unitary(n, ent, rot, pl, ak, columns=cols)
    ap = a.clone().requires_grad_(True)
    up = tbt.build_unitary_batched(n, ent, rot, pl, ap, columns=cols)
    assert (uk_out - up).abs().max().item() <= 2e-5
    rng = np.random.default_rng(2)
    w = torch.tensor((rng.normal(size=tuple(up.shape)) + 1j * rng.normal(
        size=tuple(up.shape))).astype(np.complex64), device='cuda')
    (gk,) = torch.autograd.grad(uk_out, ak, grad_outputs=w)
    (gp,) = torch.autograd.grad(up, ap, grad_outputs=w)
    torch.cuda.synchronize()
    assert (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    columns = cols is None and n <= 6
    assert uk.COLUMN_LAUNCHES == before[2] + 2 * columns
    assert ((gk - gp).abs() / gp.abs().clamp(min=1.0)).max().item() <= 1e-4


@pytest.mark.cuda
def test_kernels_refuse_float64_and_too_many_qubits_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card')
    n, ent, rot, pl, _ = CASES['3q-cp-xz']
    a = torch.tensor(_angles('3q-cp-xz'), device='cuda')
    # float64 runs the double build; the vjp of the whole unitary at 8
    # qubits past k = 125 'xyz' blocks (above a block's shared memory even
    # on 16 blocks a restart, which hold k = 2) takes the column tiles, and
    # is refused past k = 297, above a block's shared memory even on 256
    # tiles of one column; any dtype but float32 and float64 is refused
    assert uk.build_unitary(n, ent, rot, pl, a.double(),
                            dtype=torch.float64).dtype == torch.complex128
    with pytest.raises(ValueError, match='float32 or float64'):
        uk.build_unitary(n, ent, rot, pl, a.half(), dtype=torch.float16)
    u8 = torch.zeros((2, 256, 256), dtype=torch.complex128, device='cuda')
    a8 = torch.zeros((24 + 14, 2), dtype=torch.float64, device='cuda')
    before = uk.VJP_LAUNCHES_BY_CLUSTER[16]
    uk.ansatz_vjp(8, 'cp', 'xyz', fill_layers(chain_layer(8), 2), a8, u8, u8)
    assert uk.VJP_LAUNCHES_BY_CLUSTER[16] == before + 1
    a8 = torch.zeros((24 + 7 * 126, 2), dtype=torch.float64, device='cuda')
    before = uk.VJP_LAUNCHES_BY_CLUSTER['tiles']
    uk.ansatz_vjp(8, 'cp', 'xyz', fill_layers(chain_layer(8), 126), a8, u8,
                  u8)
    assert uk.VJP_LAUNCHES_BY_CLUSTER['tiles'] == before + 1
    a8 = torch.zeros((24 + 7 * 298, 2), dtype=torch.float64, device='cuda')
    with pytest.raises(ValueError, match='even on 256 tiles of one column'):
        uk.ansatz_vjp(8, 'cp', 'xyz', fill_layers(chain_layer(8), 298), a8,
                      u8, u8)
    # the whole unitary to 13 qubits in float32: 9 takes the column tiles,
    # 14 is refused before anything is launched
    pl9 = fill_layers(chain_layer(9), 2)
    a9 = torch.zeros((27 + 14, 2), device='cuda')
    assert tuple(uk.build_unitary(9, 'cp', 'xyz', pl9, a9).shape) == \
        (2,) * 9 + (512, 2)
    a14 = torch.zeros((42 + 14, 2), device='cuda')
    with pytest.raises(ValueError, match='2 to 13 qubits'):
        uk.build_unitary(14, 'cp', 'xyz', fill_layers(chain_layer(14), 2),
                         a14)

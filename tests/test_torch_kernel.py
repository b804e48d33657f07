"""The sweep kernel's wrapper (kernels/sweep.py): on a CPU tensor it is the
plain version, it refuses what the kernel does not compute, and on the card
the kernel agrees with the plain version.

This file imports no JAX, so the test that needs the card runs where JAX is
not installed: ``python -m pytest --noconftest tests/test_torch_kernel.py``
(tests/conftest.py configures JAX).
"""

import math

import numpy as np
import pytest
import torch

from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.ops.gates import cz_mat, multi_controlled_x, u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.sim.ansatz_kernel import cp_angle_indices, num_block_angles
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)


def _ghz(n):
    t = np.zeros(2 ** n, dtype=np.complex64)
    t[0] = t[-1] = 2 ** -0.5
    return t


def _problem(n, k, rot, target, r, B, seed, kind='hst', ent='cp',
             wires=None, dtype=None):
    nba = num_block_angles(ent, rot)
    P = 3 * n + nba * k
    rng = np.random.default_rng(seed)
    inits = rng.uniform(0, 2 * np.pi, (B, P)).astype(np.float32)
    spec = LossSpec(kind, target=target) if wires is None else \
        LossSpec(kind, target=target, num_qubits=n, wires=wires)
    pen = {}
    if ent == 'cp':
        cp_mask = np.zeros(P, dtype=np.float32)
        cp_mask[cp_angle_indices(n, nba, k)] = 1
        pen = dict(cp_mask=cp_mask, regularization_func=LinearPenalty(*PEN),
                   r=r)
    # plain=True: called on the card, the objective is the plain version
    obj = make_batched_regloss(n, ent, rot, fill_layers(chain_layer(n), k),
                               spec, dtype=dtype, plain=True, **pen)
    return obj, inits, rng


def test_sweep_on_cpu_tensor_is_the_plain_version():
    obj, inits, _ = _problem(2, 3, 'xyz', cz_mat, 0.002, 4, seed=2)
    p0 = torch.tensor(inits.T.copy())
    before = sk.LAUNCHES
    a = sk.sweep(obj, p0, 0.1, 20)
    b = sk.sweep_reference(obj, p0, 0.1, 20)
    assert sk.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_refuses_what_it_does_not_compute():
    eye = lambda n: np.eye(2 ** n, dtype=np.complex64)
    for obj, limit in [
            (_problem(9, 2, 'xyz', eye(9), 0.0, 1, seed=0)[0], 8),
            (_problem(13, 2, 'xyz', _ghz(13), 0.0, 1, seed=0,
                      kind='state')[0], 12),
            (_problem(9, 2, 'xz', eye(9), 0.0, 1, seed=0,
                      kind='modulo_diagonal', wires=[0, 1])[0], 8)]:
        with pytest.raises(ValueError, match=f'2 to {limit} qubits'):
            sk._check_objective(obj)
    obj, _, _ = _problem(3, 2, 'xyz', u_ccz3, 0.0, 1, seed=0)
    obj.unitary_loss_func = LossSpec('custom', fn=lambda u: 0.0)
    with pytest.raises(NotImplementedError, match='custom'):
        sk._check_objective(obj)
    obj.unitary_loss_func = LossSpec('modulo_identity', target=u_ccz3,
                                     num_qubits=4, wires=[0])
    with pytest.raises(ValueError, match='num_qubits'):
        sk._check_objective(obj)
    obj, _, _ = _problem(3, 2, 'xw', u_ccz3, 0.0, 1, seed=0)
    with pytest.raises(ValueError, match='letters of x, y, z'):
        sk._check_objective(obj)
    # within the limits every loss, entangler and rotation string passes
    sk._check_objective(_problem(12, 2, 'xyz', _ghz(12), 0.0, 1, seed=0,
                                 kind='state')[0])
    for kind in ('hst', 'disc'):
        sk._check_objective(_problem(6, 2, 'xyz', eye(6), 0.0, 1, seed=0,
                                     kind=kind)[0])
    for kind in ('modulo_identity', 'modulo_diagonal'):
        sk._check_objective(_problem(6, 2, 'xz', eye(6), 0.0, 1, seed=0,
                                     kind=kind, wires=[4, 0, 2])[0])
    for ent in ('cp', 'cz', 'cx'):
        for rot in ('', 'z', 'xz', 'zyx', 'xyzx'):
            sk._check_objective(_problem(3, 2, rot, u_ccz3, 0.0, 1, seed=0,
                                         ent=ent)[0])


@pytest.mark.parametrize('kind', ['hst', 'state', 'modulo_diagonal'])
def test_plain_version_in_float64_through_the_objective_dtype(kind):
    """An objective built with dtype float64 runs the plain sweep in float64
    throughout (the arbiter chip_smoke.py uses on deep templates); it agrees
    with the float32 objective to float32 rounding, and the kernel refuses
    it."""
    target = _ghz(3) if kind == 'state' else u_ccz3
    wires = [0, 2] if kind == 'modulo_diagonal' else None
    made = [_problem(3, 4, 'xz', target, 0.002, 5, seed=4, kind=kind,
                     wires=wires, dtype=dt) for dt in (None, torch.float64)]
    (o32, inits, _), (o64, _, _) = made
    p0 = torch.tensor(inits.T.copy())
    a = sk.sweep(o32, p0, 0.1, 3)
    b = sk.sweep(o64, p0, 0.1, 3)
    assert all(x.dtype == torch.float32 for x in a)
    assert all(y.dtype == torch.float64 for y in b)
    scale = max(1.0, b.regloss0.abs().max().item())
    torch.testing.assert_close(a.regloss0.double(), b.regloss0,
                               atol=1e-5 * scale, rtol=0)
    sk._check_objective(o32)
    with pytest.raises(ValueError, match='float32'):
        sk._check_objective(o64)


def test_synthesize_runs_on_the_card_unless_asked_for_the_cpu():
    from cpflow_tpu_torch.api import Synthesize
    from cpflow_tpu_torch.topology import chain_layer
    if torch.cuda.is_available():
        assert Synthesize(chain_layer(3), target_unitary=u_ccz3).device.type \
            == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='cuda'):
            Synthesize(chain_layer(3), target_unitary=u_ccz3)
    assert Synthesize(chain_layer(3), target_unitary=u_ccz3,
                      device='cpu').device.type == 'cpu'


def test_r_per_restart_on_cpu_tensor_equals_separate_sweeps():
    obj, inits, _ = _problem(2, 3, 'xyz', cz_mat, 0.0, 6, seed=5)
    rs = np.array([0.0, 0.0, 0.002, 0.002, 0.01, 0.01], dtype=np.float32)
    obj.r = torch.tensor(rs)
    p0 = torch.tensor(inits.T.copy())
    out = sk.sweep(obj, p0, 0.1, 15)
    for value in (0.0, 0.002, 0.01):
        cols = np.nonzero(rs == np.float32(value))[0]
        one, _, _ = _problem(2, 3, 'xyz', cz_mat, float(np.float32(value)),
                             len(cols), seed=5)
        ref = sk.sweep(one, p0[:, cols], 0.1, 15)
        # float32 rounding only: another batch width reorders the sums
        for x, y in zip(out, ref):
            torch.testing.assert_close(x[..., cols], y, atol=1e-5, rtol=0)


TOFF4 = multi_controlled_x(4)
CARD_CASES = {
    'hst': dict(n=4, k=6, target=TOFF4, kind='hst', r=0.002),
    'hst_r_per_restart': dict(n=4, k=6, target=TOFF4, kind='hst',
                              r='per restart'),
    'state': dict(n=4, k=6, target=_ghz(4), kind='state', r=0.001),
    'state9q_r_per_restart': dict(n=9, k=12, target=_ghz(9), kind='state',
                                  r='per restart'),
    'xz': dict(n=4, k=6, target=TOFF4, kind='hst', r=0.002, rot='xz'),
    'zx_disc': dict(n=3, k=6, target=u_ccz3, kind='disc', r=0.002,
                    rot='zx'),
    'cz_xyz': dict(n=4, k=6, target=TOFF4, kind='hst', r=0.0, ent='cz'),
    'cx_y': dict(n=3, k=6, target=u_ccz3, kind='hst', r=0.0, ent='cx',
                 rot='y'),
    'modulo_identity_02': dict(n=4, k=6, target=TOFF4,
                               kind='modulo_identity', r=0.002,
                               wires=[0, 2]),
    'modulo_diagonal_r_per_restart': dict(n=4, k=6, target=TOFF4,
                                          kind='modulo_diagonal',
                                          r='per restart', rot='xz',
                                          wires=[0, 1, 2, 3]),
    'modulo_diagonal_6q': dict(n=6, k=8, target=multi_controlled_x(6),
                               kind='modulo_diagonal', r=0.002, rot='xz',
                               wires=[5, 1, 3]),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py runs this '
                    'comparison at the main path\'s shapes')
    c = CARD_CASES[case]
    B = 37
    obj, inits, rng = _problem(c['n'], c['k'], c.get('rot', 'xyz'),
                               c['target'],
                               0.0 if c['r'] == 'per restart' else c['r'],
                               B, seed=3, kind=c['kind'],
                               ent=c.get('ent', 'cp'), wires=c.get('wires'))
    if c['r'] == 'per restart':
        obj.r = torch.tensor(rng.choice([0.0, 0.0005, 0.002, 0.01], B),
                             dtype=torch.float32, device='cuda')
    p0 = torch.tensor(inits.T.copy(), device='cuda')
    mask = torch.tensor((rng.uniform(size=p0.shape) > 0.3).astype(np.float32),
                        device='cuda')
    before = sk.LAUNCHES
    out = sk.sweep(obj, p0, 0.1, 20, mask)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    ref = sk.sweep_reference(obj, p0, 0.1, 20, mask)
    # 20 steps: short enough that float32 drift between the two stays
    # small. float32 rounding scales with the loss: the HS-test, state and
    # disc losses lie in [0, 1], the modulo losses at random angles near d
    # (the off-block weight), so the tolerances scale by max(1, |loss|).
    scale = max(1.0, ref.regloss0.abs().max().item())
    torch.testing.assert_close(out.regloss0, ref.regloss0, atol=1e-5 * scale,
                               rtol=0)
    torch.testing.assert_close(out.best_reg, ref.best_reg, atol=1e-4 * scale,
                               rtol=0)
    torch.testing.assert_close(out.best_loss, ref.best_loss,
                               atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
def test_both_kernel_builds_match_plain_version_on_card():
    """The kernel has two builds: the 128-register one runs a batch larger
    than the other build keeps resident on the card at once (here 64
    threads a restart), and agrees with the plain version as the other
    does."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py runs both '
                    'builds at the main path\'s shapes')
    obj, inits, rng = _problem(5, 4, 'xyz', multi_controlled_x(5), 0.002,
                               600, seed=4)
    small, large = sk.occupancy(obj, 37), sk.occupancy(obj, 600)
    assert large['registers'] <= 128 < small['registers']
    assert large['blocks_per_sm'] > small['blocks_per_sm']
    assert 600 > torch.cuda.get_device_properties(0).multi_processor_count \
        * small['blocks_per_sm']
    p0 = torch.tensor(inits.T.copy(), device='cuda')
    out = sk.sweep(obj, p0, 0.1, 20)
    ref = sk.sweep_reference(obj, p0, 0.1, 20)
    torch.testing.assert_close(out.regloss0, ref.regloss0, atol=1e-5, rtol=0)
    # over 600 restarts a few drift apart, as chip_smoke.drift_ok sets out
    import chip_smoke
    for x, y in [(out.best_reg, ref.best_reg), (out.best_loss, ref.best_loss)]:
        assert chip_smoke.drift_ok(chip_smoke.scaled_err(x, y))[0]

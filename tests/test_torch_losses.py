"""The port's losses (ops/losses.py, and the batch-last ones of sim/batched.py)
against cpflow_tpu.ops.losses on seeded random unitaries: the
modulo-identity and modulo-diagonal losses and their parts, disc, and
autograd gradients of the batched losses against jax.grad.

Tolerances: 1e-5 in float32 (a few hundred float32 terms summed in another
order), 1e-10 in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.api import LossSpec as JLossSpec
from cpflow_tpu.ops import losses as jl
from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.kernels.sweep import modulo_tables
from cpflow_tpu_torch.ops import losses as tl
from cpflow_tpu_torch.sim import batched as tbt

torch.set_num_threads(1)

# (num_qubits, wires): all wires and two subsets at 2-4 qubits
CASES = [(2, [0, 1]), (2, [1]), (2, [0]),
         (3, [0, 1, 2]), (3, [0, 2]), (3, [1]),
         (4, [0, 1, 2, 3]), (4, [1, 3]), (4, [2, 0, 3])]
IDS = [f'{n}q-{"".join(map(str, w))}' for n, w in CASES]
KINDS = ['modulo_identity', 'modulo_diagonal']
FUNCS = {'modulo_identity': 'disc_modulo_identity',
         'modulo_diagonal': 'disc_modulo_diagonal'}


def _unitaries(n, count, seed):
    """Haar-like random unitaries (QR of complex Gaussians), complex128."""
    rng = np.random.default_rng(seed)
    d = 2 ** n
    z = rng.normal(size=(count, d, d)) + 1j * rng.normal(size=(count, d, d))
    q, r = np.linalg.qr(z)
    diag = np.diagonal(r, axis1=1, axis2=2)
    return q * (diag / abs(diag))[:, None, :]


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n,wires', CASES, ids=IDS)
def test_modulo_losses_match_jax_in_float64(kind, n, wires):
    t, u = _unitaries(n, 2, seed=n * 10 + len(wires))
    ref = getattr(jl, FUNCS[kind])(t, u, n, wires, xp=np)
    # the numpy twin and the torch version, in float64
    assert abs(getattr(tl, FUNCS[kind])(t, u, n, wires) - ref) <= 1e-10
    got = getattr(tl, FUNCS[kind])(t, torch.tensor(u), n, wires)
    assert got.dtype == torch.float64 and abs(got.item() - ref) <= 1e-10
    # the host loss of a LossSpec
    spec = LossSpec(kind, target=t, num_qubits=n, wires=wires)
    jspec = JLossSpec(kind, target=t, num_qubits=n, wires=wires)
    assert abs(spec.numpy(u) - jspec.numpy(u)) <= 1e-10


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n,wires', CASES, ids=IDS)
def test_modulo_losses_match_jax_in_float32(kind, n, wires):
    t, u = (x.astype(np.complex64) for x in _unitaries(n, 2, seed=7 + n))
    ref = float(getattr(jl, FUNCS[kind])(jnp.asarray(t), jnp.asarray(u), n,
                                         wires))
    got = getattr(tl, FUNCS[kind])(t, torch.tensor(u), n, wires)
    assert got.dtype == torch.float32 and abs(got.item() - ref) <= 1e-5


@pytest.mark.parametrize('n,wires', CASES[3:6], ids=IDS[3:6])
def test_loss_parts_match_jax(n, wires):
    (u,) = _unitaries(n, 1, seed=3)
    assert tl.reorder_wires(wires, n) == jl.reorder_wires(wires, n)
    moved = tl.move_wires_up(u, n, wires)
    np.testing.assert_allclose(moved, jl.move_wires_up(u, n, wires, xp=np),
                               atol=1e-12)
    np.testing.assert_allclose(
        tl.move_wires_up(torch.tensor(u), n, wires).numpy(), moved, atol=1e-12)
    block = n - len(wires)
    np.testing.assert_array_equal(tl._shift_indices(2 ** n, 2 ** block),
                                  jl._shift_indices(2 ** n, 2 ** block))
    for ours, ref in zip(tl.block_diagonal_split(moved, n, block),
                         jl.block_diagonal_split(moved, n, block, xp=np)):
        np.testing.assert_allclose(ours, ref, atol=1e-12)


def test_modulo_losses_vanish_on_their_solutions():
    # u = D @ T^dag with D diagonal: the modulo-diagonal loss is 0 on all
    # wires; u = (I (x) V) @ T^dag: the modulo-identity loss is 0 on wire 0
    (t,) = _unitaries(3, 1, seed=11)
    D = np.diag(np.exp(1j * np.random.default_rng(1).uniform(0, 6, 8)))
    assert abs(tl.disc_modulo_diagonal(t, D @ t.conj().T, 3, [0, 1, 2])) \
        <= 1e-12
    (v,) = _unitaries(2, 1, seed=12)
    u = np.kron(np.eye(2), v) @ t.conj().T
    assert abs(tl.disc_modulo_identity(t, u, 3, [0])) <= 1e-12


@pytest.mark.parametrize('dtype,tol', [(np.complex64, 1e-5),
                                       (np.complex128, 1e-10)])
def test_disc_matches_jax(dtype, tol):
    t, u = (x.astype(dtype) for x in _unitaries(3, 2, seed=5))
    if dtype == np.complex64:
        ref = float(jl.disc(jnp.asarray(u), jnp.asarray(t)))
    else:  # jl.disc runs in jnp: its trace product in float64 numpy
        ref = float(1 - abs(jl.trace_prod(u, t)) / 8)
    assert abs(tl.disc(torch.tensor(u), t).item() - ref) <= tol
    batched = tbt.batched_disc(torch.tensor(u).reshape(2, 2, 2, 8, 1), t)
    assert abs(batched.item() - ref) <= tol


def _batched(us):
    """(count, d, d) -> the batch-last (2,)*n + (d, count) tensor."""
    count, d, _ = us.shape
    n = int(np.log2(d))
    return torch.tensor(np.moveaxis(us, 0, -1).reshape([2] * n + [d, count]))


BATCHED = {'modulo_identity': tbt.batched_modulo_identity,
           'modulo_diagonal': tbt.batched_modulo_diagonal}


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n,wires', [CASES[0], CASES[4], CASES[8]],
                         ids=[IDS[0], IDS[4], IDS[8]])
def test_batched_modulo_losses_match_jax(kind, n, wires):
    us = _unitaries(n, 6, seed=21 + n)
    t = us[0]
    f64 = BATCHED[kind](_batched(us[1:]), t, n, wires)
    ref = [getattr(jl, FUNCS[kind])(t, u, n, wires, xp=np) for u in us[1:]]
    np.testing.assert_allclose(f64.numpy(), ref, rtol=0, atol=1e-10)
    f32 = BATCHED[kind](_batched(us[1:].astype(np.complex64)),
                        t.astype(np.complex64), n, wires)
    jref = jax.vmap(lambda u: getattr(jl, FUNCS[kind])(
        jnp.asarray(t, jnp.complex64), u, n, wires))(
        jnp.asarray(us[1:], jnp.complex64))
    np.testing.assert_allclose(f32.numpy(), np.asarray(jref), rtol=0,
                               atol=1e-5)
    # through the LossSpec dispatch of the objective
    spec = LossSpec(kind, target=t, num_qubits=n, wires=wires)
    np.testing.assert_array_equal(
        tbt.batched_unitary_loss(spec, _batched(us[1:])).numpy(), f64.numpy())


GRAD_LOSSES = {
    'disc': (lambda u, t, n, w: tbt.batched_disc(u, t),
             lambda t, u, n, w: jl.disc(u, t)),
    'modulo_identity': (tbt.batched_modulo_identity, jl.disc_modulo_identity),
    'modulo_diagonal': (tbt.batched_modulo_diagonal, jl.disc_modulo_diagonal),
}


@pytest.mark.parametrize('kind', sorted(GRAD_LOSSES))
@pytest.mark.parametrize('n,wires', [CASES[1], CASES[3], CASES[7]],
                         ids=[IDS[1], IDS[3], IDS[7]])
def test_batched_gradients_match_jax_grad(kind, n, wires):
    """d(sum of the batch's losses) / d(re U, im U), torch autograd of the
    batch-last loss against jax.grad of the JAX package's per-unitary one,
    in float32."""
    ours_fn, jax_fn = GRAD_LOSSES[kind]
    us = _unitaries(n, 5, seed=31 + n).astype(np.complex64)
    t = us[0]
    d = 2 ** n
    re = torch.tensor(us[1:].real.copy(), requires_grad=True)
    im = torch.tensor(us[1:].imag.copy(), requires_grad=True)
    u = torch.complex(re, im)
    u = torch.movedim(u, 0, -1).reshape([2] * n + [d, len(us) - 1])
    ours_fn(u, t, n, wires).sum().backward()

    def total(a, b):
        return jax.vmap(lambda x: jax_fn(jnp.asarray(t), x, n, wires))(
            a + 1j * b).sum()

    gre, gim = jax.grad(total, argnums=(0, 1))(jnp.asarray(us[1:].real),
                                               jnp.asarray(us[1:].imag))
    np.testing.assert_allclose(re.grad.numpy(), np.asarray(gre), atol=1e-5)
    np.testing.assert_allclose(im.grad.numpy(), np.asarray(gim), atol=1e-5)


def _kernel_modulo(v, n, wires, diagonal):
    """numpy transcription of csrc/sweep.cu's modulo_rows, the loss in
    evaluate and modulo_cotangent: (loss, M = dL/dV) from V = U T, with the
    tables the wrapper passes."""
    (perm, perm_inv, shift, shift_inv), lb = modulo_tables(n, wires)
    d = 2 ** n
    at = lambda a, b: v[perm[b], perm[a]]              # v_at
    rows = np.zeros(d, complex)
    for a in range(d):
        base = (a >> lb) << lb
        for j in range(1 << lb):
            b = base + j
            rows[a] += np.conj(at(a, b)) * at(shift[a], shift[b])
    off = sum(abs(v[e >> n, e & (d - 1)]) ** 2 for e in range(d * d)
              if (perm_inv[e & (d - 1)] ^ perm_inv[e >> n]) >> lb)
    S = rows.sum()
    loss = 1 - ((abs(rows) ** 2).sum() if diagonal else abs(S)) / d + off
    c = np.conj(S) / (2 * abs(S) * d) if abs(S) > 0 else 0
    m = np.zeros((d, d), complex)
    for e in range(d * d):
        q, p = e >> n, e & (d - 1)
        ca, rb = perm_inv[p], perm_inv[q]
        if (ca ^ rb) >> lb:
            m[q, p] = np.conj(v[q, p])
            continue
        am = shift_inv[ca]
        vm = np.conj(at(am, shift_inv[rb]))
        vp = np.conj(at(shift[ca], shift[rb]))
        m[q, p] = -((np.conj(rows[am]) * vm + rows[ca] * vp) / d if diagonal
                    else c * vm + np.conj(c) * vp)
    return loss, m


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('n,wires', [CASES[0], CASES[4], CASES[5],
                                     CASES[7]],
                         ids=[IDS[0], IDS[4], IDS[5], IDS[7]])
def test_kernel_modulo_math_matches_autograd(kind, n, wires):
    """The kernel starts its chain at T, so it holds V = U T and pulls back
    M = dL/dV. Its loss must equal the JAX package's, and M T^T must be
    dL/dU: torch's gradient of a real loss in a complex U is 2 conj(dL/dU)
    (float64, 1e-12)."""
    t, u = _unitaries(n, 2, seed=41 + n)
    loss, m = _kernel_modulo(u @ t, n, wires, kind == 'modulo_diagonal')
    assert abs(loss - getattr(jl, FUNCS[kind])(t, u, n, wires, xp=np)) \
        <= 1e-12
    ut = torch.tensor(u, requires_grad=True)
    getattr(tl, FUNCS[kind])(t, ut, n, wires).backward()
    np.testing.assert_allclose(ut.grad.numpy(), 2 * np.conj(m @ t.T),
                               atol=1e-12)


# --- disc2_swap and the Fubini-Study metric ----------------------------------

@pytest.mark.parametrize('n', [2, 3])
def test_permutation_matrices_and_disc2_swap_match_jax(n):
    """The product of HS-test costs over all wire permutations: 1e-5 in
    float32; zero on a wire permutation of the target."""
    t, u = _unitaries(n, 2, seed=40 + n)
    for a, b in zip(tl.permutation_matrices(n), jl.permutation_matrices(n)):
        np.testing.assert_array_equal(a, b)
    u32, t32 = u.astype(np.complex64), t.astype(np.complex64)
    got = tl.disc2_swap(torch.tensor(u32), t32, n)
    want = jl.disc2_swap(jnp.asarray(u32), jnp.asarray(t32), n)
    assert abs(got.item() - float(want)) <= 1e-5
    swapped = tl.permutation_matrices(n)[-1].astype(np.complex128) @ t
    assert abs(tl.disc2_swap(torch.tensor(swapped), t, n).item()) <= 1e-12
    assert tl.disc2_swap(torch.tensor(u), t, n).item() > 1e-3


@pytest.mark.parametrize('rot,k', [('xyz', 2), ('xz', 3)])
def test_fubini_study_matches_jax(rot, k):
    """The (P, P) metric of the ansatz unitary at random angles, 1e-5 in
    float32; symmetric, with a nonnegative diagonal; vmappable over
    restarts (the natural-gradient preconditioner of a batch)."""
    from cpflow_tpu.sim.ansatz_kernel import build_unitary as j_build
    from cpflow_tpu_torch.sim.ansatz_kernel import build_unitary as t_build
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    pl = fill_layers(chain_layer(3), k)
    P = 9 + (2 * len(rot) + 1) * k
    x = np.random.default_rng(7).uniform(0, 2 * np.pi, (P, 3)).astype(
        np.float32)
    ju = lambda a: j_build(3, 'cp', rot, pl, a)
    tu = lambda a: t_build(3, 'cp', rot, pl, a)
    for c in (1.0, 0.5):
        got = tl.fubini_study(tu, torch.tensor(x[:, 0]), relative_coeff=c)
        want = jl.fubini_study(ju, jnp.asarray(x[:, 0]), relative_coeff=c)
        assert tuple(got.shape) == (P, P) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    torch.testing.assert_close(got, got.T, atol=1e-6, rtol=0)
    assert float(got.diagonal().min()) >= -1e-6
    batch = torch.func.vmap(lambda a: tl.fubini_study(tu, a), in_dims=1)(
        torch.tensor(x))
    torch.testing.assert_close(
        batch[2], tl.fubini_study(tu, torch.tensor(x[:, 2])), atol=1e-6,
        rtol=0)

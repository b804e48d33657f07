"""The restart split of the port (parallel/mesh.py, the engine's and the
API's ``sharding`` / ``mesh``) against no split, on the CPU.

Restarts are independent, so a split changes no restart's arithmetic: over
meshes of 2 and 4 CPU entries, in one process or in two gloo processes,
the per-restart regularized losses must equal the unsplit run's within
1e-6 (on this CPU they are bit-equal), and the static and adaptive
pipelines must give the same CZ lists with losses within 1e-6, the
tolerance of the JAX package's tests/test_distributed.py, whose two
pipeline cases are repeated here on the port. padded_batch_size must
equal the JAX function's.

Run as a script, this file is the worker of the two-process test:
``python tests/test_torch_mesh.py <port> <rank>`` joins a process group
of two over gloo on 127.0.0.1 and prints the gathered losses.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cpflow_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

torch.set_num_threads(1)


def _problem():
    """The JAX package's two-process workload (tests/_dist_worker.py):
    Toffoli-3 on the 3q chain, k=4, r=0.001, 8 seeded restarts."""
    from cpflow_tpu_torch.api import LossSpec
    from cpflow_tpu_torch.ops.gates import u_toff3
    from cpflow_tpu_torch.ops.penalty import LinearPenalty
    from cpflow_tpu_torch.sim.ansatz_kernel import (cp_angle_indices,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    n, k, rot = 3, 4, 'xyz'
    nba = num_block_angles('cp', rot)
    P = 3 * n + nba * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, nba, k)] = 1.0
    obj = make_batched_regloss(
        n, 'cp', rot, fill_layers(chain_layer(n), k),
        LossSpec('hst', target=u_toff3), cp_mask=cp_mask,
        regularization_func=LinearPenalty(np.pi / 2, 2.0, .05, .05, .05),
        r=0.001)
    inits = np.random.default_rng(7).uniform(
        0, 2 * np.pi, (8, P)).astype(np.float32)
    return obj, inits


def _regloss_line(regloss):
    return 'REGLOSS ' + ','.join(f'{v:.9e}' for v in
                                 regloss.reshape(-1).tolist())


def _worker(port, rank):
    from cpflow_tpu_torch.optimize import engine
    mesh_lib.distributed_init(f'127.0.0.1:{port}', num_processes=2,
                              process_id=rank)
    mesh = mesh_lib.restart_mesh(['cpu'])
    assert (mesh.rank, mesh.world_size, mesh.size) == (rank, 2, 2)
    obj, inits = _problem()
    raw = engine.minimize_fused(obj, inits, num_iterations=40,
                                sharding=mesh, device='cpu')
    assert raw.regloss.shape == (8, 2)  # every process holds the whole
    print(_regloss_line(raw.regloss), flush=True)
    torch.distributed.destroy_process_group()


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize('samples,size', [(100, 1), (100, 2), (100, 3),
                                          (100, 8), (16, 4), (17, 4),
                                          (1, 8), (1024, 2)])
def test_padded_batch_size_matches_jax(samples, size):
    import jax
    from jax.sharding import Mesh
    from cpflow_tpu.parallel import mesh as jmesh
    jax_mesh = Mesh(np.array(jax.devices()[:size]),
                    axis_names=(jmesh.RESTART_AXIS,))
    mesh = mesh_lib.restart_mesh(['cpu'] * size)
    assert mesh.size == size
    assert mesh_lib.padded_batch_size(samples, mesh) == \
        jmesh.padded_batch_size(samples, jax_mesh)
    assert mesh_lib.padded_batch_size(samples, None) == \
        jmesh.padded_batch_size(samples, None) == samples
    assert mesh_lib.restart_sharding(mesh) is mesh
    assert mesh_lib.RESTART_AXIS == jmesh.RESTART_AXIS


def test_split_and_gather_keep_restart_order():
    mesh = mesh_lib.restart_mesh(['cpu'] * 4)
    x = torch.arange(24.0).reshape(3, 8)
    parts = mesh_lib.split_restarts(x, mesh, dim=1)
    assert [p.tolist() for p in parts] == \
        [x[:, 2 * i:2 * i + 2].tolist() for i in range(4)]
    assert torch.equal(mesh_lib.gather_restarts(parts, mesh, dim=1), x)
    with pytest.raises(ValueError, match='padded_batch_size'):
        mesh_lib.split_restarts(torch.zeros(6, 3), mesh)


def test_no_fallback_without_a_card_or_a_peer():
    """A mesh naming a card, the default mesh and 'auto' on a CUDA device
    raise where no card is visible; a peer that never comes raises."""
    from cpflow_tpu_torch.api import Synthesize
    from cpflow_tpu_torch.ops.gates import cz_mat
    mesh_lib.distributed_init()  # no address: a no-op, as in JAX
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        pytest.skip('a card is visible here')
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh_lib.restart_mesh(['cuda:0'])
    with pytest.raises(RuntimeError, match='CUDA'):
        mesh_lib.restart_mesh()
    with pytest.raises(RuntimeError, match='cuda'):
        Synthesize([[0, 1]], target_unitary=cz_mat)
    assert Synthesize([[0, 1]], target_unitary=cz_mat,
                      device='cpu').mesh is None
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        mesh_lib.distributed_init(f'127.0.0.1:{port}', 2, 1, timeout=2)
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize('size', [2, 4])
@pytest.mark.parametrize('keep_history', [False, True])
def test_minimize_fused_over_a_mesh_matches_no_mesh(size, keep_history):
    from cpflow_tpu_torch.optimize import engine
    obj, inits = _problem()
    T = 12 if keep_history else 40
    mask = (np.random.default_rng(3).uniform(size=inits.shape) > 0.2
            ).astype(np.float32)
    whole = engine.minimize_fused(obj, inits, num_iterations=T,
                                  keep_history=keep_history, grad_mask=mask,
                                  device='cpu')
    split = engine.minimize_fused(obj, inits, num_iterations=T,
                                  keep_history=keep_history, grad_mask=mask,
                                  device='cpu', sharding=mesh_lib.restart_mesh(
                                      ['cpu'] * size))
    assert split.params.shape == whole.params.shape
    torch.testing.assert_close(split.regloss, whole.regloss, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(split.loss, whole.loss, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match='batch'):
        engine.minimize_fused(obj, inits[0], num_iterations=2, device='cpu',
                              sharding=mesh_lib.restart_mesh(['cpu'] * size))


@pytest.mark.parametrize('size', [2, 4])
def test_minimize_fused_over_a_mesh_matches_jax(size):
    """The port's split sweep against the JAX package's minimize_fused
    sharded over `size` of the 8 CPU devices (tests/conftest.py), on the
    same numpy inputs and objective (the penalty of _problem in both):
    float32 Adam over 40 steps in two packages, so per-restart [initial,
    best] regloss and loss within 1e-4, as tests/test_torch_engine.py
    holds the unsplit sweeps."""
    import jax
    import jax.numpy as jnp
    from cpflow_tpu.api import LossSpec as JLossSpec
    from cpflow_tpu.ops.gates import u_toff3
    from cpflow_tpu.ops.penalty import cp_penalty_linear
    from cpflow_tpu.optimize import engine as jengine
    from cpflow_tpu.parallel import mesh as jmesh
    from cpflow_tpu.sim import batched as jbt
    from cpflow_tpu_torch.optimize import engine
    obj, inits = _problem()
    pen = (np.pi / 2, 2.0, .05, .05, .05)
    jobj = jbt.make_batched_regloss(
        3, 'cp', 'xyz', obj.placements, JLossSpec('hst', target=u_toff3),
        cp_mask=jnp.asarray(obj.cp_mask),
        regularization_func=lambda a: cp_penalty_linear(a, *pen), r=0.001,
        reversible=True)
    jax_mesh = jmesh.restart_mesh(jax.devices()[:size])
    want = jengine.minimize_fused(jobj, inits, num_iterations=40,
                                  sharding=jmesh.restart_sharding(jax_mesh))
    got = engine.minimize_fused(obj, inits, num_iterations=40, device='cpu',
                                sharding=mesh_lib.restart_mesh(['cpu'] * size))
    for name in ('regloss', 'loss'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize('size', [2, 4])
@pytest.mark.parametrize('method', ['adam', 'natural gd'])
def test_minimize_multistart_over_a_mesh_matches_no_mesh(size, method):
    """The batched objective's route, with an r per restart that is split
    with the restarts."""
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.optimize import engine
    obj, inits = _problem()
    obj.r = torch.tensor(np.linspace(0.0, 0.004, len(inits)),
                         dtype=torch.float32)
    anz = Ansatz(3, 'cp', obj.placements, 'xyz')
    runs = [engine.minimize_multistart(
        obj, inits, method=method, num_iterations=6, keep_history=True,
        u_func=anz.unitary, device='cpu', sharding=m)
        for m in (None, mesh_lib.restart_mesh(['cpu'] * size))]
    for name in ('params', 'regloss', 'loss', 'reg'):
        torch.testing.assert_close(getattr(runs[1], name),
                                   getattr(runs[0], name), atol=1e-6, rtol=0)


@pytest.mark.parametrize('size', [2, 4])
def test_minimize_multistart_of_a_chain_callable_over_a_mesh(size):
    """The per-chain callable's route: the loss and a per-chain penalty
    vmapped over each shard, one (P,) mask for every chain."""
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.ops.gates import u_toff3
    from cpflow_tpu_torch.ops.losses import cost_HST
    from cpflow_tpu_torch.optimize import engine
    obj, inits = _problem()
    anz = Ansatz(3, 'cp', obj.placements, 'xyz')
    loss = lambda a: cost_HST(anz.unitary(a), u_toff3)  # noqa: E731
    reg = lambda a: 1e-3 * (torch.sin(a) ** 2).sum()  # noqa: E731
    mask = (np.arange(inits.shape[1]) % 3 > 0).astype(np.float32)
    runs = [engine.minimize_multistart(
        loss, inits, num_iterations=5, regularization_func=reg,
        grad_mask=mask, device='cpu', sharding=m)
        for m in (None, mesh_lib.restart_mesh(['cpu'] * size))]
    for name in ('params', 'regloss', 'loss', 'reg'):
        torch.testing.assert_close(getattr(runs[1], name),
                                   getattr(runs[0], name), atol=1e-6, rtol=0)


# -------------------------------------------------------------- pipelines


def _cz_and_losses(res):
    return sorted((d.cz_count, float(d.loss)) for d in res.decompositions)


def test_static_pipeline_mesh_equality():
    """tests/test_distributed.py's static case on the port: the same seed
    on no mesh and on a mesh of 4 CPU entries gives the same decomposition
    set (CZ counts equal, losses within 1e-6). 16 samples are a multiple
    of 4, so padded_batch_size changes nothing."""
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.ops import gates
    opts = StaticOptions(num_cp_gates=2, accepted_num_cz_gates=3,
                         num_samples=16, num_gd_iterations=400,
                         rotation_gates='xz', random_seed=7,
                         num_gd_iterations_at_verification=1500)
    runs, sizes = {}, {}
    for name, mesh in (('single', None),
                       ('mesh4', mesh_lib.restart_mesh(['cpu'] * 4))):
        s = Synthesize([[0, 1]], target_unitary=gates.cz_mat,
                       label=f'eq_{name}', device='cpu', mesh=mesh)
        res = s.static(opts, save_results=False, verbose=False)
        runs[name], sizes[name] = _cz_and_losses(res), res.mesh_size
    assert sizes == {'single': 1, 'mesh4': 4}
    assert len(runs['single']) > 0
    assert [c for c, _ in runs['single']] == [c for c, _ in runs['mesh4']]
    for (_, l1), (_, l2) in zip(runs['single'], runs['mesh4']):
        assert abs(l1 - l2) <= 1e-6


@pytest.mark.parametrize('bucketed', [False, True])
def test_adaptive_pipeline_mesh_equality(bucketed):
    """tests/test_distributed.py's adaptive case on the port (3 evals),
    and its bucketed form with 2 parallel trials (their r and masks per
    restart, split with the restarts): the same CZ lists, losses within
    1e-6, and the same trial scores (normalised by num_samples)."""
    import pickle
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.ops import gates
    opts = AdaptiveOptions(min_num_cp_gates=1, max_num_cp_gates=3,
                           num_samples=16, num_gd_iterations=300,
                           rotation_gates='xz', random_seed=5, max_evals=3,
                           num_gd_iterations_at_verification=1200,
                           bucketed=bucketed,
                           parallel_trials=2 if bucketed else 1)
    runs, scores = {}, {}
    for name, mesh in (('single', None),
                       ('mesh4', mesh_lib.restart_mesh(['cpu'] * 4))):
        s = Synthesize([[0, 1]], target_unitary=gates.cz_mat,
                       label=f'eqa_{name}', device='cpu', mesh=mesh)
        res = s.adaptive(opts, save_results=False, verbose=False)
        runs[name] = _cz_and_losses(res)
        scores[name] = [r['loss'] for r in res.trials.results]
        assert pickle.loads(pickle.dumps(s)).mesh is None
    assert [c for c, _ in runs['single']] == [c for c, _ in runs['mesh4']]
    for (_, l1), (_, l2) in zip(runs['single'], runs['mesh4']):
        assert abs(l1 - l2) <= 1e-6
    assert scores['single'] == scores['mesh4']


def test_padded_batch_is_drawn_whole_and_scored_per_sample():
    """With 10 samples over a mesh of 4 the sweep runs 12 restarts, drawn
    as one batch; the trial's score stays normalised by num_samples."""
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.ops import gates
    from cpflow_tpu_torch.optimize import candidates as cand
    seen = []
    real = cand.run_raw_stage_fused

    def watched(*args, **kw):
        out = real(*args, **kw)
        seen.append(len(out.cz))
        return out

    opts = AdaptiveOptions(min_num_cp_gates=1, max_num_cp_gates=2,
                           num_samples=10, num_gd_iterations=100,
                           rotation_gates='xz', random_seed=5, max_evals=1,
                           num_gd_iterations_at_verification=200)
    s = Synthesize([[0, 1]], target_unitary=gates.cz_mat, device='cpu',
                   mesh=mesh_lib.restart_mesh(['cpu'] * 4))
    cand.run_raw_stage_fused = watched
    try:
        res = s.adaptive(opts, save_results=False, verbose=False)
    finally:
        cand.run_raw_stage_fused = real
    assert seen == [12]
    result = res.trials.results[0]
    if result['cz_counts']:
        want = -np.log2(np.sum(2.0 ** -np.array(result['cz_counts'],
                                                dtype=np.float64)) / 10)
        assert result['loss'] == pytest.approx(want, abs=1e-12)


# ------------------------------------------------------------ two processes


def test_two_processes_match_one_process():
    """Two gloo processes, one shard each, hold the whole gathered result,
    equal to one process without a split (regloss within 1e-6)."""
    from cpflow_tpu_torch.optimize import engine
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), '\n---\n'.join(outs)
    obj, inits = _problem()
    single = engine.minimize_fused(obj, inits, num_iterations=40,
                                   device='cpu')
    want = np.array(single.regloss.reshape(-1).tolist())
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith('REGLOSS ')]
        assert line, out
        got = np.array([float(v) for v in line[0][8:].split(',')])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pairs = want.reshape(8, 2)
    assert (pairs[:, 1] <= pairs[:, 0]).all()


if __name__ == '__main__':
    _worker(int(sys.argv[1]), int(sys.argv[2]))

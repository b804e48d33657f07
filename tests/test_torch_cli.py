"""The port's command line (python -m cpflow_tpu_torch) against the JAX
package's (python -m cpflow_tpu), on the CPU: the same flags give JSON
with the same keys, and on the 2q CZ target the same least CZ count (1)
with a host loss <= 1e-6 in each (the verification target). The named
targets are the JAX CLI's matrices exactly; a --qasm target, --refine,
info and an unknown target are checked on the port."""

import json

import numpy as np
import pytest
import torch

from cpflow_tpu_torch import __main__ as cli

torch.set_num_threads(1)

CZ_ARGS = ['synthesize', '--target', 'cz', '--layer', 'chain', '--static',
           '--num-cp-gates', '2', '--accepted-cz', '1', '--num-samples',
           '16', '--no-save']


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _best(out):
    least = min(d['cz_count'] for d in out['decompositions'])
    return least, min(d['loss'] for d in out['decompositions']
                      if d['cz_count'] == least)


def test_synthesize_matches_the_jax_cli(capsys):
    from cpflow_tpu.__main__ import main as jax_main
    cli.main(CZ_ARGS + ['--device', 'cpu'])
    ours = _last_json(capsys)
    jax_main(CZ_ARGS)
    theirs = _last_json(capsys)
    assert set(ours) == set(theirs) == {'label', 'decompositions'}
    assert ours['label'] == theirs['label'] == 'cz'
    assert ours['decompositions'] and theirs['decompositions']
    assert {frozenset(d) for d in ours['decompositions']} == \
        {frozenset(d) for d in theirs['decompositions']}
    least, loss = _best(ours)
    jax_least, jax_loss = _best(theirs)
    assert least == jax_least == 1
    assert loss <= 1e-6 and jax_loss <= 1e-6


def test_qasm_target_and_refine(tmp_path, capsys):
    """A CZ written as H CX H in a QASM file, synthesized and refined: one
    CZ, each refined decomposition at host loss <= 1e-6 of a known type
    (with a T count where it reached Clifford+T)."""
    path = tmp_path / 'cz.qasm'
    path.write_text('OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[2];\n'
                    'h q[1];\ncx q[0],q[1];\nh q[1];\n')
    cli.main(['synthesize', '--qasm', str(path), '--static',
              '--num-cp-gates', '2', '--accepted-cz', '1', '--num-samples',
              '8', '--refine', '--no-save', '--device', 'cpu'])
    out = _last_json(capsys)
    assert out['label'] == 'qasm' and out['decompositions']
    for d in out['decompositions']:
        assert d['cz_count'] == 1 and d['loss'] <= 1e-6
        assert d['type'] in ('Approximate', 'Rational', 'Clifford+T')
        assert (d['t_count'] is None) == (d['type'] != 'Clifford+T')
    assert any(d['type'] != 'Approximate' for d in out['decompositions'])


def test_info_names_versions_cards_and_kernel_build(capsys):
    import cpflow_tpu_torch
    from cpflow_tpu_torch.kernels import build
    cli.main(['info'])
    out = _last_json(capsys)
    assert out['version'] == cpflow_tpu_torch.__version__
    assert out['torch'] == torch.__version__
    assert out['cuda'] == torch.version.cuda
    assert len(out['devices']) == (torch.cuda.device_count()
                                   if torch.cuda.is_available() else 0)
    assert out['kernel_source_digest'] == build.digest()
    assert out['kernel_build_dir'] == str(build.BUILD_DIR)
    assert 'backend' not in out


@pytest.mark.parametrize('argv', [
    ['synthesize', '--target', 'toff9', '--static', '--num-cp-gates', '2'],
    ['synthesize', '--target', 'cz', '--layer', 'ring', '--static',
     '--num-cp-gates', '2'],
    ['synthesize', '--target', 'cz', '--static']])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        cli.main(argv + ['--device', 'cpu'])


def test_named_targets_are_the_jax_cli_s():
    from types import SimpleNamespace
    from cpflow_tpu import __main__ as jax_cli
    names = ['cz', 'toff3', 'toff4', 'toff5', 'ccz', 'cccz', 'ccccz']
    assert sorted(cli._named_targets()) == sorted(names)
    for name in names:
        args = SimpleNamespace(qasm=None, target=name)
        ours, n = cli._target_from_args(args)
        theirs, jn = jax_cli._target_from_args(args)
        assert n == jn
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))

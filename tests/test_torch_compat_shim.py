"""cpflow_torch, the port's counterpart of the ``cpflow`` compatibility
package: every module of ``cpflow`` has a twin exporting exactly its public
names, the reference paper notebook's import block runs against it, the
gates_count / gates_depth contract holds on the port's circuits, and a
reference-style static run from the seed draws the batch that ``cpflow``
draws, bit for bit."""

import importlib
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

MODULES = ['', 'circuit_assembly', 'cp_utils', 'exact_decompositions',
           'gates', 'main', 'matrix_utils', 'optimization', 'penalty',
           'topology', 'trigonometric_utils']


def _public(module):
    names = {n for n in dir(module) if not n.startswith('_') and
             not isinstance(getattr(module, n), types.ModuleType)}
    return names | ({'__version__'} if hasattr(module, '__version__')
                    else set())


@pytest.mark.parametrize('name', MODULES)
def test_module_exports_the_names_of_its_cpflow_twin(name):
    suffix = f'.{name}' if name else ''
    ours = importlib.import_module('cpflow_torch' + suffix)
    ref = importlib.import_module('cpflow' + suffix)
    assert _public(ours) == _public(ref)
    for n in _public(ours) - {'__version__'}:
        home = getattr(getattr(ours, n), '__module__', None)
        if home is not None:  # functions and classes; gate matrices have none
            assert home.split('.')[0] in ('cpflow_tpu_torch', 'cpflow_torch')


def test_peppar_import_block():
    # the import lines of tests/test_compat_shim.py (the reference paper
    # notebook's), with cpflow replaced by cpflow_torch
    import cpflow_torch
    from cpflow_torch import (Ansatz, AdaptiveOptions, Decomposition,  # noqa: F401
                              Results, StaticOptions, Synthesize)
    from cpflow_torch.exact_decompositions import (  # noqa: F401
        rationalize_all_rgates, reduce_angles, remove_zero_rgates)
    from cpflow_torch.gates import u_toff3, u_toff4, u_toff5  # noqa: F401
    from cpflow_torch.main import RegularizationOptions  # noqa: F401
    from cpflow_torch.matrix_utils import (cost_HST,  # noqa: F401
                                           disc_modulo_diagonal,
                                           theoretical_lower_bound)
    from cpflow_torch.penalty import make_regularization_function  # noqa: F401
    from cpflow_torch.topology import (chain_layer,  # noqa: F401
                                       connected_layer, fill_layers)
    from cpflow_torch.trigonometric_utils import (bracket_angle,  # noqa: F401
                                                  random_angles)
    from cpflow_torch.cp_utils import make_regularization_function as mrf  # noqa: F401
    from cpflow_torch.optimization import mynimize, mynimize_repeated  # noqa: F401
    from cpflow_torch.circuit_assembly import apply_gate_to_tensor  # noqa: F401
    from cpflow_torch.exact_decompositions import convert_to_ZXZ  # noqa: F401

    import cpflow_tpu_torch.api
    assert cpflow_torch.Synthesize is Synthesize is \
        cpflow_tpu_torch.api.Synthesize
    assert u_toff3.shape == (8, 8)


def test_gates_count_depth_contract():
    from cpflow_torch.exact_decompositions import gates_count, gates_depth
    from cpflow_tpu_torch.circuits.ir import Circuit

    c = Circuit(2)
    c.cz(0, 1).rz(0.3, 0).cz(0, 1)
    assert gates_count(c) == 2
    assert gates_depth(c, ('cz',)) == 2
    c.cz(0, 1).rz(0.1, 1).cx(1, 0)
    assert gates_count(c) == 3 and gates_count(c, ('cz', 'cx')) == 4
    assert gates_depth(c) == 3


def test_reference_style_static_run_draws_cpflows_batch(monkeypatch):
    """The reference README's CCZ call, cut to 16 samples and 60 steps, in
    both surfaces from the default seed: the port's drawn batch equals
    cpflow's bit for bit, the sampling losses agree within 1e-4 and both
    return the same CZ counts."""
    import cpflow
    import cpflow_torch
    from cpflow.gates import u_ccz3
    from cpflow.topology import chain_layer
    from cpflow_tpu.optimize import candidates as jcand
    from cpflow_tpu_torch.optimize import candidates as tcand

    kw = dict(num_cp_gates=12, num_samples=16, accepted_num_cz_gates=8,
              num_gd_iterations=60, num_gd_iterations_at_verification=200)
    jsynth = cpflow.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                               label='shim', mesh=None)
    jstages = []
    jstage = jsynth._raw_and_evaluate
    monkeypatch.setattr(jsynth, '_raw_and_evaluate',
                        lambda o: jstages.append(jstage(o)) or jstages[-1])
    joptions = cpflow.StaticOptions(**kw)
    jres = jsynth.static(joptions, save_results=False, verbose=False)
    janz = jsynth._ansatz(joptions)
    jdraw = np.asarray(jcand.generate_initial_angles_batch(
        jax.random.PRNGKey(joptions.random_seed), janz.num_angles,
        janz.cp_mask, batch_size=16))

    drawn, stages = [], []
    draw, stage = tcand.generate_initial_angles_batch, \
        tcand.run_raw_stage_fused
    monkeypatch.setattr(tcand, 'generate_initial_angles_batch',
                        lambda *a, **k: drawn.append(draw(*a, **k))
                        or drawn[-1])
    monkeypatch.setattr(tcand, 'run_raw_stage_fused',
                        lambda *a, **k: stages.append(stage(*a, **k))
                        or stages[-1])
    synth = cpflow_torch.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                    label='shim', device='cpu')
    res = synth.static(cpflow_torch.StaticOptions(**kw), save_results=False,
                       verbose=False)
    assert len(drawn) == 1 and len(stages) == len(jstages) == 1
    np.testing.assert_array_equal(drawn[0].numpy(), jdraw)
    np.testing.assert_allclose(stages[0].loss, jstages[0].loss, atol=1e-4)
    assert sorted(d.cz_count for d in res.decompositions) == \
        sorted(d.cz_count for d in jres.decompositions)

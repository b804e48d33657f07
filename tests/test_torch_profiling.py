"""utils/profiling.py of the port: the kernels' work and bounds (the
numbers PERF.md's kernel table records), the roofline model, Throughput
against cpflow_tpu.utils.profiling.Throughput on one clock, where each
section synchronises, and a torch.profiler trace written on the CPU.
Integer counts are exact; times within 1e-12 relative; Throughput's
fields and report equal to the JAX package's."""

import json
import os
import types

import pytest
import torch

from cpflow_tpu.utils import profiling as jprof
from cpflow_tpu_torch.utils import profiling as prof


@pytest.mark.parametrize('n,nb,rot,needed', [
    (3, 12, 'xyz', 110_841),       # the static CCZ shape
    (5, 20, 'xyz', 2_560_159),     # the 5q Toffoli k=20 shape
    (7, 144, 'xyz', 288_592_545),  # the Toffoli-7 composite's template
])
def test_sweep_work_matches_the_recorded_counts(n, nb, rot, needed):
    work = prof.sweep_work(n, nb, rot)
    assert work['needed'] == needed
    assert work['executed'] >= work['needed']
    assert work['P'] == 3 * n + 7 * nb and work['target'] == 4 ** n


def test_bound_of_the_static_shape():
    """3q k=12, B=1024, T=2000: 3.388 ms by the operations (PERF.md)."""
    ms, by = prof.bound_ms(prof.sweep_work(3, 12), 1024, 2000)
    assert by == 'operations'
    assert ms == pytest.approx(110_841 * 1024 * 2000 / 67e12 * 1e3,
                               rel=1e-12)
    assert round(ms, 3) == 3.388
    # one step of one restart moves more bytes than it computes
    assert prof.bound_ms(prof.sweep_work(3, 12), 1, 0)[1] == 'bytes'


def test_unitary_work_at_the_3q_row():
    w = prof.unitary_work(3, 12)
    assert (w['P'], w['amps'], w['forward'], w['vjp']) == \
        (93, 64, 28_167, 84_990)
    assert (w['forward_bytes'], w['vjp_bytes']) == (4 * 93 + 8 * 64,
                                                    8 * 93 + 16 * 64)
    ms, by = prof.unitary_bound_ms(w['forward'], w['forward_bytes'], 1024)
    assert by == 'operations' and round(ms, 5) == 0.00043
    ms, by = prof.unitary_bound_ms(w['vjp'], w['vjp_bytes'], 1024)
    assert by == 'operations' and round(ms, 5) == 0.0013
    assert prof.unitary_work(10, 36, log_c=0)['amps'] == 2 ** 10


@pytest.mark.parametrize('n,nb,log_c', [(3, 12, None), (20, 19, 0),
                                         (24, 2, 0), (9, 10, None)])
def test_surface_round_counts_as_product_and_contraction(n, nb, log_c):
    """Neither pass counts the surface round as n gate passes: the forward
    pass writes the product state (6 an amplitude) and the vjp contracts M
    with it (16 an amplitude), whatever n; each block costs 30 and 92 an
    amplitude. The gates' part alone is what both passes build."""
    w = prof.unitary_work(n, nb, log_c=log_c)
    more = prof.unitary_work(n, nb + 1, log_c=log_c)
    amps = w['amps']
    assert more['forward'] - w['forward'] == \
        30 * amps + more['gates'] - w['gates']
    assert w['forward'] == 6 * amps + 30 * nb * amps + w['gates']
    rest = w['vjp'] - w['gates'] - amps * (92 * nb + 2)
    assert rest - 16 * amps == 161 * n + (368 + 102 * 2 + 6 + 85) * nb
    assert w['gates'] == 3 * w['P'] + 112 * n + (112 * 2 + 96 + 24) * nb


@pytest.mark.parametrize('kind', ['hst', 'state', 'disc'])
@pytest.mark.parametrize('n,nb', [(3, 12), (5, 20), (14, 28)])
def test_sweep_counts_the_surface_round_as_the_unitary_kernels_do(
        n, nb, kind):
    """The sweep's needed operations count the surface round as the
    unitary kernels' bounds do (22 an amplitude: the product state and the
    contraction); its executed ones count the kernel's n gate passes and n
    adjoint steps (58 n an amplitude), as its loops run them."""
    w = prof.sweep_work(n, nb, kind=kind)
    amps = w['target']
    beyond = 112 * 2 * nb + 44 * w['P'] - 22 * nb
    assert w['executed'] - w['needed'] == (58 * n - 22) * amps + beyond
    per_block = prof.sweep_work(n, nb + 1, kind=kind)['needed'] - w['needed']
    assert per_block == 122 * amps + 214 * 2 + 464 + 6 + 109 + 18 * 7 + 22


def test_roofline_model():
    m = prof.roofline_model(3, 12)
    w = prof.sweep_work(3, 12)
    assert (m['flops'], m['executed_flops'], m['num_angles']) == \
        (w['needed'], w['executed'], 93)
    assert m['bound_ms_per_restart_iteration'] * 1024 * 2000 == \
        pytest.approx(prof.bound_ms(w, 1024, 2000)[0], rel=1e-12)
    assert m['hbm_bytes'] == 4 * (3 * 93 + 5) + 4 * 93 + 8 * 64
    state = prof.roofline_model(10, 36, kind='state')
    assert state['flops'] == prof.sweep_work(10, 36, kind='state')['needed']
    modulo = prof.roofline_model(4, 12, kind='modulo_diagonal')
    assert modulo['flops'] == prof.sweep_work(
        4, 12, kind='modulo_diagonal', num_wires=4)['needed']
    with pytest.raises(ValueError, match='reversibly'):
        prof.roofline_model(3, 12, reversible=False)


def test_h100_rates():
    assert (prof.PEAK_F32, prof.PEAK_BYTES) == (67e12, 3.35e12)


def test_throughput_arithmetic(monkeypatch):
    clock = iter([10.0, 12.0, 20.0, 20.5])
    monkeypatch.setattr(prof.time, 'perf_counter', lambda: next(clock))
    t = prof.Throughput()
    with t.section(100, 50, label='a', device='cpu'):
        pass
    with t.section(10, 10, label='b'):
        pass
    assert t.restart_iterations == 5100.0
    assert t.seconds == 2.5
    assert t.rate == 5100.0 / 2.5
    assert [s['rate'] for s in t.sections] == [2500.0, 200.0]
    report = t.report().splitlines()
    assert report[0].startswith('total: 5.1e+03 restart-iters in 2.50s')
    assert '[a]' in report[1] and '[b]' in report[2]
    assert prof.Throughput().rate == 0.0


@pytest.mark.parametrize('sections,ticks', [
    ([(100, 50, 'a'), (10, 10, 'b')], [10.0, 12.0, 20.0, 20.5]),
    ([(1024, 2000, 'sampling'), (64, 5000, 'verify'), (3, 7, '')],
     [0.0, 0.109, 1.0, 1.25, 2.0, 2.0]),     # the last section takes 0 s
    ([], []),
])
def test_throughput_matches_jax(monkeypatch, sections, ticks):
    """The port's Throughput and the JAX package's, run through the same
    sections on one clock (the JAX one reads time.time, the port's
    time.perf_counter), hold the same fields and print the same report."""
    out = []
    for mod, name in ((prof, 'perf_counter'), (jprof, 'time')):
        clock = iter(ticks)
        monkeypatch.setattr(mod, 'time', types.SimpleNamespace(
            **{name: lambda: next(clock)}))
        t = mod.Throughput()
        for restarts, iters, label in sections:
            with t.section(restarts, iters, label=label):
                pass
        out.append(t)
    port, jax_t = out
    assert port.restart_iterations == jax_t.restart_iterations
    assert port.seconds == jax_t.seconds
    assert port.sections == jax_t.sections
    assert port.rate == jax_t.rate
    assert port.report() == jax_t.report()


@pytest.mark.parametrize('device,initialized,want', [
    (None, True, [None]),        # the current CUDA device, CUDA in use
    (None, False, []),           # CUDA not in use in this process
    ('cpu', True, []),
    ('cuda:1', True, [torch.device('cuda:1')]),
])
def test_section_synchronises_the_card(monkeypatch, device, initialized,
                                       want):
    """A section waits for the card at both ends: the device it is given,
    or with none the current CUDA device where CUDA is in use."""
    synced = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: initialized)
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda d=None: synced.append(
                            None if d is None else torch.device(d)))
    t = prof.Throughput()
    with t.section(4, 5, device=device):
        assert synced == want
    assert synced == want * 2


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / 'trace'
    with prof.trace(str(logdir)):
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = logdir / 'trace.json'
    assert os.path.getsize(path) > 0
    events = json.loads(path.read_text())['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)


def test_float64_peak_and_bytes():
    """The double builds' bound divides by the H100's float64 rate outside
    the tensor cores (34 TFLOP/s, half the float32 rate) and counts 8-byte
    reals and 16-byte amplitudes."""
    assert prof.PEAK_F64 == 34e12 and prof.PEAK_F64 < prof.PEAK_F32
    assert prof.precision('float64') == (8, 34e12)
    assert prof.precision(torch.float32) == (4, prof.PEAK_F32)
    with pytest.raises(ValueError):
        prof.precision(torch.float16)
    w32, w64 = prof.sweep_work(3, 12), prof.sweep_work(3, 12,
                                                       dtype=torch.float64)
    assert w64['needed'] == w32['needed'] and w64['real_bytes'] == 8
    ms32, by32 = prof.bound_ms(w32, 1024, 2000)
    ms64, by64 = prof.bound_ms(w64, 1024, 2000)
    assert by32 == by64 == 'operations'
    assert ms64 == pytest.approx(ms32 * prof.PEAK_F32 / prof.PEAK_F64)
    # one step moves bytes only: twice the float32 build's
    assert prof.bound_ms(w64, 1, 0) == (2 * prof.bound_ms(w32, 1, 0)[0],
                                        'bytes')


def test_float64_unitary_bound_and_roofline():
    u32, u64 = prof.unitary_work(3, 12), prof.unitary_work(
        3, 12, dtype='float64')
    assert u64['forward'] == u32['forward'] and u64['vjp'] == u32['vjp']
    assert u64['forward_bytes'] == 2 * u32['forward_bytes']
    assert u64['vjp_bytes'] == 2 * u32['vjp_bytes']
    ms, by = prof.unitary_bound_ms(u64['vjp'], u64['vjp_bytes'], 1024,
                                   dtype='float64')
    assert by == 'operations'
    assert ms == pytest.approx(u64['vjp'] * 1024 / 34e12 * 1e3)
    m32, m64 = prof.roofline_model(3, 12), prof.roofline_model(
        3, 12, dtype=torch.float64)
    assert m64['flops'] == m32['flops']
    assert m64['hbm_bytes'] == 2 * m32['hbm_bytes']
    assert m64['bound_ms_per_restart_iteration'] == pytest.approx(
        m32['bound_ms_per_restart_iteration'] * 67 / 34)

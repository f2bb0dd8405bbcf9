"""chip_smoke.py's phases at tiny sizes on the CPU.

``main`` itself refuses anything but a GPU, so these tests import the
phase functions and call them directly: the control flow, the references
each phase compares against and the pass/fail bookkeeping are the same
code the GPU run executes, at shapes the CPU finishes in seconds.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
cs = pytest.importorskip(
    'chip_smoke', reason='chip_smoke.py lives in the source tree, not the wheel')

TINY = dict(n=64, d=3, p=20, q=4)


@pytest.fixture(scope='module')
def full_phase():
    return cs.phase_full(TINY['n'], TINY['d'], TINY['p'], TINY['q'],
                         n0=16, n_oracle=48)


def _phase_lines(out):
    return [json.loads(ln[len('[phase] '):]) for ln in out.splitlines()
            if ln.startswith('[phase] ')]


def test_main_refuses_a_non_gpu_device(monkeypatch, capsys):
    import lcgp_tpu.utils
    monkeypatch.setattr(lcgp_tpu.utils, 'gpu_card',
                        lambda: 'Fake GPU, 700.00 W')
    with pytest.raises(cs.SmokeFailure, match='not a GPU'):
        cs.main([])
    out = capsys.readouterr().out
    assert '[card] Fake GPU, 700.00 W' in out
    assert '"ok"' not in out


def test_phase_records_and_raises_on_a_miss(capsys):
    ph = cs.Phase('synthetic')
    ph.compare('inside tolerance', 1e-12, 1e-9)
    ph.compare('outside tolerance', 1e-3, 1e-9)
    ph.compare('not finite', float('nan'), 1e-9)
    ph.require('a condition that holds', True)
    with pytest.raises(cs.SmokeFailure, match='outside tolerance'):
        ph.finish()
    (rec,) = _phase_lines(capsys.readouterr().out)
    assert [c['ok'] for c in rec['checks']] == [True, False, False, True]
    assert rec['checks'][0]['tol'] == 1e-9


def test_phase_full(full_phase, capsys):
    model, x0, ref = full_phase
    assert x0.shape == (16, TINY['d'])
    assert np.isfinite(ref['loss_init'])
    assert model.q_chunk is None            # CPU budget: unchunked


def test_phase_precisions(full_phase, capsys):
    _, _, ref = full_phase
    from lcgp_tpu.ops import linalg
    saved = linalg._INV_GEMM_PRECISION
    cs.phase_precisions(TINY['n'], TINY['d'], TINY['p'], TINY['q'],
                        ref['loss_init'])
    (rec,) = _phase_lines(capsys.readouterr().out)
    assert set(rec['matmul_f32_rel_err']) == {'DEFAULT', 'HIGH', 'HIGHEST'}
    assert np.isfinite(rec['fast_grad_rel_err_inverse_gemms_HIGH'])
    assert linalg._INV_GEMM_PRECISION == saved     # probe restored it


def test_phase_rep(capsys):
    cs.phase_rep(40, 3, TINY['d'], TINY['p'], TINY['q'], n0=16)
    (rec,) = _phase_lines(capsys.readouterr().out)
    assert rec['raw_rows'] == 120 and rec['n_unique'] == 40


def test_phase_fitc(capsys):
    cs.phase_fitc(300, TINY['d'], 10, 2, 16, n_check=100, n0=16)
    (rec,) = _phase_lines(capsys.readouterr().out)
    assert rec['m'] == 16


def test_phase_serve(full_phase, capsys):
    model, _, _ = full_phase
    cs.phase_serve(model, sizes=(1, 5, 16, 40), batch_size=16)
    (rec,) = _phase_lines(capsys.readouterr().out)
    assert set(rec['request_latency_s']) == {'1', '5', '16', '40'}
    assert not [d for d in os.listdir(cs.ROOT)
                if d.startswith('.chip_smoke_')]


@pytest.mark.parametrize('phase', ['comp_out', 'nshard', 'fitc'])
def test_four_device_phases(phase, capsys):
    devices = jax.devices()[:4]
    if len(devices) < 4:
        pytest.skip('needs 4 devices')
    if phase == 'comp_out':
        cs.phase_four_comp_out(64, TINY['d'], TINY['p'], TINY['q'], devices)
    elif phase == 'nshard':
        cs.phase_four_nshard(96, TINY['d'], 8, 4, devices, n0=16)
    else:
        cs.phase_four_fitc(400, TINY['d'], 10, 3, 16, devices, n0=16)
    recs = _phase_lines(capsys.readouterr().out)
    assert recs and all(c['ok'] for r in recs for c in r['checks'])

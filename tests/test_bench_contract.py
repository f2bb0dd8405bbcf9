"""The benchmark entry must ALWAYS print one parseable JSON line.

Whatever goes wrong — no GPU, a mid-run exception — stdout's last line
parses as JSON with the metric/value/unit/vs_baseline keys and every
section that completed, and the process exits non-zero.
"""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
bench = pytest.importorskip(
    'bench', reason='bench.py lives in the source tree, not the wheel')


def _last_json_line(captured: str):
    lines = [ln for ln in captured.strip().splitlines() if ln.strip()]
    assert lines, 'no output printed'
    return json.loads(lines[-1])


@pytest.fixture(autouse=True)
def _clear_partial():
    bench.PARTIAL.clear()
    yield
    bench.PARTIAL.clear()


@pytest.mark.quick
def test_degraded_line_is_parseable(capsys):
    bench._degraded('synthetic failure for the contract test')
    obj = _last_json_line(capsys.readouterr().out)
    assert obj['metric'] == bench.METRIC
    assert obj['value'] == 0.0
    assert obj['unit'] == 'evals/s'
    assert obj['vs_baseline'] == 0.0
    assert 'synthetic failure' in obj['error']


@pytest.mark.quick
def test_degraded_line_carries_partial_results(capsys):
    """A late failure must not discard sections that completed: the
    degraded line reports the measured f64 number, not 0.0."""
    bench.PARTIAL.update(secs64=2.0, chunk64=5, device='test')
    bench._degraded('failed in the rep section')
    obj = _last_json_line(capsys.readouterr().out)
    assert obj['value'] == 0.5
    assert obj['secs_per_eval_f64'] == 2.0
    assert obj['q_chunk_f64'] == 5
    if obj.get('baseline_cpu_evals_per_sec'):
        assert obj['vs_baseline'] > 0
    assert 'rep section' in obj['error']


@pytest.mark.quick
def test_main_exits_nonzero_on_section_failure(monkeypatch, capsys):
    """A section that raises: main() still prints the line with the
    sections that completed, then exits non-zero (never rc 0 after a
    caught failure)."""
    device = dict(platform='gpu', device_kind='Fake GPU', count=1,
                  card='Fake GPU, 700.00 W')

    def run():
        bench.PARTIAL.update(secs64=4.0, chunk64=5)
        raise RuntimeError('rep section exploded')

    monkeypatch.setattr(bench, '_device', lambda: device)
    monkeypatch.setattr(bench, '_run', run)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    obj = _last_json_line(capsys.readouterr().out)
    assert obj['value'] == 0.25
    assert obj['device'] == device
    assert 'rep section exploded' in obj['error']


@pytest.mark.quick
def test_main_refuses_a_non_gpu_device(capsys):
    """The suite runs on the CPU: main() must fail there rather than
    time the CPU backend under a device metric's name."""
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    obj = _last_json_line(capsys.readouterr().out)
    assert obj['value'] == 0.0
    assert 'not a GPU' in obj['error']


@pytest.mark.quick
def test_error_message_is_truncated(capsys):
    bench._degraded('x' * 5000)
    obj = _last_json_line(capsys.readouterr().out)
    assert len(obj['error']) <= 600

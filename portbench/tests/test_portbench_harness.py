"""The harness's own arithmetic and its discovery of files by name (on
the CPU)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import manifest as mf, stats, trace, work

ROOT = Path(__file__).resolve().parents[2]


def test_manifest_is_well_formed():
    assert mf.problems(mf.load()) == []


def test_every_name_leads_to_its_file():
    m = mf.load()
    for w in m['workloads']:
        mix = mf.mix(w['traffic'])
        assert hasattr(mf.kind(mix['kind']), 'Kind')
        assert mf.config(m, w['config'])['name'] == w['config']
        assert mf.limits(w['name'])
    for metric in m['end_to_end'] + m['per_layer']:
        assert callable(mf.metric(metric['name']).read)


@pytest.mark.parametrize('name,ok', [
    ('baxter_dh.plan', True), ('score_grad_roofline', True),
    ('_x-1.y', True), ('a' * 64, True), ('a' * 65, False),
    ('has space', False), ('a,b', False), ('a/b', False), ('.lead', False),
    ('microµ', False)])
def test_names(name, ok):
    assert bool(mf.NAME.match(name)) is ok


@pytest.mark.parametrize('unit,ok', [
    ('configs/s', True), ('%', True), ('launches/step', True),
    ('tokens per second', False), ('', False), ('a' * 17, False)])
def test_units(unit, ok):
    assert bool(mf.UNIT.match(unit)) is ok


def test_a_layer_metric_must_sit_where_its_moved_metric_is():
    m = mf.load()
    bad = json.loads(json.dumps(m))
    for e in bad['per_layer']:
        if e['name'] == 'idle.sweep':
            e['workloads'] = ['panda_dh.sweep', 'baxter_dh.plan']
    assert any('idle.sweep in baxter_dh.plan' in p
               for p in mf.problems(bad))
    bad['per_layer'][0]['moves'] = 'nothing'
    assert any('moves no end-to-end metric' in p for p in mf.problems(bad))


def test_metrics_of_follow_workloads():
    m = mf.load()
    names = [x['name'] for x in mf.metrics_of(m, 'panda_dh.sweep', True)]
    assert set(names) == {'score_grad_roofline', 'mfu.sweep', 'idle.sweep'}
    names = [x['name'] for x in mf.metrics_of(m, 'baxter_dh.plan', False)]
    assert set(names) == {'setup_s', 'plan_s'}


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 101):
        v = rng.exponential(size=n).tolist()
        for q in (0, 50, 90, 95, 100):
            assert stats.percentile(v, q) == pytest.approx(
                float(np.percentile(v, q)), rel=1e-12)
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10


class _Ctx:
    def __init__(self, counts, elapsed, times=()):
        self.counts, self.trace, self.work = counts, None, None
        self.window = type('W', (), {'elapsed': elapsed, 'times': list(times)})
        self.setup_s = 12.5


def test_the_end_to_end_readers_over_the_whole_window():
    rate = mf.metric('score_grad_rate').read
    assert rate(_Ctx({'configs': 3 * 2 ** 20, 'calls': 3}, 1.5)) == 2 * 2 ** 20
    assert rate(_Ctx({'plans': 4}, 1.5)) is None
    plan_s = mf.metric('plan_s').read
    assert plan_s(_Ctx({'plans': 128, 'adam_steps': 400}, 51.2)) == 0.4
    times = [0.1 * i for i in range(1, 12)]
    p90 = mf.metric('update_p90_ms').read(_Ctx({'updates': 11}, 51, times))
    assert p90 == pytest.approx(1000.0)
    assert mf.metric('update_p90_ms').read(_Ctx({'plans': 1}, 51, times)) is None
    assert mf.metric('setup_s').read(_Ctx({}, 1)) == 12.5


def test_idle_from_synthetic_intervals():
    REQ = trace.REQUEST
    # ns: two requests [0, 100) and [200, 300); device work inside them
    # (k3 ends past its request's end, as the two clocks may have it),
    # one copy, one event outside (before the first request)
    device = [(-50, -10, 'k0'), (10, 30, 'k1'), (20, 40, 'k2'),
              (60, 70, 'Memcpy HtoD'), (210, 305, 'k3')]
    host = [(0, 100, REQ), (200, 300, REQ), (40, 60, 'aten::mul'),
            (45, 55, 'aten::mul_inner'), (120, 180, 'aten::sum')]
    t = trace.Trace(400e-9, device, host)
    kernels, busy, wall = t.in_requests()
    assert kernels == 3                       # k1, k2, k3; not the copy
    assert busy == pytest.approx((30 + 10 + 95) * 1e-9)
    assert wall == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx((40 + 30 + 10 + 95) * 1e-9)
    gaps = dict((n, s) for n, s in t.top_gaps())
    assert gaps['aten::sum'] == pytest.approx(140e-9)   # 70 -> 210
    assert gaps['aten::mul_inner'] == pytest.approx(20e-9)  # 40 -> 60
    top = t.top_ops()
    assert top[0] == ['k3', pytest.approx(95e-9)]


def test_union_of_overlapping_intervals():
    busy, gaps = trace.union([(0, 10, 'a'), (5, 15, 'b'), (20, 30, 'c')])
    assert busy == pytest.approx(25e-9)
    assert gaps == [(15, 20)]


def test_work_bound_by_hand():
    # PandaFK: J = 7 joints, P = 7 points, F = 21, D = 7
    B, S = 2 ** 20, 258
    t = work.score_grad(B=B, S=S, F=21, J=7, P=7, D=7)
    products = B * S * (42 + 44)
    fk = 66 * 7 + 18 * 7 + 17 * 7 + 21 * 7
    assert fk == 854
    elementwise = B * S * 9 + B * fk
    nbytes = 4 * (B * 7 + B + B * 7 + S * 21 + S)
    assert t['products_s'] == pytest.approx(products / 495e12)
    assert t['elementwise_s'] == pytest.approx(elementwise / 67e12)
    assert t['bytes_s'] == pytest.approx(nbytes / 3.35e12)
    assert t['bound_s'] == max(t['products_s'], t['elementwise_s'],
                               t['bytes_s'])
    assert t['compute_s'] == t['elementwise_s']


def test_mfu_is_timed_by_the_untraced_host_slice():
    class Host:
        elapsed, requests = 2.0, 1000

    class Ctx:
        trace = object()         # present; its lengthened wall is not read
        counts = {'calls': 20}
        work = dict(B=2 ** 20, S=258, F=21, J=7, P=7, D=7)

        def host_slice(self):
            return Host
    v = mf.metric('mfu.sweep').read(Ctx())
    compute_s = work.score_grad(**Ctx.work)['compute_s']
    assert v == pytest.approx(100 * compute_s / 2e-3)


def test_a_wrong_step_in_one_problem_of_a_batch_is_not_diluted():
    import torch
    change_gaps = mf.kind('plan').Kind.change_gaps
    g = torch.Generator().manual_seed(0)
    problems, T, N, dof = 64, 8, 20, 7
    ref = [torch.rand((problems * T, N, dof), generator=g,
                      dtype=torch.float64)]
    ref.append(ref[0] + 0.1 * torch.rand(ref[0].shape, generator=g,
                                         dtype=torch.float64))
    g0 = torch.rand(ref[0].shape, generator=g, dtype=torch.float64)
    assert change_gaps(ref, ref, g0, problems) == (0.0, 0.0)
    prog = [ref[0], ref[1].clone()]
    prog[1][5 * T:6 * T] = ref[0][5 * T:6 * T]     # problem 5 never moves
    mean, worst = change_gaps(prog, ref, g0, problems)
    # leaves under the median are scaled by the median: a gap under 1
    assert mean > 0.9 and worst == pytest.approx(1.0)
    whole, _ = change_gaps(prog, ref, g0, 1)
    assert whole < 0.02                 # over the whole batch: 1/64


def test_seeds_are_stable_and_take_large_numbers():
    from portbench.harness import cell
    a, b = cell.seeds(2 ** 31 + 77), cell.seeds(2 ** 31 + 77)
    assert a == b and cell.seeds(5) != a
    assert all(0 <= v < 2 ** 32 for v in a.values())


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, str(ROOT / 'portbench' / 'run.py'),
                        '--workload', 'panda_dh.sweep', '--seed', '1',
                        '--seconds', '1', '--trace', '0'],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ''


def _copy_bench(dst: Path):
    shutil.copytree(ROOT / 'portbench', dst / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', dst / 'BENCHMARK.json')


def test_run_fails_with_only_the_benchmark(tmp_path):
    _copy_bench(tmp_path)
    p = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'panda_dh.sweep', '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=''))
    assert p.returncode != 0 and p.stdout.strip() == ''


ADD = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench.harness import cell, manifest as mf
from portbench.tests import tiny
assert mf.problems(mf.load()) == [], mf.problems(mf.load())
out = cell.run('panda_small.sweep_small', 4, 0.3, True, 'cpu',
               time.perf_counter(), config_overrides=tiny.FIT)
print(json.dumps(out))
'''


def test_a_config_mix_and_metric_are_added_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and new entries in BENCHMARK.json, and edits no
    file that is there."""
    _copy_bench(tmp_path)
    bench = tmp_path / 'portbench'
    before = {p: p.read_bytes() for p in bench.rglob('*') if p.is_file()}
    cfg = json.loads((bench / 'configs' / 'panda_dh.json').read_text())
    cfg['name'] = 'panda_small'
    (bench / 'configs' / 'panda_small.json').write_text(json.dumps(cfg))
    mix = json.loads((bench / 'mixes' / 'sweep.json').read_text())
    mix.update(batch=256, pools=2, check_rows=256, trace_requests=2)
    (bench / 'mixes' / 'sweep_small.json').write_text(json.dumps(mix))
    (bench / 'limits' / 'panda_small.sweep_small.json').write_text(
        json.dumps({'score_gap': 0.05, 'grad_gap': 0.05,
                    'foreign_supports': 0}))
    (bench / 'metrics' / 'calls.sweep_small.py').write_text(
        'def read(ctx):\n    return ctx.counts.get("calls")\n')
    m = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    m['configs'].append({'name': 'panda_small', 'source': 'x',
                         'file': 'portbench/configs/panda_small.json',
                         'reduced': [], 'why': 'a test'})
    m['workloads'].append({'name': 'panda_small.sweep_small',
                           'config': 'panda_small',
                           'traffic': 'sweep_small', 'chips': 1,
                           'why': 'a test'})
    for e in m['end_to_end']:
        if e['name'] == 'score_grad_rate':
            e['workloads'].append('panda_small.sweep_small')
    m['per_layer'].append({'name': 'calls.sweep_small', 'unit': 'calls',
                           'better': 'higher', 'source': 'program_counter',
                           'layer': 'checkers.py', 'moves':
                           'score_grad_rate',
                           'workloads': ['panda_small.sweep_small']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    p = subprocess.run([sys.executable, '-c', ADD, str(tmp_path),
                        str(ROOT)], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out['correct'] is True
    assert out['metrics']['calls.sweep_small']['value'] == 2
    after = {p: p.read_bytes() for p in before}
    assert after == before

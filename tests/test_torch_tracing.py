"""The package's own spans and counters (``diffco_tpu_torch.profiling``)
and the benchmark's readers of them. With no profiler running a span
enters no profiler range and allocates nothing, and importing the
module starts nothing; under ``torch.profiler`` the Adam step's, the FK's
and the update's spans nest as the readers expect; the kept entry spans
carry the greedy trainer's step count, keep the last 4096 and agree with
their profiler copies; and each reader in ``portbench/metrics`` gives the
number worked out by hand on a built trace and span log, and nothing on
a program without the spans."""
import importlib.util
import os
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import diffco_tpu_torch as dc
from diffco_tpu_torch import perceptron, profiling
from diffco_tpu_torch.ops import _native, fk_score, fused_score
from diffco_tpu_torch.profiling import Entry
from diffco_tpu_torch.robots.capsule_chain import CapsuleChainCollision
from portbench.harness import manifest as mf
from portbench.harness import trace as tr

torch.set_num_threads(1)


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


SHAPES = {'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                   'transform': _T([0.5, 0.5, 0.5])},
          'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                      'transform': _T([0.5, 0, 0])}}
PLAN = {'MAXITER': 2, 'N_WAYPOINTS': 6, 'NUM_RE_TRIALS': 2, 'seed': 0}


def _checker():
    robot = dc.PandaFK()
    env = dc.ShapeEnv(SHAPES)
    cap = CapsuleChainCollision(robot, link_radius=0.15, per_seg=4)
    return dc.ForwardKinematicsDiffCo(robot=robot, environment=env,
                                      gt_check_func=cap.checker_fn(env),
                                      device='cpu', seed=0)


@pytest.fixture(scope='module')
def checker():
    ck = _checker()
    ck.fit(num_samples=300)
    return ck


def _plan(ck):
    g = torch.Generator().manual_seed(1)
    q = ck.robot.rand_configs(2, g, 'cpu')
    return dc.adam_traj_optimize(ck.robot, ck.score_fn(), q[0], q[1], PLAN)


@pytest.fixture(scope='module')
def profiled(checker):
    """A 2-step plan and an update under the profiler: (host events
    [(start, end, name)], the kept spans logged meanwhile)."""
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _plan(checker)
        checker.update(num_samples=40)
    events = []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        events.append((s, s + ev.duration_ns(), ev.name()))
    return events, profiling.spans()


def _named(events, name):
    return [(s, e) for s, e, n in events if n == name]


def _inside(span, outer):
    return any(s <= span[0] and span[1] <= e for s, e in outer)


def test_no_span_enters_a_profiler_range_without_a_profiler(checker,
                                                            monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a profiler range entered with no profiler')

    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch._C._profiler, '_RecordFunctionFast', refuse)
    assert profiling.span('diffco.optim.step') is profiling.span('x')
    _plan(checker)
    checker.update(num_samples=40)
    # a span off allocates nothing: the peak stays within one loop int
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for _ in range(1000):
            with profiling.span('diffco.optim.step'):
                pass
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak - base < 256


def test_importing_profiling_starts_nothing(monkeypatch):
    """A fresh copy of the module, executed with the environment watched:
    no read of it, no CUDA, no profiler."""
    read = []

    class Watched(dict):
        def __getitem__(self, k):
            read.append(k)
            return super().__getitem__(k)

        def get(self, k, default=None):
            read.append(k)
            return super().get(k, default)

        def __contains__(self, k):
            read.append(k)
            return super().__contains__(k)

    monkeypatch.setattr(os, 'environ', Watched(os.environ))
    spec = importlib.util.spec_from_file_location('profiling_fresh',
                                                  profiling.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert read == []
    assert not torch.cuda.is_initialized()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert not torch.autograd._profiler_enabled()
    assert mod.spans() == [] and mod._counters == {}


def test_adam_step_spans_nest(profiled):
    events, _ = profiled
    steps = _named(events, 'diffco.optim.step')
    assert len(steps) == PLAN['MAXITER']
    for phase in ('loss', 'backward', 'update'):
        spans = _named(events, f'diffco.optim.{phase}')
        assert len(spans) == len(steps)
        assert all(_inside(s, steps) for s in spans), phase


def test_fk_spans_nest_in_the_score_the_loss_and_the_backward(profiled):
    events, _ = profiled
    steps = _named(events, 'diffco.optim.step')
    fk = [s for s in _named(events, 'diffco.robots.fk') if _inside(s, steps)]
    # twice a step: in the proxy's score and in the loss's own FK
    assert len(fk) == 2 * len(steps)
    assert all(_inside(s, _named(events, 'diffco.optim.loss')) for s in fk)
    scores = _named(events, 'diffco.checker.score')
    assert len(scores) == len(steps)
    assert sum(_inside(s, scores) for s in fk) == len(steps)
    vjp = [s for s in _named(events, 'diffco.robots.fk_vjp')
           if _inside(s, steps)]
    assert len(vjp) == 2 * len(steps)
    assert all(_inside(s, _named(events, 'diffco.optim.backward'))
               for s in vjp)


def test_update_spans_nest(profiled):
    events, _ = profiled
    update, = _named(events, 'diffco.checker.update')
    fit, = _named(events, 'diffco.checker.fit')
    assert _inside(fit, [update])
    for name in ('diffco.checker.labels', 'diffco.perceptron.train',
                 'diffco.perceptron.fit_poly', 'diffco.checker.verify'):
        spans = _named(events, name)
        assert len(spans) == 1 and _inside(spans[0], [fit]), name


def test_kept_spans_agree_with_their_profiler_copies(profiled):
    events, kept = profiled
    assert [e.name for e in kept] == ['diffco.checker.fit',
                                      'diffco.checker.update']
    for e in kept:
        (s, t), = _named(events, e.name)
        assert abs(e.start_ns - s) < 1e6 and abs(e.end_ns - t) < 1e6


def test_update_entry_counts_the_greedy_steps(checker, monkeypatch):
    calls = []
    loop = perceptron._greedy_loop

    def counting(step, gains, hyp, max_iteration):
        def counted(g, h):
            calls.append(1)
            return step(g, h)
        return loop(counted, gains, hyp, max_iteration)

    monkeypatch.setattr(perceptron, '_greedy_loop', counting)
    profiling.reset_spans()
    checker.update(num_samples=40)
    fit, update = profiling.spans()
    assert (fit.name, update.name) == ('diffco.checker.fit',
                                       'diffco.checker.update')
    assert fit.parent == update.id and update.parent is None
    assert update.start_ns <= fit.start_ns <= fit.end_ns <= update.end_ns
    assert update.counts == fit.counts == {
        'perceptron.greedy_steps': len(calls)}
    assert calls


def test_the_log_keeps_the_last_entries():
    profiling.reset_spans()
    for i in range(profiling.SPAN_LOG + 100):
        with profiling.span('test.kept', keep=True):
            profiling.count('test.kept', i % 3)
    log = profiling.spans()
    assert profiling.SPAN_LOG == 4096 and len(log) == 4096
    assert [e.id for e in log] == list(range(log[0].id, log[0].id + 4096))
    assert log[-1].counts == {'test.kept': (4096 + 99) % 3}
    assert log[-2].counts == {}          # a change of 0 is left out
    profiling.reset_spans()
    assert profiling.spans() == []


def _stand_in(monkeypatch, rc, failing=None):
    """``_native.build`` replaced by stand-in libraries whose every C entry
    records its name and arguments and returns ``rc`` (only the entry
    ``failing`` does, if given; the others 0), and the card-only helpers
    by no-ops. Returns the calls."""
    calls = []

    class Lib:
        def __getattr__(self, entry):
            code = rc if failing in (None, entry) else 0
            return lambda *args: calls.append((entry, args)) or code
    monkeypatch.setattr(_native, 'build', lambda: {
        'greedy_train': Lib(), 'dh_dual_score': Lib(), 'chain_score': Lib(),
        'poly_score': Lib()})
    monkeypatch.setattr(_native, 'check_cuda_inputs', lambda *a: None)
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    return calls


def _wide_launch():
    """B3's wide instance through ``fk_score._launch``: 4 rows of a chain
    of 3 dofs, 2 moving joints and 2 points, 5 supports; the wide block's
    prologue first."""
    c = _native.ChainSpecWide()
    c.M = 2
    fk_score._launch('chain_score_grad', 'chain_score', torch.zeros(4, 3),
                     torch.zeros(5, 6), torch.zeros(5), c, 3, 2)


def _poly_wide_launch():
    """B2's wide instance (F = 70 > ``_native.TC_MAX_F``) through
    ``fused_score._poly_launch``: 4 rows, 5 supports; the wide block's
    prologue first."""
    fused_score._poly_launch(torch.zeros(4, 70), torch.zeros(5, 70),
                             torch.zeros(5))


def _guard_wide_launch():
    """B2's guarded measurement entry at F = 70: the wide instance, which
    has no guard, after its prologue, and 0 pairs recomputed."""
    *_, pairs = fused_score.poly_score_guard_pairs(
        torch.zeros(4, 70), torch.zeros(5, 70), torch.zeros(5), 0.25)
    assert pairs == 0


# (case, the launch, its C entries in order, the counters it adds to)
LAUNCHES = {
    'launch': (lambda: _native.launch('greedy_train', 'greedy_train', 1, 2),
               ['greedy_train'], ['launches.greedy_train']),
    'launch under a kernel name': (
        lambda: _native.launch('dh_dual_score', 'dh_dual_score_grad', 3,
                               kernel='dh_dual_score_grad:dual_seq_256'),
        ['dh_dual_score_grad'],
        ['launches.dh_dual_score_grad:dual_seq_256']),
    'wide launch': (_wide_launch, ['wide_prep', 'chain_score_grad_wide'],
                    ['launches.wide_prep', 'launches.chain_score_grad',
                     'ops.wide_launches']),
    'wide B2 launch': (_poly_wide_launch,
                       ['wide_prep', 'poly_score_grad_wide'],
                       ['launches.wide_prep', 'launches.poly_score_grad']),
    'guarded wide B2 launch': (
        _guard_wide_launch, ['wide_prep', 'poly_score_grad_wide'],
        ['launches.wide_prep', 'launches.poly_score_grad_guard']),
}


@pytest.mark.parametrize('fails', [False, True])
@pytest.mark.parametrize('case', list(LAUNCHES))
def test_a_launch_counts_once_under_its_kernel(monkeypatch, case, fails):
    """``_native.launch`` calls the C entry through ``build()`` once and
    counts one under the kernel's name (a wide launch its prologue, in
    ``launches.wide_prep``, then the instance, in ``ops.wide_launches``
    too); a nonzero return code raises and counts nothing."""
    calls = _stand_in(monkeypatch, 2 if fails else 0)
    launch, entries, names = LAUNCHES[case]
    before = profiling.counters()
    if fails:
        with pytest.raises(RuntimeError, match=f'{entries[0]}: CUDA launch '
                                               'failed with cudaError 2'):
            launch()
    else:
        launch()
    assert [e for e, _ in calls] == (entries[:1] if fails else entries)
    after = profiling.counters()
    assert {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)} == ({} if fails else dict.fromkeys(
                names, 1))


@pytest.mark.parametrize('case', ['wide launch', 'wide B2 launch'])
def test_a_failed_wide_instance_counts_its_prologue_alone(monkeypatch,
                                                          case):
    """Where the prologue launches and the wide instance after it fails,
    the call raises naming the instance, and only the prologue counts:
    neither the instance's ``launches.<kernel>`` nor
    ``ops.wide_launches``."""
    launch, entries, _ = LAUNCHES[case]
    calls = _stand_in(monkeypatch, 2, failing=entries[1])
    before = profiling.counters()
    with pytest.raises(RuntimeError, match=f'{entries[1]}: CUDA launch '
                                           'failed with cudaError 2'):
        launch()
    assert [e for e, _ in calls] == entries
    after = profiling.counters()
    assert {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)} == {'launches.wide_prep': 1}


# (case, the fit or update after a fit on 300 samples)
FITS = {
    'split fit': lambda ck: ck.fit(num_samples=300),
    'warm update, verify 0.2': lambda ck: ck.update(num_samples=40,
                                                    verify=0.2),
    'verify_ratio 0': lambda ck: ck.fit(num_samples=300, verify_ratio=0),
}


@pytest.mark.parametrize('case', list(FITS))
def test_fit_sweeps_its_verify_rows_once(monkeypatch, case):
    """``fit`` scores its verify rows (without a split, 100 fresh
    configurations) in one sweep, and its safety bias and biased metrics
    are, bit for bit, those of ``_calculate_safety_bias`` and ``verify``
    called on the same rows afterwards."""
    ck = _checker()
    if case != 'split fit':
        ck.fit(num_samples=300)
    swept = []
    sweep = ck._sweep_scores

    def counted(q):
        swept.append(q.clone())
        return sweep(q)
    monkeypatch.setattr(ck, '_sweep_scores', counted)
    got = FITS[case](ck)
    rows, = swept
    assert rows.shape[0] == (100 if case == 'verify_ratio 0' else
                             ck.q_verify.shape[0]) > 0
    assert ck._calculate_safety_bias(rows) == ck.safety_bias
    if case == 'verify_ratio 0':
        assert got == (None, None, None)
    else:
        assert torch.equal(rows, ck.q_verify)
        assert ck.verify(rows) == got
        assert all(isinstance(m, float) for m in got)


# ---- the readers, on a built trace and span log (ns)

REQ = tr.REQUEST
L = 'cudaLaunchKernel'
PLAN_HOST = [
    (0, 1000, REQ),
    (100, 500, 'diffco.optim.step'), (600, 1000, 'diffco.optim.step'),
    (110, 200, 'diffco.optim.loss'), (120, 150, 'diffco.robots.fk'),
    (210, 400, 'diffco.optim.backward'), (220, 260, 'diffco.robots.fk_vjp'),
    (610, 640, 'diffco.robots.fk'), (650, 700, 'diffco.robots.fk_vjp'),
    (125, 126, L), (130, 131, 'cuLaunchKernel'),
    (230, 231, 'cudaLaunchKernelExC'), (620, 621, L),
    (300, 301, L),                        # in the backward, not in its FK
    (660, 661, 'cudaMemcpyAsync'),        # not a launch
    (1200, 1300, 'diffco.robots.fk'), (1250, 1251, L),  # after the request
]
UPDATE_HOST = [
    (0, 1000, REQ), (2000, 3000, REQ),
    (10, 990, 'diffco.checker.update'), (20, 980, 'diffco.checker.fit'),
    (100, 500, 'diffco.perceptron.train'),
    (2010, 2990, 'diffco.checker.update'),
    (2100, 2400, 'diffco.perceptron.train'),
    (150, 151, L), (160, 161, L), (170, 171, L), (600, 601, L),
    (2200, 2201, L), (2300, 2301, L),
]
UPDATE_LOG = [
    Entry('diffco.checker.update', -500, -100, 1, None,
          {'perceptron.greedy_steps': 50}),       # the set-up's warm-up
    Entry('diffco.checker.fit', 20, 980, 3, 2,
          {'perceptron.greedy_steps': 3}),
    Entry('diffco.checker.update', 10, 990, 2, None,
          {'perceptron.greedy_steps': 3}),
    Entry('diffco.checker.update', 2010, 2990, 4, None,
          {'perceptron.greedy_steps': 1}),
]
SWEEP_HOST = [
    (0, 1000, REQ), (2000, 3000, REQ),
    (100, 400, 'diffco.ops.fk_score'), (200, 250, 'diffco.ops.launch'),
    (2100, 2200, 'diffco.ops.fk_score'), (2150, 2190, 'diffco.ops.launch'),
]
SETUP_LOG = [
    Entry('diffco.checker.fit', -5_000_000_000, -3_000_000_000, 1, None, {}),
    Entry('diffco.native.build', -2_000_000_000, -1_500_000_000, 2, None,
          {}),
    Entry('diffco.checker.fit', -900_000_000, -600_000_000, 4, 3, {}),
    Entry('diffco.checker.update', -1_000_000_000, -500_000_000, 3, None,
          {}),
    Entry('diffco.checker.fit', 100, 200, 5, None, {}),   # in a request
]

READINGS = {
    # 4 launches in the FK spans of the request, over 2 steps
    'adam.fk_launches_per_step': (PLAN_HOST, [], {'adam_steps': 2}, 2.0),
    # FK (30 + 40 + 30 + 50) over the steps (400 + 400)
    'adam.fk_share': (PLAN_HOST, [], {'adam_steps': 2}, 100 * 150 / 800),
    # 3 + 2 launches in the trainer over 3 + 1 greedy steps
    'update.launches_per_greedy_step': (UPDATE_HOST, UPDATE_LOG,
                                        {'updates': 2}, 5 / 4),
    'update.train_share': (UPDATE_HOST, [], {'updates': 2},
                           100 * 700 / 1960),
    # (300 - 50) + (100 - 40) ns over 2 requests, in ms
    'router.host_ms': (SWEEP_HOST, [], {'calls': 2}, 310 / 2 * 1e-6),
    # the top-level fit before the requests; the build before them
    'setup.fit_s': (SWEEP_HOST, SETUP_LOG, {'calls': 2}, 2.0),
    'setup.native_s': (SWEEP_HOST, SETUP_LOG, {'calls': 2}, 0.5),
}


@pytest.mark.parametrize('name', sorted(READINGS))
def test_reader_by_hand(name, monkeypatch):
    host, log, counts, want = READINGS[name]
    monkeypatch.setattr(profiling, 'spans', lambda: list(log))
    ctx = SimpleNamespace(trace=tr.Trace(1e-6, [], host), counts=counts,
                          setup_s=10.0, window=None)
    assert mf.metric(name).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize('name', sorted(READINGS))
def test_reader_finds_nothing_without_the_spans(name, monkeypatch):
    """The parent program: no spans in its trace, no kept spans."""
    host, _, counts, _ = READINGS[name]
    monkeypatch.delattr(profiling, 'spans')
    bare = [h for h in host if not h[2].startswith('diffco.')]
    ctx = SimpleNamespace(trace=tr.Trace(1e-6, [], bare), counts=counts,
                          setup_s=10.0, window=None)
    assert mf.metric(name).read(ctx) is None

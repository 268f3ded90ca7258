"""Port parity of the active-learning path: warm-started training of the
three perceptrons, the path bands, the checker's update (around the
supports and around given paths) after an obstacle moves,
corridor_update, and the hybrid and optimistic checkers, each fed the
same numpy inputs as the JAX package (small sizes: N <= 600)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu import kernels as jk
from diffco_tpu import perceptron as jp
from diffco_tpu import sampler as jsampler
from diffco_tpu.checkers import corridor_update as jcorridor_update
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu.robots.capsule_chain import CapsuleChainCollision as JCap
import diffco_tpu_torch as tdc
from diffco_tpu_torch import kernels as tk
from diffco_tpu_torch import perceptron as tp
from diffco_tpu_torch import sampler as tsampler
from diffco_tpu_torch.convert import load_reference_state
from diffco_tpu_torch.robots.capsule_chain import CapsuleChainCollision as TCap

torch.set_num_threads(1)

LINK_RADIUS = 0.15
STATE_KEYS = ('support_points', 'support_transformed', 'gains', 'hypothesis',
              'y', 'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')


def _T(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m


SHAPES = {'box1': {'type': 'Box', 'params': {'extents': [0.1, 0.1, 0.1]},
                   'transform': _T([0.5, 0.5, 0.5])},
          'sphere1': {'type': 'Sphere', 'params': {'radius': 0.1},
                      'transform': _T([0.5, 0, 0])}}
# sphere1's position after the move
MOVED = _T([0.2, 0.3, 0.4])


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def _state(p, **extra):
    """The arrays load_reference_state takes, off a JAX perceptron."""
    out = {k: np.asarray(getattr(p, k)) for k in STATE_KEYS}
    out.update(extra)
    return out


# ---- (a) warm-started train(update=True, exist_mask)

def _ball_labels(X):
    """Two balls of collisions in the first three components: [N, 2]."""
    c = np.array([[0.3, 0.2, 0.0], [-0.4, -0.3, 0.2]])
    d = np.linalg.norm(X[:, None, :3] - c[None], axis=-1)
    return np.where(d < 0.5, 1.0, -1.0).astype(np.float32)


def _warm_data(p_ref, make_x, labels, n_new, seed):
    """The dataset of an update: n_new fresh rows, then the reference's
    valid supports in the support buffer's order (exist_mask), as
    RBFDiffCo.update assembles it."""
    nv = p_ref.num_valid
    X = np.concatenate([make_x(n_new, seed),
                        np.asarray(p_ref.support_points)[:nv]], axis=0)
    em = np.zeros(X.shape[0], bool)
    em[-nv:] = True
    return X.astype(np.float32), labels(X), em


def _compare_trained(out, ref, gain_tol, iterations=True):
    """As test_diffco_train_matches_on_raw_configs: iterations and valid
    supports equal, supports 1e-6, gains and hypothesis ``gain_tol``.
    (The JAX package's MultiDimDiffCo keeps no iteration count.)"""
    if iterations:
        assert out.train_iterations == ref.train_iterations
    assert out.num_valid == ref.num_valid
    assert out.support_points.shape[0] == ref.support_points.shape[0]
    _close(out.support_points, ref.support_points, 1e-6)
    _close(out.gains, ref.gains, gain_tol)
    _close(out.hypothesis, ref.hypothesis, gain_tol)


def _flat_x(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, size=(n, 6)).astype(
        np.float32)


@pytest.mark.parametrize('lazy', [False, True])
@pytest.mark.parametrize('kind', ['DiffCo', 'MultiDiffCo'])
def test_warm_start_train_matches(kind, lazy):
    """A cold JAX fit on 300 rows is carried across; both packages then
    warm-start on 200 new rows plus the supports (exist_mask), dense and
    lazy (lazy_gram_threshold 100, the cross-Gram against the padded
    support buffer)."""
    multi = kind == 'MultiDiffCo'

    def labels(X):
        y = _ball_labels(X)
        return y if multi else y[:, 0]
    ref = getattr(jp, kind)(kernel_func=jk.RQKernel(10.0))
    X0 = _flat_x(300, seed=1)
    ref.train(jnp.asarray(X0), jnp.asarray(labels(X0)), max_iteration=900)
    out = load_reference_state(
        getattr(tp, kind)(kernel_func=tk.RQKernel(10.0)),
        _state(ref, rbf_kernel='MultiQuadratic' if multi else 'Polyharmonic',
               epsilon=1.0), device='cpu')
    if lazy:
        ref.lazy_gram_threshold = out.lazy_gram_threshold = 100
    X, y, em = _warm_data(ref, _flat_x, labels, 200, seed=2)
    ref.train(jnp.asarray(X), jnp.asarray(y), update=True, exist_mask=em,
              max_iteration=3 * X.shape[0])
    out.train(torch.from_numpy(X), torch.from_numpy(y), update=True,
              exist_mask=em, max_iteration=3 * X.shape[0])
    _compare_trained(out, ref, 1e-5)


def _multidim_x(n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, size=(n, 3, 2)).astype(np.float32)


def _multidim_labels(X):
    d = np.linalg.norm(X[:, 0] - 0.3, axis=-1)
    return np.where(d < 0.6, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize('lazy', [False, True])
def test_multidim_warm_start_train_matches(lazy):
    """MultiDimDiffCo's warm start (h_i = sum_j K[i, j] . g_j, by
    einsum on both paths), at the tolerances of
    test_multidimdiffco_matches."""
    ref = jp.MultiDimDiffCo(kernel_func=jk.MultiDimRQKernel(5.0))
    X0 = _multidim_x(200, seed=3)
    ref.train(jnp.asarray(X0), jnp.asarray(_multidim_labels(X0)),
              max_iteration=600)
    out = load_reference_state(
        tp.MultiDimDiffCo(kernel_func=tk.MultiDimRQKernel(5.0)),
        _state(ref, rbf_kernel='MultiDimRQKernel', gamma=5.0), device='cpu')
    if lazy:
        ref.lazy_gram_threshold = out.lazy_gram_threshold = 100
    X, y, em = _warm_data(ref, _multidim_x, _multidim_labels, 150, seed=4)
    ref.train(jnp.asarray(X), jnp.asarray(y), update=True, exist_mask=em,
              max_iteration=3 * X.shape[0])
    out.train(torch.from_numpy(X), torch.from_numpy(y), update=True,
              exist_mask=em, max_iteration=3 * X.shape[0])
    _compare_trained(out, ref, 1e-4, iterations=False)


def test_update_without_gains_starts_cold():
    """update=True on a perceptron never trained: DiffCo starts cold, as
    a plain train does (no exist_mask needed)."""
    X = _flat_x(120, seed=5)
    y = _ball_labels(X)[:, 0]
    a, b = tp.DiffCo(kernel_func=tk.RQKernel(10.0)), \
        tp.DiffCo(kernel_func=tk.RQKernel(10.0))
    a.train(torch.from_numpy(X), torch.from_numpy(y), update=True,
            max_iteration=360)
    b.train(torch.from_numpy(X), torch.from_numpy(y), max_iteration=360)
    assert a.train_iterations == b.train_iterations
    torch.testing.assert_close(a.gains, b.gains, rtol=0, atol=0)


# ---- (b) path_band_samples

def _paths():
    rng = np.random.default_rng(6)
    return [np.linspace(rng.uniform(-1, 1, 7), rng.uniform(-1, 1, 7), 12),
            rng.uniform(-1, 1, (1, 7)),            # skipped: one waypoint
            np.linspace(rng.uniform(-1, 1, 7), rng.uniform(-1, 1, 7), 5)]


@pytest.mark.parametrize('make_rng', [np.random.RandomState,
                                      np.random.default_rng])
@pytest.mark.parametrize('n_total', [256, 1000])
def test_path_band_samples_equal(make_rng, n_total):
    """Exactly the JAX package's samples from the same stream (randint for
    a RandomState, integers for a Generator), 90 % in the bands and
    n_total rows."""
    lims = np.asarray(JPanda().limits)
    ref = jsampler.path_band_samples(_paths(), lims, make_rng(0),
                                     n_total=n_total)
    out = tsampler.path_band_samples(_paths(), lims, make_rng(0),
                                     n_total=n_total)
    assert out.shape == (n_total, 7) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match='at least one path'):
        tsampler.path_band_samples([np.zeros((1, 7))], lims, make_rng(0))


# ---- (c) ForwardKinematicsDiffCo.update after sphere1 moves

def _q(n, seed):
    lims = np.asarray(JPanda().limits)
    u = np.random.default_rng(seed).uniform(size=(n, 7)).astype(np.float32)
    return u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]


@pytest.fixture(scope='module')
def reference_fit():
    """The JAX package's fit of a PandaFK proxy on 300 numpy
    configurations (no held-out split) in the box + sphere scene: the
    arrays load_reference_state takes, and the data to refit it."""
    jenv = jdc.ShapeEnv(shapes=SHAPES)
    jgt = JCap(JPanda(), link_radius=LINK_RADIUS)
    q = _q(300, seed=11)
    labels = (np.asarray(jgt.signed_dist(jnp.asarray(q), jenv)) > 0
              ).astype(np.float32)
    return dict(q=q, labels=labels)


def _pair(reference_fit, jcls, tcls, **kwargs):
    """A JAX checker of class ``jcls`` fitted on the reference data and a
    port checker of class ``tcls`` holding its state, each with its own
    scene and capsule-chain ground truth bound to it."""
    jenv, tenv = jdc.ShapeEnv(shapes=SHAPES), tdc.ShapeEnv(SHAPES)
    jcap = JCap(JPanda(), link_radius=LINK_RADIUS)
    tcap = TCap(tdc.PandaFK(), link_radius=LINK_RADIUS)
    jck = jcls(robot=JPanda(), environment=jenv,
               gt_check_func=jcap.checker_fn(jenv), **kwargs)
    jck.fit(q=reference_fit['q'], labels=reference_fit['labels'],
            verify_ratio=0)
    tck = tcls(robot=tdc.PandaFK(), environment=tenv,
               gt_check_func=tcap.checker_fn(tenv), device='cpu', **kwargs)
    load_reference_state(tck, _state(
        jck.perceptron, epsilon=np.asarray(jck.perceptron.rbf_kernel.epsilon),
        safety_bias=np.asarray(jck.safety_bias)))
    return dict(jck=jck, tck=tck, jenv=jenv, tenv=tenv, jcap=jcap, tcap=tcap)


def _same_streams(*checkers):
    """Each checker's _next_rng gives the same sequence of numpy streams
    (the packages' own streams differ)."""
    for ck in checkers:
        seeds = iter(np.random.SeedSequence(21).spawn(8))
        ck._next_rng = lambda seeds=seeds: np.random.default_rng(next(seeds))


def _record_fit(ck):
    """Keep the dataset each fit receives."""
    seen, fit = [], ck.fit

    def recording(q=None, *args, **kwargs):
        seen.append(np.asarray(q.cpu() if torch.is_tensor(q) else q))
        return fit(q, *args, **kwargs)
    ck.fit = recording
    return seen


@pytest.mark.parametrize('paths', [False, True])
def test_update_after_a_move_matches(reference_fit, paths):
    """sphere1 moves and both ground truths are rebound to the moved
    scene; an update (around the supports, or around a colliding straight
    line with num_exploit_samples=200) assembles the same dataset (its
    size a multiple of 256), keeps the same supports and reaches the same
    safety bias and verify metrics; the fits' float32 solves differ
    (ROADMAP, "Fits differ in float32"), so scores and gains are compared
    at 1e-2."""
    pr = _pair(reference_fit, jdc.ForwardKinematicsDiffCo,
               tdc.ForwardKinematicsDiffCo)
    jck, tck = pr['jck'], pr['tck']
    pr['jenv'].update_transform('sphere1', MOVED)
    pr['tenv'].update_transform('sphere1', MOVED)
    jck.gt_check_func = pr['jcap'].checker_fn(pr['jenv'])
    tck.gt_check_func = pr['tcap'].checker_fn(pr['tenv'])
    _same_streams(jck, tck)
    seen_j, seen_t = _record_fit(jck), _record_fit(tck)
    kwargs = dict(num_samples=100, verify=0.2)
    if paths:
        free = reference_fit['q'][reference_fit['labels'] == 0]
        kwargs.update(exploit_paths=[np.linspace(free[0], free[1], 20)],
                      num_exploit_samples=200)
    ref = jck.update(**kwargs)
    out = tck.update(**{k: v if k != 'exploit_paths' else
                        [torch.from_numpy(p) for p in v]
                        for k, v in kwargs.items()})
    assert seen_t[0].shape == seen_j[0].shape
    assert seen_t[0].shape[0] % 256 == 0
    np.testing.assert_array_equal(seen_t[0], seen_j[0])
    jp_, tp_ = jck.perceptron, tck.perceptron
    assert tp_.num_valid == jp_.num_valid
    _close(tp_.support_points, jp_.support_points, 1e-6)
    _close(tp_.gains, jp_.gains, 1e-2)
    assert abs(tck.safety_bias - jck.safety_bias) <= 1e-2 * max(
        1.0, abs(jck.safety_bias))
    np.testing.assert_allclose(out, ref, atol=1e-2)
    q = _q(256, seed=13)
    _close(tck.collision_score(torch.from_numpy(q)).numpy(),
           jck.collision_score(jnp.asarray(q)), 1e-2)


def test_update_errors():
    """update before a fit raises RuntimeError, as the JAX package's."""
    ck = tdc.ForwardKinematicsDiffCo(robot=tdc.PandaFK(),
                                     gt_check_func=lambda q: None,
                                     device='cpu')
    with pytest.raises(RuntimeError, match='fit'):
        ck.update(num_samples=10)


# ---- (d) corridor_update

def _by_row(p):
    """A perceptron's valid supports and gains, rows in lexicographic
    order of the support points."""
    nv = p.num_valid
    sp = np.asarray(p.support_points)[:nv]
    order = np.lexsort(sp.T[::-1])
    return sp[order], np.asarray(p.gains)[:nv][order]


def test_corridor_update_matches():
    """The same base dataset, paths and RandomState through each package's
    corridor_update, each retraining its own DiffCo on the widened set:
    equal samples, signed distances within 1e-5 (their signs equal), the
    same widened dataset handed to the closures, and retrained
    perceptrons with equal iterations and the same supports, gains within
    1e-4. On raw configurations the two Grams round apart by ~4e-5 over
    the greedy steps, and gains of nearly equal size (1.00061, 1.00062)
    then order the support buffer differently: the supports are compared
    as a set."""
    jenv, tenv = jdc.ShapeEnv(shapes=SHAPES), tdc.ShapeEnv(SHAPES)
    jcap = JCap(JPanda(), link_radius=LINK_RADIUS)
    tcap = TCap(tdc.PandaFK(), link_radius=LINK_RADIUS)
    cfgs = _q(200, seed=14)
    sd0 = np.asarray(jcap.signed_dist(jnp.asarray(cfgs), jenv))
    base = (cfgs, (sd0 > 0) * 2.0 - 1.0, sd0)
    lims = np.asarray(JPanda().limits)
    paths = [np.linspace(cfgs[0], cfgs[1], 10)]
    seen = {}

    def jretrain(c, y, d):
        seen['jax'] = (c, y, d)
        p = jp.DiffCo(kernel_func=jk.RQKernel(10.0))
        p.train(jnp.asarray(c), jnp.asarray(y), max_iteration=3 * len(c))
        return p

    def tretrain(c, y, d):
        seen['torch'] = (c, y, d)
        p = tp.DiffCo(kernel_func=tk.RQKernel(10.0))
        p.train(torch.from_numpy(c.astype(np.float32)),
                torch.from_numpy(y.astype(np.float32)),
                max_iteration=3 * len(c))
        return p
    ref, ref_s, ref_sd = jcorridor_update(
        base, paths, lims, lambda q: jcap.signed_dist(q, jenv), jretrain,
        np.random.RandomState(0), n_total=256)
    out, s, sd = tdc.corridor_update(
        base, paths, lims, lambda q: tcap.signed_dist(q, tenv), tretrain,
        np.random.RandomState(0), n_total=256, device='cpu')
    np.testing.assert_array_equal(s, ref_s)
    _close(sd, ref_sd, 1e-5)
    np.testing.assert_array_equal(sd > 0, np.asarray(ref_sd) > 0)
    (c, y, d), (rc, ry, rd) = seen['torch'], seen['jax']
    assert c.shape == rc.shape == (456, 7)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(y, ry)
    _close(d, rd, 1e-5)
    assert out.train_iterations == ref.train_iterations
    assert out.num_valid == ref.num_valid
    (sp, g), (rsp, rg) = _by_row(out), _by_row(ref)
    _close(sp, rsp, 1e-6)
    _close(g, rg, 1e-4)


# ---- (e) the hybrid and optimistic checkers

@pytest.mark.parametrize('lazy_line_check', [False, True])
def test_hybrid_collision_matches(reference_fit, lazy_line_check):
    """On one carried-over state: the hybrid labels of 400 configurations
    equal the JAX package's, and (the reference's own assertion) agree
    with the ground truth at least as often as the raw proxy."""
    pr = _pair(reference_fit, jdc.HybridForwardKinematicsDiffCo,
               tdc.HybridForwardKinematicsDiffCo,
               lazy_line_check=lazy_line_check)
    q = _q(400, seed=15)
    ref = np.asarray(pr['jck'].collision(jnp.asarray(q)))
    out = pr['tck'].collision(torch.from_numpy(q)).numpy()
    assert out.dtype == bool and out.shape == (400,)
    np.testing.assert_array_equal(out, ref)
    gt = pr['tck'].gt_check_func(torch.from_numpy(q)).numpy()
    raw = pr['tck'].collision_score(torch.from_numpy(q)).numpy().reshape(
        -1) > 0
    if not lazy_line_check:
        assert (out == gt).mean() >= (raw == gt).mean()


def test_optimistic_in_collision_matches(reference_fit):
    """OptimisticChecker.in_collision on paths, optimistic and not, as the
    JAX package answers."""
    pr = _pair(reference_fit, jdc.OptimisticChecker, tdc.OptimisticChecker)
    q = reference_fit['q']
    answers = set()
    for i in range(0, 12, 2):
        path = np.linspace(q[i], q[i + 1], 20).astype(np.float32)
        for optimistic in (False, True):
            ref = pr['jck'].in_collision(jnp.asarray(path),
                                         optimistic=optimistic)
            out = pr['tck'].in_collision(torch.from_numpy(path),
                                         optimistic=optimistic)
            assert isinstance(out, bool) and out == ref
            answers.add(out)
    assert answers == {False, True}

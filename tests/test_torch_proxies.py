"""Port parity: the rest of the kernel functions, rq_score, the
multi-class and vector-gain trainers (dense and lazy-row), and the
MultiDiffCo, DiffCoBeta and MultiDimDiffCo proxies, fed the same numpy
inputs as the JAX package."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import kernels as jk
from diffco_tpu import perceptron as jp
from diffco_tpu.ops.fused_score import rq_score as j_rq_score
from diffco_tpu.robots import PandaFK as JPanda
from diffco_tpu_torch import kernels as tk
from diffco_tpu_torch import perceptron as tp
from diffco_tpu_torch.checkers import RBFDiffCo
from diffco_tpu_torch.convert import load_reference_state
from diffco_tpu_torch.ops.fused_score import rq_score
from diffco_tpu_torch.robots import PandaFK

torch.set_num_threads(1)

CENTERS = np.array([[0.4, 0.0, 0.0], [-0.4, 0.2, 0.0]])


def _data(N=240, F=6, seed=0):
    """Points in [-1, 1]^F with a ball of collisions around each center:
    labels [N, 2] in {-1, +1}."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(N, F)).astype(np.float32)
    d = np.linalg.norm(X[:, None, :3] - CENTERS[None], axis=-1)
    return X, np.where(d < 0.5, 1.0, -1.0).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(out, ref, tol):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=tol,
                               atol=tol)


def _kernel_pairs():
    jpanda, tpanda = JPanda(), PandaFK()
    w = np.linspace(0.5, 1.5, 6)
    return {
        'cauchy': (jk.CauchyKernel(0.7), tk.CauchyKernel(0.7), 6),
        'multiquadratic': (jk.MultiQuadratic(1.3), tk.MultiQuadratic(1.3), 6),
        'weighted': (jk.WeightedKernel(5.0, w), tk.WeightedKernel(5.0, w), 6),
        'tangent': (jk.TangentKernel(0.3, 0.1), tk.TangentKernel(0.3, 0.1),
                    6),
        'fk': (jk.FKKernel(jpanda.fkine, jk.RQKernel(10.0)),
               tk.FKKernel(tpanda.fkine, tk.RQKernel(10.0)), 7),
        'temporal_fk': (
            jk.TemporalFKKernel(jpanda.fkine, jk.RQKernel(10.0),
                                jk.RQKernel(2.0), alpha=0.5),
            tk.TemporalFKKernel(tpanda.fkine, tk.RQKernel(10.0),
                                tk.RQKernel(2.0), alpha=0.5), 8),
        'line': (jk.LineKernel(jk.RQKernel(3.0)),
                 tk.LineKernel(tk.RQKernel(3.0)), 6),
        'line_fk': (jk.LineFKKernel(jpanda.fkine, jk.RQKernel(10.0)),
                    tk.LineFKKernel(tpanda.fkine, tk.RQKernel(10.0)), 14),
    }


@pytest.mark.parametrize('name', sorted(_kernel_pairs()))
def test_kernel_classes_match(name):
    jf, tf, F = _kernel_pairs()[name]
    rng = np.random.default_rng(len(name))
    a = rng.uniform(-1, 1, size=(30, F)).astype(np.float32)
    b = rng.uniform(-1, 1, size=(20, F)).astype(np.float32)
    _close(tf(*_t(a, b)), jf(*_j(a, b)), 1e-5)


@pytest.mark.parametrize('cls', [tk.LineKernel, tk.LineFKKernel])
def test_line_kernels_reject_odd_widths(cls):
    kern = (cls(tk.RQKernel(1.0)) if cls is tk.LineKernel
            else cls(PandaFK().fkine, tk.RQKernel(1.0)))
    with pytest.raises(ValueError, match='endpoint'):
        kern(torch.zeros(3, 5), torch.zeros(2, 5))
    with pytest.raises(ValueError, match='endpoint'):
        kern(torch.zeros(3, 6), torch.zeros(2, 4))


def test_multidim_rq_kernel_and_rq_score_match():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(12, 3, 2)).astype(np.float32)
    b = rng.normal(size=(9, 3, 2)).astype(np.float32)
    out = tk.MultiDimRQKernel(2.0)(*_t(a, b))
    assert out.shape == (12, 9, 3)
    _close(out, jk.MultiDimRQKernel(2.0)(*_j(a, b)), 1e-5)
    x, s = rng.normal(size=(40, 6)), rng.normal(size=(25, 6))
    w = rng.normal(size=25)
    mask = np.arange(25) < 20
    x, s, w = (v.astype(np.float32) for v in (x, s, w))
    _close(rq_score(*_t(x, s, w), gamma=3.0, valid_mask=torch.from_numpy(
        mask)), j_rq_score(*_j(x, s, w), gamma=3.0,
                           valid_mask=jnp.asarray(mask)), 1e-5)


@pytest.mark.parametrize('beta,max_iteration', [(1.0, 900), (2.0, 30)])
def test_multiclass_train_loop_matches(beta, max_iteration):
    """Same Gram and [N, 2] labels: the same gains and iteration count (the
    second case stops at max_iteration before convergence)."""
    X, y = _data()
    K = np.array(jk.RQKernel(10.0)(*_j(X, X)))
    g_ref, h_ref, it_ref = jp.multiclass_train_loop(*_j(K, y), beta,
                                                    max_iteration, 2)
    g, h, it = tp.multiclass_train_loop(*_t(K, y), beta, max_iteration, 2)
    assert int(it) == int(it_ref)
    _close(g, g_ref, 1e-4)
    _close(h, h_ref, 1e-4)


def test_multidim_train_loop_matches():
    rng = np.random.default_rng(3)
    Xt = rng.normal(size=(80, 3, 2)).astype(np.float32)
    y = np.sign(rng.normal(size=80)).astype(np.float32)
    K = np.array(jk.MultiDimRQKernel(5.0)(*_j(Xt, Xt)))
    g_ref, h_ref, it_ref = jp.multidim_train_loop(*_j(K, y), 1.0, 600)
    g, h, it = tp.multidim_train_loop(*_t(K, y), 1.0, 600)
    assert int(it) == int(it_ref)
    _close(g, g_ref, 1e-4)
    _close(h, h_ref, 1e-4)


@pytest.mark.parametrize('kind', ['scalar', 'multiclass', 'multidim'])
def test_lazy_loop_equals_dense(kind):
    """Each lazy-row trainer runs the dense trainer's update sequence."""
    X, y = _data(N=120, seed=4)
    if kind == 'multidim':
        Xt = torch.from_numpy(X.reshape(120, 3, 2))
        kern = tk.MultiDimRQKernel(5.0)
        yv = torch.from_numpy(y[:, 0])
        dense = tp.multidim_train_loop(kern(Xt, Xt), yv, 1.0, 500)
        lazy = tp.multidim_train_loop_lazy(Xt, yv, kern, 1.0, 500)
    else:
        Xt = torch.from_numpy(X)
        kern = tk.RQKernel(10.0)
        K = kern(Xt, Xt)
        if kind == 'scalar':
            yv = torch.from_numpy(y[:, 0])
            dense = tp.perceptron_train_loop(K, yv, 1.0, 500)
            lazy = tp.perceptron_train_loop_lazy(Xt, yv, kern, 1.0, 500)
        else:
            yv = torch.from_numpy(y)
            dense = tp.multiclass_train_loop(K, yv, 1.0, 500, 2)
            lazy = tp.multiclass_train_loop_lazy(Xt, yv, kern, 1.0, 500, 2)
    assert int(dense[2]) == int(lazy[2]) < 500
    _close(lazy[0], dense[0], 1e-4)
    _close(lazy[1], dense[1], 1e-4)


def test_train_past_the_lazy_threshold_equals_dense():
    """DiffCo and MultiDiffCo take the lazy-row trainer past
    lazy_gram_threshold rows and select the same supports."""
    X, y = _data(N=200, seed=5)
    for cls, labels in ((tp.DiffCo, y[:, 0]), (tp.MultiDiffCo, y)):
        out = []
        for threshold in (16384, 100):
            p = cls(kernel_func=tk.RQKernel(10.0))
            p.lazy_gram_threshold = threshold
            p.train(*_t(X, labels), max_iteration=600)
            out.append(p)
        assert out[0].train_iterations == out[1].train_iterations
        assert torch.equal(out[0].support_points, out[1].support_points)
        _close(out[1].gains, out[0].gains, 1e-4)
        _close(out[1].kernel_matrix, out[0].kernel_matrix, 1e-5)


def _multi_pair(poly):
    X, y = _data(seed=6)
    ref = jp.MultiDiffCo(kernel_func=jk.RQKernel(10.0))
    ref.train(*_j(X, y), max_iteration=720)
    out = tp.MultiDiffCo(kernel_func=tk.RQKernel(10.0))
    out.train(*_t(X, y), max_iteration=720)
    if poly:
        ref.fit_poly(jk.Polyharmonic(1, 1.0), target='label')
        out.fit_poly(tk.Polyharmonic(1, 1.0), target='label')
    else:
        ref.fit_poly(target='label')    # the MultiQuadratic(1) default
        out.fit_poly(target='label')
    return ref, out


@pytest.mark.parametrize('poly', [False, True])
def test_multidiffco_matches(poly):
    """Same supports and per-class gains; the per-class surrogate solves
    agree to their float32 rounding; scores on fresh points."""
    ref, out = _multi_pair(poly)
    assert isinstance(out.rbf_kernel,
                      tk.Polyharmonic if poly else tk.MultiQuadratic)
    assert out.num_class == ref.num_class == 2
    assert out.train_iterations == ref.train_iterations
    assert out.num_valid == ref.num_valid
    _close(out.support_points, ref.support_points, 1e-6)
    _close(out.gains, ref.gains, 1e-4)
    assert out.rbf_nodes.shape == ref.rbf_nodes.shape
    Q = np.random.default_rng(7).uniform(-1, 1, size=(64, 6)).astype(
        np.float32)
    _close(out.score(*_t(Q)), ref.score(*_j(Q)), 1e-4)
    _close(out.predict(*_t(Q)), ref.predict(*_j(Q)), 0)
    _close(out.poly_score(*_t(Q)), ref.poly_score(*_j(Q)), 1e-2)
    # on the JAX nodes the surrogate scores agree to 1e-4
    out.rbf_nodes = torch.from_numpy(np.asarray(ref.rbf_nodes))
    _close(out.rbf_score(*_t(Q)), ref.rbf_score(*_j(Q)), 1e-4)


def test_full_poly_matches():
    """fit_full_poly / full_poly_score with [S, C] targets (inherited by
    MultiDiffCo) and with the scalar DiffCo's [S] targets."""
    ref, out = _multi_pair(poly=True)
    Q = np.random.default_rng(8).uniform(-1, 1, size=(32, 6)).astype(
        np.float32)
    ref.fit_full_poly(epsilon=1, k=2, target='label')
    out.fit_full_poly(epsilon=1, k=2, target='label')
    assert out.poly_nodes.shape == ref.poly_nodes.shape
    _close(out.full_poly_score(*_t(Q)), ref.full_poly_score(*_j(Q)), 1e-2)
    out.poly_nodes = torch.from_numpy(np.asarray(ref.poly_nodes))
    s = out.full_poly_score(*_t(Q))
    assert s.shape == (32, 2)
    _close(s, ref.full_poly_score(*_j(Q)), 1e-4)
    X, y = _data(N=150, seed=9)
    ref = jp.DiffCo(kernel_func=jk.RQKernel(10.0))
    out = tp.DiffCo(kernel_func=tk.RQKernel(10.0))
    ref.train(*_j(X, y[:, 0]), max_iteration=450)
    out.train(*_t(X, y[:, 0]), max_iteration=450)
    ref.fit_full_poly(target='label')
    out.fit_full_poly(target='label')
    out.poly_nodes = torch.from_numpy(np.asarray(ref.poly_nodes))
    _close(out.full_poly_score(*_t(Q)), ref.full_poly_score(*_j(Q)), 1e-4)


def test_line_predict_matches():
    ref, out = _multi_pair(poly=True)
    for a, b in ((CENTERS[0], -CENTERS[0]), (CENTERS[0] + 0.6, [0.9] * 3)):
        start = np.r_[a, 0.0, 0.0, 0.0].astype(np.float32)
        target = np.r_[b, 0.0, 0.0, 0.0].astype(np.float32)
        assert out.line_predict(*_t(start, target)) == ref.line_predict(
            *_j(start, target))


def test_diffcobeta_matches():
    """The perceptron on the head rows, then the distance regression over
    supports + left-out rows: same regression set, gains and scores."""
    X, _ = _data(N=260, seed=10)
    d = (0.5 - np.linalg.norm(X[:, :3] - CENTERS[0], axis=1)).astype(
        np.float32)
    ref = jp.DiffCoBeta(kernel_func=jk.RQKernel(10.0))
    out = tp.DiffCoBeta(kernel_func=tk.RQKernel(10.0))
    ref.train(*_j(X, d), max_iteration=600, n_left_out_points=40)
    out.train(*_t(X, d), max_iteration=600, n_left_out_points=40)
    assert out.num_valid == ref.num_valid
    _close(out.support_points, ref.support_points, 1e-6)
    _close(out.distance, ref.distance, 1e-6)
    _close(out.gains, ref.gains, 1e-2)
    _close(out.hypothesis, ref.hypothesis, 1e-3)
    _close(out.y, ref.y, 0)
    Q = np.random.default_rng(11).uniform(-1, 1, size=(50, 6)).astype(
        np.float32)
    _close(out.rbf_score(*_t(Q)), ref.rbf_score(*_j(Q)), 1e-3)
    with pytest.raises(ValueError, match='> 2 samples'):
        out.train(*_t(X[:2], d[:2]))


def _multidim_data(N=200, seed=12):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(N, 3, 2)).astype(np.float32)
    y = np.where(np.linalg.norm(X[:, 0] - 0.3, axis=-1) < 0.6, 1.0, -1.0)
    return X, y.astype(np.float32)


@pytest.mark.parametrize('lazy', [False, True])
def test_multidimdiffco_matches(lazy):
    """Vector gains over a [N, N, 3] Gram (or its lazy rows): the same
    supports (padded to a multiple of 64), gains and scores; the
    least-squares surrogate's scores."""
    X, y = _multidim_data()
    ref = jp.MultiDimDiffCo(kernel_func=jk.MultiDimRQKernel(5.0))
    out = tp.MultiDimDiffCo(kernel_func=tk.MultiDimRQKernel(5.0))
    if lazy:
        ref.lazy_gram_threshold = out.lazy_gram_threshold = 100
    ref.train(*_j(X, y), max_iteration=900)
    out.train(*_t(X, y), max_iteration=900)
    assert out.num_valid == ref.num_valid
    assert out.support_points.shape[0] == ref.support_points.shape[0]
    assert out.support_points.shape[0] % 64 == 0
    _close(out.support_points, ref.support_points, 1e-6)
    _close(out.gains, ref.gains, 1e-4)
    _close(out.kernel_matrix, ref.kernel_matrix, 1e-5)
    Q = np.random.default_rng(13).uniform(-1, 1, size=(40, 3, 2)).astype(
        np.float32)
    _close(out.score_original(*_t(Q)), ref.score_original(*_j(Q)), 1e-4)
    ref.fit_poly(jk.MultiDimRQKernel(5.0), target='label')
    out.fit_poly(tk.MultiDimRQKernel(5.0), target='label')
    _close(out.poly_score(*_t(Q)), ref.poly_score(*_j(Q)), 1e-2)


def test_update_and_mesh_raise():
    """The JAX package's update errors: MultiDimDiffCo without gains
    raises ValueError, RBFDiffCo.update without supports RuntimeError;
    labels without num_class columns raise. mesh= is ported (sharded
    training: tests/test_torch_parallel.py): the perceptron keeps it."""
    X, y = _data(N=20)
    with pytest.raises(ValueError, match='no gains'):
        tp.MultiDimDiffCo().train(*_t(X, y[:, 0]), update=True)
    ck = RBFDiffCo(robot=PandaFK(), gt_check_func=lambda q: None,
                   device='cpu')
    with pytest.raises(RuntimeError, match='no supports'):
        ck.update(num_samples=10)
    mesh = object()
    assert tp.MultiDimDiffCo(mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match='num_class'):
        tp.MultiDiffCo().train(*_t(X, y[:, 0]))


def test_reference_state_of_a_bare_perceptron():
    """load_reference_state fills a bare MultiDimDiffCo (vector kernel
    matrix, MultiDimRQKernel surrogate) and a MultiDiffCo (MultiQuadratic
    surrogate) from the JAX package's arrays."""
    X, y = _multidim_data(N=120, seed=14)
    ref = jp.MultiDimDiffCo(kernel_func=jk.MultiDimRQKernel(5.0))
    ref.train(*_j(X, y), max_iteration=600)
    ref.fit_poly(jk.MultiDimRQKernel(5.0), target='label')
    arrays = {k: np.asarray(getattr(ref, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')}
    arrays.update(rbf_kernel='MultiDimRQKernel', gamma=5.0)
    out = load_reference_state(
        tp.MultiDimDiffCo(kernel_func=tk.MultiDimRQKernel(5.0)), arrays,
        device='cpu')
    Q = X[:30]
    _close(out.poly_score(*_t(Q)), ref.poly_score(*_j(Q)), 1e-4)
    _close(out.score_original(*_t(Q)), ref.score_original(*_j(Q)), 1e-4)
    ref, _ = _multi_pair(poly=False)
    arrays = {k: np.asarray(getattr(ref, k)) for k in (
        'support_points', 'support_transformed', 'gains', 'hypothesis', 'y',
        'kernel_matrix', 'rbf_nodes', 'valid_mask', 'num_valid')}
    arrays.update(rbf_kernel='MultiQuadratic', epsilon=1.0)
    out = load_reference_state(tp.MultiDiffCo(kernel_func=tk.RQKernel(10.0)),
                               arrays, device='cpu')
    assert out.num_class == 2
    Q = np.random.default_rng(15).uniform(-1, 1, size=(20, 6)).astype(
        np.float32)
    _close(out.poly_score(*_t(Q)), ref.poly_score(*_j(Q)), 1e-4)
    with pytest.raises(ValueError, match='rbf_kernel'):
        load_reference_state(tp.MultiDiffCo(), dict(arrays, rbf_kernel='X'),
                             device='cpu')

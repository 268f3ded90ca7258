"""Port parity: the greedy kernel-perceptron trainer, support extraction,
the masked RBF solve and the kernel functions, fed the same numpy inputs
as the JAX package."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import kernels as jk
from diffco_tpu import perceptron as jp
from diffco_tpu_torch import kernels as tk
from diffco_tpu_torch import perceptron as tp

torch.set_num_threads(1)


def _data(N=300, F=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(N, F)).astype(np.float32)
    # a ball of collisions: a nonlinear boundary the perceptron must learn
    y = np.where(np.linalg.norm(X[:, :3], axis=1) < 0.6, 1.0, -1.0)
    return X, y.astype(np.float32)


@pytest.mark.parametrize('beta,max_iteration',
                         [(1.0, 900), (2.0, 900), (3.0, 40)])
def test_train_loop_identical(beta, max_iteration):
    """Same Gram and labels -> identical gains, hypothesis and iteration
    count (the last case stops at max_iteration before convergence)."""
    X, y = _data()
    K = np.array(jk.RQKernel(10.0)(jnp.asarray(X), jnp.asarray(X)))
    g_ref, h_ref, it_ref = jp.perceptron_train_loop(
        jnp.asarray(K), jnp.asarray(y), beta, max_iteration)
    g, h, it = tp.perceptron_train_loop(
        torch.from_numpy(K), torch.from_numpy(y), beta, max_iteration)
    assert int(it) == int(it_ref)
    np.testing.assert_array_equal(np.asarray(g_ref) != 0, g.numpy() != 0)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-6,
                               atol=1e-6)


def test_train_loop_valid_mask():
    X, y = _data(N=200, seed=1)
    K = np.array(jk.RQKernel(10.0)(jnp.asarray(X), jnp.asarray(X)))
    valid = np.arange(200) < 170
    ref = jp.perceptron_train_loop(jnp.asarray(K), jnp.asarray(y), 1.0, 600,
                                   valid_mask=jnp.asarray(valid))
    out = tp.perceptron_train_loop(torch.from_numpy(K), torch.from_numpy(y),
                                   1.0, 600,
                                   valid_mask=torch.from_numpy(valid))
    assert int(out[2]) == int(ref[2])
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('S', [64, 256])
def test_extract_supports_and_solve(S):
    rng = np.random.default_rng(2)
    gains = rng.normal(size=200).astype(np.float32)
    gains[rng.uniform(size=200) < 0.7] = 0.0
    idx_r, valid_r, nv_r = jp.extract_supports(jnp.asarray(gains), S)
    idx, valid, nv = tp.extract_supports(torch.from_numpy(gains), S)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    assert int(nv) == int(nv_r)
    X = rng.normal(size=(S, 5)).astype(np.float32)
    kmat = np.asarray(jk.Polyharmonic(1, 1.0)(jnp.asarray(X),
                                               jnp.asarray(X)))
    yv = rng.normal(size=S).astype(np.float32)
    ref = jp.masked_rbf_solve(jnp.asarray(kmat), jnp.asarray(yv), valid_r)
    out = tp.masked_rbf_solve(torch.from_numpy(kmat), torch.from_numpy(yv),
                              valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize('name', ['sqdist', 'rq', 'poly1', 'poly2', 'poly3'])
def test_kernel_functions_match(name):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(40, 21)).astype(np.float32)
    b = rng.normal(size=(30, 21)).astype(np.float32)
    if name == 'poly2':
        # even kernels use the exact difference: coincident rows give 0
        b = np.concatenate([a[:5], b])
    fns = {'sqdist': (jk.pairwise_sqdist, tk.pairwise_sqdist),
           'rq': (jk.RQKernel(10.0), tk.RQKernel(10.0)),
           'poly1': (jk.Polyharmonic(1, 2.0), tk.Polyharmonic(1, 2.0)),
           'poly2': (jk.Polyharmonic(2, 1.0), tk.Polyharmonic(2, 1.0)),
           'poly3': (jk.Polyharmonic(3, 1.0), tk.Polyharmonic(3, 1.0))}
    jf, tf = fns[name]
    ref = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
    out = tf(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_diffco_train_matches_on_raw_configs():
    """DiffCo.train + fit_poly on raw features: same supports, gains and
    surrogate as the JAX class, and the same scores on fresh points."""
    X, y = _data(N=250, seed=4)
    ref = jp.DiffCo(kernel_func=jk.RQKernel(10.0))
    ref.train(jnp.asarray(X), jnp.asarray(y), max_iteration=750)
    ref.fit_poly(jk.Polyharmonic(1, 1.0), target='label')
    out = tp.DiffCo(kernel_func=tk.RQKernel(10.0))
    out.train(torch.from_numpy(X), torch.from_numpy(y), max_iteration=750)
    out.fit_poly(tk.Polyharmonic(1, 1.0), target='label')
    assert out.train_iterations == ref.train_iterations
    assert out.num_valid == ref.num_valid
    np.testing.assert_allclose(out.support_points.numpy(),
                               np.asarray(ref.support_points), atol=1e-6)
    np.testing.assert_allclose(out.gains.numpy(), np.asarray(ref.gains),
                               rtol=1e-5, atol=1e-5)
    Q = np.random.default_rng(5).uniform(-1, 1, size=(64, 6)).astype(
        np.float32)
    np.testing.assert_allclose(
        out.poly_score(torch.from_numpy(Q)).numpy(),
        np.asarray(ref.poly_score(jnp.asarray(Q))), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        out.score_original(torch.from_numpy(Q)).numpy(),
        np.asarray(ref.score_original(jnp.asarray(Q))), rtol=1e-4,
        atol=1e-4)


def test_unported_branches_raise():
    """mesh= is ported (sharded training: tests/test_torch_parallel.py),
    so the perceptron keeps the mesh it is given; a warm start on a
    trained DiffCo without exist_mask raises (the JAX package asserts
    it)."""
    X, y = _data(N=20)
    mesh = object()
    assert tp.DiffCo(mesh=mesh).mesh is mesh
    p = tp.DiffCo()
    p.train(torch.from_numpy(X), torch.from_numpy(y), max_iteration=60)
    with pytest.raises(ValueError, match='exist_mask'):
        p.train(torch.from_numpy(X), torch.from_numpy(y), update=True)

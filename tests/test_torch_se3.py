"""The port's SE(3) maps (``diffco_tpu_torch.se3``), its SE(3) helpers of
``utils`` and ``RigidBody`` against the JAX package on the same numpy
inputs: every se3 function in float32 at 1e-5 and float64 at 1e-10, on
random rotations and twists, rotations with theta < 1e-4 and within 1e-3
of pi; their gradients finite at the identity and at coincident waypoints
through ``se3_interpolate`` and equal to the JAX gradients at 1e-4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffco_tpu import se3 as jse3
from diffco_tpu import utils as jutils
from diffco_tpu.geometry.mesh import load_mesh as jload_mesh
from diffco_tpu.robots import RigidBody as JRigidBody
import diffco_tpu_torch as tdc
from diffco_tpu_torch import se3 as tse3
from diffco_tpu_torch import utils as tutils

torch.set_num_threads(1)

TORUS = 'robot_data/generated/torus.stl'
TOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


def _omegas(rng, n):
    """Axis-angle vectors: random angles in (0, pi), angles below 1e-4 and
    angles within 1e-3 of pi (a third each)."""
    axis = rng.normal(size=(3 * n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = np.concatenate([rng.uniform(1e-3, np.pi - 1e-3, n),
                            rng.uniform(0.0, 1e-4, n),
                            np.pi - rng.uniform(0.0, 1e-3, n)])
    return axis * theta[:, None]


def _twists(rng, n):
    return np.concatenate([_omegas(rng, n), rng.normal(size=(3 * n, 3))], 1)


def _both(fn_name, dtype, *args):
    """fn_name of both packages on the numpy args in dtype (float64 with
    JAX's x64 mode)."""
    args = [np.array(a, dtype) for a in args]
    with jax.enable_x64(dtype == np.float64):
        j = np.asarray(jax.jit(getattr(jse3, fn_name))(*[jnp.asarray(a)
                                                for a in args]))
    t = getattr(tse3, fn_name)(*[torch.from_numpy(a) for a in args]).numpy()
    assert t.dtype == j.dtype == dtype, (fn_name, t.dtype, j.dtype)
    return t, j


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_se3_maps_match_reference(dtype):
    """Every function of se3 on the same inputs in both packages: 1e-5 in
    float32, 1e-10 in float64."""
    rng = np.random.default_rng(0)
    tol = TOL[dtype]
    omega = _omegas(rng, 32)
    xi = _twists(rng, 32)
    R = np.asarray(_both('exp_so3', np.float64, omega)[1])
    T = np.asarray(_both('exp_se3', np.float64, xi)[1])
    # T1 rolled by a third: no pair of two small rotations, whose relative
    # rotation would fall in the band below, where the reference loses
    # digits (test_se3_small_angle_band)
    T1 = np.roll(_both('exp_se3', np.float64, _twists(rng, 32))[1], 32, 0)
    quat = rng.normal(size=(96, 4))
    cases = [('skew', omega), ('unskew', _both('skew', dtype, omega)[1]),
             ('exp_so3', omega), ('matrix_to_quaternion', R),
             ('quaternion_to_matrix', quat),
             ('axis_angle_to_quaternion', omega),
             ('quaternion_to_axis_angle', quat), ('log_so3', R),
             ('exp_se3', xi), ('log_se3', T), ('se3_inverse', T),
             ('se3_interpolate', T, T1, np.float64(0.3)),
             ('se3_interpolate', T, T1, np.linspace(0, 1, 5)),
             ('integrate_axis_angle', omega, omega[::-1], np.float64(0.1)),
             ('angular_error', omega, omega[::-1])]
    for name, *args in cases:
        t, j = _both(name, dtype, *args)
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=name)
    # the new K axis of se3_interpolate comes before the matrix axes
    t, _ = _both('se3_interpolate', dtype, T, T1, np.linspace(0, 1, 5))
    assert t.shape == (96, 5, 4, 4)


def test_se3_small_angle_band():
    """Rotations of 1e-4 to 1e-2 rad (close waypoints): in float32 the
    port's exp_se3, log_se3 and se3_interpolate stay within 1e-5 of its
    float64 results. The reference's float32 log_se3 gives NaN there
    (1 - cos(theta) rounds to 0 below ~2.4e-4 and is divided by): the port
    writes 1 - cos as 2 sin^2(theta / 2)."""
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(512, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = 10 ** rng.uniform(-4, -2, 512)
    xi = np.concatenate([axis * theta[:, None], rng.normal(size=(512, 3))],
                        1).astype(np.float32)
    x32 = torch.from_numpy(xi)
    T32 = tse3.exp_se3(x32)
    torch.testing.assert_close(T32.double(), tse3.exp_se3(x32.double()),
                               rtol=0, atol=1e-5)
    L32 = tse3.log_se3(T32)
    assert bool(torch.isfinite(L32).all())
    torch.testing.assert_close(L32.double(), tse3.log_se3(T32.double()),
                               rtol=0, atol=1e-5)
    ts = torch.linspace(0, 1, 5)
    T0 = tse3.exp_se3(torch.from_numpy(_twists(rng, 8).astype(np.float32)))
    T1 = tse3.matmul_f32(T0, T32[:24])
    torch.testing.assert_close(
        tse3.se3_interpolate(T0, T1, ts).double(),
        tse3.se3_interpolate(T0.double(), T1.double(), ts.double()),
        rtol=0, atol=1e-5)
    assert np.isnan(np.asarray(jax.jit(jse3.log_se3)(
        jnp.asarray(T32.numpy())))).any()


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_se3_round_trips(dtype):
    """log(exp(x)) = x on the three angle regimes, in the port alone."""
    rng = np.random.default_rng(1)
    xi = torch.from_numpy(_twists(rng, 32).astype(dtype))
    back = tse3.log_se3(tse3.exp_se3(xi))
    atol = 1e-3 if dtype == np.float32 else 1e-9   # theta ~ pi in float32
    torch.testing.assert_close(back, xi, rtol=0, atol=atol)
    R = tse3.exp_so3(xi[:, :3])
    torch.testing.assert_close(tse3.exp_so3(tse3.log_so3(R)), R, rtol=0,
                               atol=10 * TOL[dtype])


def _grad_cases():
    """(name, f_jax, f_torch, input): scalar functions (a weighted sum of a
    map's output) of one [N, 6] input whose gradients are compared, with
    inputs at the identity and at coincident waypoints."""
    rng = np.random.default_rng(2)
    xi = _twists(rng, 8)
    w44, w6 = rng.normal(size=(4, 4)), rng.normal(size=6)
    wk = rng.normal(size=(5, 4, 4))
    ts = np.linspace(0, 1, 5)

    def exp(m, xp):
        return lambda x: (m.exp_se3(x) * xp.asarray(w44, dtype=x.dtype)).sum()

    def log_exp(m, xp):
        return lambda x: (m.log_se3(m.exp_se3(x))
                          * xp.asarray(w6, dtype=x.dtype)).sum()

    def interp(m, xp):
        def f(x):
            n = x.shape[0] // 2
            out = m.se3_interpolate(m.exp_se3(x[:n]), m.exp_se3(x[n:]),
                                    xp.asarray(ts, dtype=x.dtype))
            return (out * xp.asarray(wk, dtype=x.dtype)).sum()
        return f

    zero = np.zeros((8, 6))
    same = np.concatenate([xi[:8], xi[:8]])
    return [('exp_se3 at the identity', exp, zero), ('exp_se3', exp, xi),
            ('log_se3 o exp_se3 at the identity', log_exp, zero),
            ('log_se3 o exp_se3', log_exp, xi),
            ('se3_interpolate, coincident waypoints', interp, same),
            ('se3_interpolate', interp, xi)]


@pytest.mark.parametrize('case', range(6))
def test_se3_gradients_match_reference(case):
    """Gradients of the maps, finite at the identity and at coincident
    waypoints, equal to the JAX package's at 1e-4 (float32)."""
    name, f, x = _grad_cases()[case]
    x = x.astype(np.float32)
    gj = np.asarray(jax.jit(jax.grad(f(jse3, jnp)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt, = torch.autograd.grad(f(tse3, torch)(xt), xt)
    assert np.isfinite(gt.numpy()).all(), name
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-4,
                               err_msg=name)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_se3_utils_match_reference(dtype):
    """roty, rotx, euler2mat, transform_points, look_mat4 at 1e-5
    (float32) and 1e-10 (float64)."""
    rng = np.random.default_rng(3)
    phi = rng.uniform(-np.pi, np.pi, (64, 3)).astype(dtype)
    pts = rng.normal(size=(64, 5, 3)).astype(dtype)
    tol = TOL[dtype]
    with jax.enable_x64(dtype == np.float64):
        jR = jutils.euler2mat(jnp.asarray(phi))
        ref = [jutils.roty(jnp.asarray(phi[:, 0])),
               jutils.rotx(jnp.asarray(phi[:, 1])), jR,
               jutils.transform_points(jR, jnp.asarray(phi),
                                       jnp.asarray(pts)),
               jutils.look_mat4(jR, jnp.asarray(phi))]
        ref = [np.asarray(r) for r in ref]
    tphi, tpts = torch.from_numpy(phi), torch.from_numpy(pts)
    tR = tutils.euler2mat(tphi)
    out = [tutils.roty(tphi[:, 0]), tutils.rotx(tphi[:, 1]), tR,
           tutils.transform_points(tR, tphi, tpts),
           tutils.look_mat4(tR, tphi)]
    for o, r in zip(out, ref):
        assert o.dtype == DTYPES[dtype]
        np.testing.assert_allclose(o.numpy(), r, rtol=tol, atol=tol)


def test_rigid_body_matches_reference():
    """RigidBody.from_vertices on the torus mesh's vertices (keypoints
    [3, 8]), fkine at 1e-5, wrap at 1e-6, and a body given by [M, 3]
    keypoints; rand_configs draws inside the limits on the CPU."""
    verts, _ = jload_mesh(TORUS)
    jb = JRigidBody.from_vertices(verts)
    tb = tdc.RigidBody.from_vertices(verts)
    assert tb.keypoints.shape == (3, 8)
    np.testing.assert_array_equal(tb.keypoints.numpy(),
                                  np.asarray(jb.keypoints))
    np.testing.assert_array_equal(tb.limits.numpy(), np.asarray(jb.limits))
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.uniform(-3, 3, (256, 3)),
                        rng.uniform(-4, 4, (256, 3))], 1).astype(np.float32)
    np.testing.assert_allclose(tb.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jb.fkine(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.wrap(torch.from_numpy(q)).numpy(),
                               np.asarray(jb.wrap(jnp.asarray(q))),
                               rtol=0, atol=1e-6)
    probe = np.asarray([[-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0]], np.float32)
    jp, tp = JRigidBody(probe), tdc.RigidBody(probe)
    np.testing.assert_array_equal(tp.keypoints.numpy(),
                                  np.asarray(jp.keypoints))
    np.testing.assert_allclose(tp.fkine(torch.from_numpy(q)).numpy(),
                               np.asarray(jp.fkine(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-5)
    qs = tp.rand_configs(64, torch.Generator().manual_seed(0), 'cpu')
    assert qs.shape == (64, 6)
    assert bool(((qs >= tp.limits[:, 0]) & (qs <= tp.limits[:, 1])).all())

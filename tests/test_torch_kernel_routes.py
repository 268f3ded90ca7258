"""The one-pass FK kernels' instance by shape. The JAX package takes its
kernels at every size, and so do the port's routers; the kernels B1, B3,
B4 and B5 pick their instance from the robot's shape: within their
tensor-core and multi-class blocks' bounds (``ops/_native.py``: MAX_J,
MAX_P, MAX_M, MAX_D, MAX_CP) the by-value spec, past them the wide
instance's (``csrc/chain_wide.cuh``, up to WIDE_MAX_M, WIDE_MAX_D and
WIDE_MAX_CP), and past that a ValueError. A 20-link rope and a 9-joint
DH chain take the wide instance, the catalogue robots do not; the rope's
score matches the JAX package's (1e-4) on the same numpy inputs."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffco_tpu as jdc
from diffco_tpu.ops import fk_score as jfk
import diffco_tpu_torch as tdc
from diffco_tpu_torch import robot_data
from diffco_tpu_torch.ops import _native, fk_score
from diffco_tpu_torch.robots.analytic import (DHChainRobot, DHParameters,
                                              baxter_arm, panda_with_points)

torch.set_num_threads(1)


def _dh9():
    """A 9-joint DH chain with a point on every frame (J = 9 > MAX_J)."""
    n = 9
    return DHChainRobot(DHParameters(a=[0.1] * n, alpha=[0.5] * n,
                                     d=[0.05] * n, theta=[0.0] * n),
                        [[-np.pi, np.pi]] * n, [True] * n)


def _urdf(name, tmp_path, **kw):
    if name.startswith('rope'):
        n = int(name[4:])
        path = robot_data.generate_rope_urdf(
            n_links=n, path=str(tmp_path / f'{name}.urdf'))
    elif name == 'marked rope':
        path = robot_data.generate_marked_rope_urdf(
            path=str(tmp_path / 'marked.urdf'))
    else:
        path = os.path.join(robot_data.ensure_default_assets(), name)
    return tdc.URDFRobot(path, device='cpu', setup_acm=False,
                         link_spheres=1, **kw)


def _dh_spec_of(robot):
    return fk_score._c_spec(fk_score.robot_spec(robot))


def test_dh_route_by_shape():
    """B1 and B4 take the catalogue DH robots on their by-value DHSpec, a
    9-joint chain and a 17-point one on the wide instance (the chain
    folded: J revolute joints, one dof each), and raise past 64 joints."""
    assert _native.MAX_J == 8 and _native.MAX_P == 16
    for robot in (tdc.PandaFK(), baxter_arm(), panda_with_points(16)):
        assert isinstance(_dh_spec_of(robot), _native.DHSpec)
    for robot, (J, P) in ((_dh9(), (9, 9)), (panda_with_points(17),
                                              (7, 17))):
        c = _dh_spec_of(robot)
        assert isinstance(c, _native.ChainSpecWide)
        assert (c.M, c.D, c.P) == (J, J, P)
        assert list(c.mparent[:J]) == list(range(-1, J - 1))
    n = _native.WIDE_MAX_M + 1
    with pytest.raises(ValueError, match='moving joints'):
        _dh_spec_of(DHChainRobot(DHParameters(
            a=[0.1] * n, alpha=[0.5] * n, d=[0.05] * n, theta=[0.0] * n),
            [[-np.pi, np.pi]] * n, [True] * 4 + [False] * (n - 4)))


@pytest.mark.parametrize('name,takes', [
    ('panda_simple.urdf', True), ('panda_simple_no_gripper.urdf', True),
    ('trifinger_simple.urdf', True), ('lift_rig.urdf', True),
    ('2link_robot.urdf', True), ('marked rope', True), ('rope12', True),
    ('rope20', False), ('rope35', False), ('rope70', None)])
def test_chain_route_by_shape(tmp_path, name, takes):
    """B3 and B5 take a chain on their by-value ChainSpec (``takes``) or on
    the wide instance's ChainSpecWide: the rope from 17 links on (the
    35-link rope: 35 moving joints, 34 points, F = 102); past 64 moving
    joints (the 70-link rope) the kernel raises (``takes`` None)."""
    cs = fk_score.robot_chain_statics(_urdf(name, tmp_path))
    if takes is None:
        with pytest.raises(ValueError, match='moving joints'):
            fk_score._c_chain_spec(cs)
        return
    c = fk_score._c_chain_spec(cs)
    assert isinstance(c, _native.ChainSpec if takes
                      else _native.ChainSpecWide)
    if name == 'rope35':
        assert (c.M, c.D, c.P) == (35, 35, 34)


def test_routers_keep_the_cpu_and_multi_robots_on_fk_and_b2(tmp_path):
    """On the CPU no router takes a one-pass route, whatever the robot;
    a MultiURDFRobot takes none on any device (the JAX package's routers
    take only a single DH or URDF chain)."""
    panda = _urdf('panda_simple.urdf', tmp_path)
    q = torch.zeros(fk_score._FK_FUSED_MIN_BATCH, 7)
    assert not fk_score.chain_score_grad_available(panda, q)
    assert not fk_score.dh_score_grad_available(tdc.PandaFK(), q)
    multi = tdc.MultiURDFRobot([panda, panda])
    assert not fk_score.chain_score_grad_available(multi, q)
    assert not fk_score.dh_score_grad_available(multi, q)


def test_rope_beyond_the_bounds_scores_as_the_reference(tmp_path):
    """The 20-link rope (20 moving joints, 19 points, past the narrow
    kernels' bounds): its score through fk_polyharmonic_score_auto and
    the multi-class router against the JAX package's on the same numpy
    configurations, supports and weights (1e-4)."""
    rope = _urdf('rope20', tmp_path)
    jrope = jdc.URDFRobot(rope.urdf_path, setup_acm=False, link_spheres=1)
    rng = np.random.default_rng(0)
    lims = rope.joint_limits.numpy()
    def draw(n):
        u = rng.uniform(size=(n, 20))
        return (u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]).astype(
            np.float32)
    q, qs = draw(300), draw(64)
    sup = np.array(jrope.fkine(jnp.asarray(qs))).reshape(64, -1)
    assert sup.shape[1] == 57
    w = (rng.normal(size=64) * 0.05).astype(np.float32)
    W = (rng.normal(size=(64, 3)) * 0.05).astype(np.float32)
    out = fk_score.fk_polyharmonic_score_auto(
        torch.from_numpy(q), rope, torch.from_numpy(sup), torch.from_numpy(w))
    ref = jfk.fk_polyharmonic_score_auto(jnp.asarray(q), jrope,
                                         jnp.asarray(sup), jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    out = fk_score.fk_polyharmonic_multi_score_auto(
        torch.from_numpy(q), rope, torch.from_numpy(sup), torch.from_numpy(W))
    ref = jfk.fk_polyharmonic_multi_score_auto(
        jnp.asarray(q), jrope, jnp.asarray(sup), jnp.asarray(W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)

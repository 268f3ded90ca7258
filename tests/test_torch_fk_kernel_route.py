"""The DH FK's route (robots/fk_jvp.py::_DHFkine): a float32 CUDA batch of
a chain within the kernels' bounds takes csrc/dh_fk.cu, forward and, where
no graph of the gradient is built, backward; everything else keeps the
eager ops. And the by-value spec that each ``make_dh_fkine`` keeps. No
card needed: the route is decided on the tensor's metadata alone."""
import types

import numpy as np
import pytest
import torch

import diffco_tpu_torch as tdc
from diffco_tpu_torch import profiling
from diffco_tpu_torch.ops import _native, fk_score
from diffco_tpu_torch.robots import fk_jvp
from diffco_tpu_torch.robots.analytic import (DHChainRobot, DHParameters,
                                              panda_with_points)

torch.set_num_threads(1)


def _on_card(dtype=torch.float32, row_stride=7):
    """A stand-in for a [B, J] CUDA tensor: the metadata that
    ``takes_kernel`` reads (a row stride past J: a block of columns)."""
    return types.SimpleNamespace(device=torch.device('cuda'), dtype=dtype,
                                 dim=lambda: 2,
                                 stride=lambda d: (row_stride, 1)[d])


def _dh9():
    n = 9
    return DHChainRobot(DHParameters(a=[0.1] * n, alpha=[0.5] * n,
                                     d=[0.05] * n, theta=[0.0] * n),
                        [[-np.pi, np.pi]] * n, [True] * n)


def _spec(robot):
    return robot._fkine_flat.dh_spec


def _route(q, c, g, grad):
    """``takes_kernel`` with grad mode ``grad``: the forward (``g`` None),
    a backward with a plain cotangent, or one with the cotangent that
    ``torch.autograd.functional.jacobian(vectorize=True)`` hands a
    backward, batched by vmap and with no storage (the scipy paths'
    Jacobians, ``optim._jacobian``)."""
    if g != 'jacobian':
        with torch.set_grad_enabled(grad):
            return fk_jvp.takes_kernel(q, c, None if g is None else
                                       torch.zeros(4, 3 * c.P))
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(x):
            return x.clone()

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def backward(ctx, cot):
            seen.append(fk_jvp.takes_kernel(q, c, cot))
            return cot

    torch.autograd.functional.jacobian(Probe.apply, torch.zeros(3 * c.P),
                                       vectorize=True)
    assert len(seen) == 1
    return seen[0]


# (case, q, the chain's spec, the cotangent (None: the forward), grad mode
# on, takes the kernel)
ROUTES = {
    'cpu': (lambda: torch.zeros(4, 7), tdc.BaxterLeftArmFK, None, False,
            False),
    'float64': (lambda: _on_card(torch.float64), tdc.BaxterLeftArmFK, None,
                False, False),
    'J = 9': (lambda: _on_card(row_stride=9), _dh9, None, False, False),
    'P = 17': (lambda: _on_card(), lambda: panda_with_points(17), None,
               False, False),
    'backward, grad enabled': (_on_card, tdc.BaxterLeftArmFK, 'plain', True,
                               False),
    'backward, vectorized Jacobian': (_on_card, tdc.BaxterLeftArmFK,
                                      'jacobian', False, False),
    'forward': (_on_card, tdc.BaxterLeftArmFK, None, True, True),
    'backward, no grad': (_on_card, tdc.PandaFK, 'plain', False, True),
    'column block': (lambda: _on_card(row_stride=14), tdc.BaxterLeftArmFK,
                     'plain', False, True),
}


@pytest.mark.parametrize('case', list(ROUTES))
def test_dh_fk_route(case):
    """``takes_kernel`` sends a float32 CUDA batch within MAX_J and MAX_P
    to the kernels and keeps the CPU, float64, 9 joints, 17 points, a
    backward that builds a graph (``create_graph=True``) and a backward
    batched by vmap (a vectorized Jacobian) on the eager ops; on the CPU
    the eager ops run and no kernel is counted."""
    make_q, make_robot, g, grad, takes = ROUTES[case]
    robot = make_robot()
    spec = _spec(robot)
    assert _route(make_q(), spec, g, grad) is takes
    if case == 'cpu':
        before = (profiling.counter('launches.dh_fk'),
                  profiling.counter('launches.dh_fk_vjp'))
        q = robot.rand_configs(5, torch.Generator().manual_seed(0),
                               'cpu').requires_grad_()
        x = robot.fkine(q, flat=True)
        dq, = torch.autograd.grad(x.sum(), q)
        ref = robot._fkine_soa_autodiff(q, flat=True)
        ref_dq, = torch.autograd.grad(ref.sum(), q)
        torch.testing.assert_close(x, ref)
        torch.testing.assert_close(dq, ref_dq)
        assert (profiling.counter('launches.dh_fk'),
                profiling.counter('launches.dh_fk_vjp')) == before


def _dual_arm_base():
    return tdc.BaxterDualArmFK()._arm_fkine[1]


SPEC_CASES = {
    'Baxter': lambda: tdc.BaxterLeftArmFK()._fkine_flat,
    'PandaFK': lambda: tdc.PandaFK()._fkine_flat,
    'PandaFK chain, 16 points': lambda: panda_with_points(16)._fkine_flat,
    "the dual arm's right base": _dual_arm_base,
}


@pytest.mark.parametrize('name', list(SPEC_CASES))
def test_dh_spec_on_the_closure_holds_the_statics(name):
    """The DHSpec built once by ``make_dh_fkine`` holds the chain's statics
    field by field in float32 (zeros past J and P), as B1's argument for
    the same chain does."""
    fk = SPEC_CASES[name]()
    st, c = fk.statics, fk.dh_spec
    J, P = st.n_joints, len(st.point_specs)
    assert isinstance(c, _native.DHSpec) and (c.J, c.P) == (J, P)
    f32 = np.float32
    dh = np.array([list(r) for r in c.dh], f32)
    np.testing.assert_array_equal(dh[:J], np.array(st.dh_const, f32))
    assert not dh[J:].any()
    assert list(c.frame) == st.frame_ids + [0] * (_native.MAX_P - P)
    off = np.array([list(o) for o in c.off], f32)
    np.testing.assert_array_equal(
        off[:P], np.array([o for _, o in st.point_specs], f32))
    assert not off[P:].any()
    np.testing.assert_array_equal(np.array(list(c.base_r), f32),
                                  np.array(st.base_rot, f32))
    np.testing.assert_array_equal(np.array(list(c.base_t), f32),
                                  np.array(st.base_trans, f32))
    if name == "the dual arm's right base":
        assert st.base_rot != fk_jvp._IDENT9 and st.base_trans != (0, 0, 0)
    else:
        spec = (st.dh_const, st.point_specs, None
                if st.base_rot == fk_jvp._IDENT9
                and st.base_trans == fk_jvp._ZERO3 else
                (st.base_rot, st.base_trans))
        assert bytes(c) == bytes(fk_score._c_spec(spec))

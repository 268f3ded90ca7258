"""Flattened-chain forward kinematics (PyTorch counterpart of
``diffco_tpu/robots/kinematics.py``).

A robot's kinematic tree is a static, topologically sorted array program:
per-link constant data lives in float32 numpy arrays (``ChainSpec``) and FK
composes (R, t) pairs down the sorted links.

Conventions:
  * links are topologically sorted: ``parent[i] < i``, root has parent -1;
  * each link's joint connects it to its parent; fixed links use the fixed
    origin transform only;
  * revolute joints rotate about an arbitrary unit axis (Rodrigues);
  * mimic joints read another joint's dof and apply ``mult * q + offset``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import fp32_matmul
from ..utils import axis_angle_mat

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of a kinematic chain."""
    link_names: Tuple[str, ...]
    parent: np.ndarray          # int [L], parent[i] < i, root = -1
    jtype: np.ndarray           # int [L] in {FIXED, REVOLUTE, PRISMATIC}
    axis: np.ndarray            # float [L, 3] unit joint axes
    fixed_rot: np.ndarray       # float [L, 3, 3] joint origin rotation
    fixed_trans: np.ndarray     # float [L, 3] joint origin translation
    dof_idx: np.ndarray         # int [L], -1 for fixed links
    mimic_mult: np.ndarray      # float [L]
    mimic_offset: np.ndarray    # float [L]
    joint_limits: np.ndarray    # float [n_dofs, 2]
    joint_names: Tuple[str, ...] = ()
    # collision geometry: per-link list of (origin 4x4, shape descriptor)
    collision_origins: Tuple[Tuple[np.ndarray, ...], ...] = ()

    @property
    def n_links(self) -> int:
        return len(self.link_names)

    @property
    def n_dofs(self) -> int:
        return int(self.dof_idx.max()) + 1 if (self.dof_idx >= 0).any() else 0

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)

    @property
    def unique_position_link_names(self) -> Tuple[str, ...]:
        """Links whose joint origin has a nonzero translation: the control
        points of ForwardKinematicsDiffCo."""
        return tuple(
            n for n, t in zip(self.link_names, self.fixed_trans)
            if np.any(t != 0))


def fk_link_poses(spec: ChainSpec, q,
                  base_rot=None, base_trans=None):
    """Batched FK of every link: q [B, n_dofs] -> (rot [B, L, 3, 3],
    trans [B, L, 3]) world poses of the link frames.

    The per-joint local transforms are built for all links at once, then
    composed down the sorted chain in full float32; an optional base
    transform (numpy 3x3 and 3-vector) is applied last.
    """
    dt, dev = q.dtype, q.device
    B, L = q.shape[0], spec.n_links

    def const(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    fixed_rot, fixed_trans = const(spec.fixed_rot), const(spec.fixed_trans)
    axis = const(spec.axis)
    dof = torch.as_tensor(np.maximum(spec.dof_idx, 0), device=dev)
    qpad = q if spec.n_dofs else q.new_zeros(B, 1)
    theta = torch.where(                                           # [B, L]
        torch.as_tensor(spec.dof_idx >= 0, device=dev),
        qpad[:, dof] * const(spec.mimic_mult) + const(spec.mimic_offset),
        q.new_zeros(()))
    revolute = torch.as_tensor(spec.jtype == REVOLUTE, device=dev)
    prismatic = const(spec.jtype == PRISMATIC)
    eye = torch.eye(3, dtype=dt, device=dev)
    rot_j = torch.where(revolute[:, None, None],
                        axis_angle_mat(axis, theta), eye)      # [B, L, 3, 3]
    with fp32_matmul():
        j_rot = fixed_rot @ rot_j
        j_trans = fixed_trans + prismatic[:, None] * torch.einsum(
            'lij,blj->bli', fixed_rot, axis * theta[..., None])
        rots: List[torch.Tensor] = []
        trans: List[torch.Tensor] = []
        for i in range(L):
            p = int(spec.parent[i])
            if p < 0:
                rots.append(j_rot[:, i])
                trans.append(j_trans[:, i])
            else:
                rots.append(rots[p] @ j_rot[:, i])
                trans.append(trans[p] + (rots[p] @ j_trans[:, i, :, None])
                             [..., 0])
        rot = torch.stack(rots, 1)
        tr = torch.stack(trans, 1)
        if base_rot is not None:
            br, bt = const(base_rot), const(base_trans)
            tr = torch.einsum('ij,blj->bli', br, tr) + bt
            rot = torch.einsum('ij,bljk->blik', br, rot)
    return rot, tr


def fk_selected_positions(spec: ChainSpec, q, link_indices,
                          base_rot=None, base_trans=None):
    """Positions of selected links only: [B, len(sel), 3]."""
    _, tr = fk_link_poses(spec, q, base_rot, base_trans)
    return tr[:, list(link_indices)]


def fk_collision_pieces(spec: ChainSpec, q, base_rot=None, base_trans=None):
    """World poses of every collision piece: (rot [B, P, 3, 3],
    trans [B, P, 3]), the concatenation over links of each link pose
    composed with its collision-origin transforms."""
    rot, tr = fk_link_poses(spec, q, base_rot, base_trans)
    piece_rots, piece_trans = [], []
    with fp32_matmul():
        for li, origins in enumerate(spec.collision_origins):
            for origin in origins:
                o = torch.as_tensor(np.asarray(origin), dtype=tr.dtype,
                                    device=tr.device)
                piece_rots.append(rot[:, li] @ o[:3, :3])
                piece_trans.append(tr[:, li] + rot[:, li] @ o[:3, 3])
    if not piece_rots:
        return (tr.new_zeros(q.shape[0], 0, 3, 3),
                tr.new_zeros(q.shape[0], 0, 3))
    return torch.stack(piece_rots, 1), torch.stack(piece_trans, 1)


def chain_from_joint_list(joints: List[dict], root_name: str = 'base',
                          joint_limits: Optional[np.ndarray] = None
                          ) -> ChainSpec:
    """Build a ChainSpec from a list of joint dicts (host side, build time).

    Each dict: {name, parent, child, type, axis, origin_rot (3x3),
    origin_trans (3,), limits (lo, hi) or None, mimic (src_joint, mult,
    offset) or None, collision_origins: [4x4, ...]}.
    """
    by_child = {}
    children: Dict[str, List[str]] = {root_name: []}
    for j in joints:
        by_child[j['child']] = j
        children.setdefault(j['parent'], []).append(j['child'])
        children.setdefault(j['child'], [])
    # topological order (DFS from root)
    order: List[str] = []
    stack = [root_name]
    while stack:
        n = stack.pop()
        order.append(n)
        stack.extend(reversed(children.get(n, [])))
    name_to_idx = {n: i for i, n in enumerate(order)}

    L = len(order)
    parent = np.full(L, -1, np.int32)
    jtype = np.zeros(L, np.int32)
    axis = np.zeros((L, 3), np.float32)
    axis[:, 2] = 1.0
    fixed_rot = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    fixed_trans = np.zeros((L, 3), np.float32)
    dof_idx = np.full(L, -1, np.int32)
    mimic_mult = np.ones(L, np.float32)
    mimic_offset = np.zeros(L, np.float32)
    collision_origins: List[Tuple[np.ndarray, ...]] = [() for _ in range(L)]
    joint_names: List[str] = [''] * L

    tmap = {'fixed': FIXED, 'revolute': REVOLUTE, 'continuous': REVOLUTE,
            'prismatic': PRISMATIC}
    unsupported = [j['name'] for j in joints if j['type'] not in tmap]
    if unsupported:
        # 'floating' (6 dof) / 'planar' (3 dof) must not silently weld the
        # child in place: that produces plausible-looking wrong FK
        raise ValueError(
            f'unsupported URDF joint type(s) on {unsupported}: only '
            f'fixed/revolute/continuous/prismatic (+ mimic) are modeled; '
            f'decompose floating/planar joints into single-dof joints')
    n_dofs = 0
    limits: List[Tuple[float, float]] = []
    joint_dof: Dict[str, int] = {}
    # first pass: assign dofs to non-mimic movable joints in order
    for n in order[1:]:
        j = by_child[n]
        if tmap[j['type']] != FIXED and j.get('mimic') is None:
            joint_dof[j['name']] = n_dofs
            n_dofs += 1
            lo, hi = j.get('limits') or (-np.pi, np.pi)
            if j['type'] == 'continuous':
                lo, hi = -2 * np.pi, 2 * np.pi
            limits.append((lo, hi))
    mimic_by_name = {jj['name']: jj for jj in joints}
    for n in order[1:]:
        j = by_child[n]
        i = name_to_idx[n]
        parent[i] = name_to_idx[j['parent']]
        jtype[i] = tmap[j['type']]
        joint_names[i] = j['name']
        if j.get('axis') is not None:
            a = np.asarray(j['axis'], np.float32)
            nrm = np.linalg.norm(a)
            axis[i] = a / nrm if nrm > 0 else np.array([0, 0, 1], np.float32)
        fixed_rot[i] = np.asarray(j['origin_rot'], np.float32)
        fixed_trans[i] = np.asarray(j['origin_trans'], np.float32)
        if jtype[i] != FIXED:
            if j.get('mimic') is not None:
                # resolve mimic chains transitively (C mimics B mimics A
                # => q_C = m_C * (m_B * q_A + o_B) + o_C), with cycle and
                # dangling-source detection
                src, mult, off = j['mimic']
                seen = {j['name']}
                while src not in joint_dof:
                    if src in seen:
                        raise ValueError(
                            f'mimic cycle involving joint {src!r}')
                    seen.add(src)
                    src_j = mimic_by_name.get(src)
                    if src_j is None:
                        raise ValueError(
                            f'joint {j["name"]!r} mimics unknown joint '
                            f'{src!r}')
                    if src_j.get('mimic') is None:
                        raise ValueError(
                            f'joint {j["name"]!r} mimics {src!r} which '
                            f'owns no dof (fixed joint?)')
                    s2, m2, o2 = src_j['mimic']
                    # fold the source's mimic into ours
                    off = mult * o2 + off
                    mult = mult * m2
                    src = s2
                dof_idx[i] = joint_dof[src]
                mimic_mult[i] = mult
                mimic_offset[i] = off
            else:
                dof_idx[i] = joint_dof[j['name']]
        collision_origins[i] = tuple(
            np.asarray(c, np.float32) for c in j.get('collision_origins', ()))
    if joint_limits is None:
        joint_limits = np.asarray(limits, np.float32).reshape(n_dofs, 2)
    return ChainSpec(
        link_names=tuple(order), parent=parent, jtype=jtype, axis=axis,
        fixed_rot=fixed_rot, fixed_trans=fixed_trans, dof_idx=dof_idx,
        mimic_mult=mimic_mult, mimic_offset=mimic_offset,
        joint_limits=np.asarray(joint_limits, np.float32),
        joint_names=tuple(joint_names),
        collision_origins=tuple(collision_origins))

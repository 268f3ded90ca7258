"""URDF robot interface: parse -> flattened chain -> batched FK + collision
(PyTorch counterpart of ``diffco_tpu/robots/urdf.py``: ``parse_urdf``,
``URDFRobot``, ``MultiURDFRobot`` and the convenience robots).

The URDF XML is parsed with the stdlib (host, build time) into a
``ChainSpec``; each link's collision geometry becomes a sphere
decomposition, so robot-vs-environment and self-collision checks are
batched tensor ops over all configurations at once; the allowed-collision
matrix (rigid neighbours, SRDF-disabled pairs and pairs colliding in every
one of N random configurations) is computed at build time with the same
batched ops.

A robot lives on one device (CUDA unless ``device='cpu'``): its sphere
model, self-collision pair indices and joint limits are tensors there;
its static chain data stays numpy / Python floats.
"""
from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.geometry3d import (sphere_set_self_distance,
                                   spheres_vs_scene_signed_dist)
from ..geometry.mesh import load_mesh, spheres_from_mesh, \
    spheres_from_primitive
from ..utils import wrap2pi
from .analytic import uniform_configs
from .fk_jvp import make_chain_fkine
from .kinematics import (ChainSpec, chain_from_joint_list, fk_link_poses,
                         FIXED, REVOLUTE)

# Robot description assets: the third-party URDF/mesh packages (Franka,
# KUKA, ...) are read from DIFFCO_ROBOT_DATA when it is set; otherwise from
# this package's own robot_data directory, where the generated assets live.
robot_description_folder = os.environ.get(
    'DIFFCO_ROBOT_DATA',
    os.path.join(os.path.dirname(os.path.dirname(__file__)), 'robot_data'))


def _rpy_to_mat(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _parse_origin(elem) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    if elem is None:
        return T
    xyz = [float(v) for v in (elem.get('xyz') or '0 0 0').split()]
    rpy = [float(v) for v in (elem.get('rpy') or '0 0 0').split()]
    T[:3, :3] = _rpy_to_mat(rpy)
    T[:3, 3] = xyz
    return T


def parse_urdf(urdf_path: str):
    """Parse a URDF file into (robot_name, joints, link_geoms, root_link).

    joints: list of dicts consumable by ``chain_from_joint_list``;
    link_geoms: {link_name: [(origin 4x4, kind, params)]} collision geometry.
    """
    tree = ET.parse(urdf_path)
    root = tree.getroot()
    urdf_dir = os.path.dirname(os.path.abspath(urdf_path))

    link_geoms: Dict[str, List[Tuple[np.ndarray, str, dict]]] = {}
    link_names = []
    for link in root.findall('link'):
        name = link.get('name')
        link_names.append(name)
        geoms = []
        for col in link.findall('collision'):
            origin = _parse_origin(col.find('origin'))
            geom = col.find('geometry')
            if geom is None:
                continue
            for g in geom:
                tag = g.tag.split('}')[-1]
                if tag == 'box':
                    size = [float(v) for v in g.get('size').split()]
                    geoms.append((origin, 'box', {'size': size}))
                elif tag == 'cylinder':
                    geoms.append((origin, 'cylinder', {
                        'radius': float(g.get('radius')),
                        'length': float(g.get('length'))}))
                elif tag == 'sphere':
                    geoms.append((origin, 'sphere',
                                  {'radius': float(g.get('radius'))}))
                elif tag == 'capsule':
                    geoms.append((origin, 'capsule', {
                        'radius': float(g.get('radius')),
                        'length': float(g.get('length'))}))
                elif tag == 'mesh':
                    fn = g.get('filename')
                    scale = g.get('scale')
                    scale = ([float(v) for v in scale.split()]
                             if scale else [1.0, 1.0, 1.0])
                    # resolve package:// and relative paths
                    if fn.startswith('package://'):
                        fn = fn[len('package://'):]
                        fn = os.path.join(robot_description_folder, fn)
                        if not os.path.exists(fn):
                            # try stripping the package name
                            parts = fn.split(os.sep)
                            fn = os.path.join(urdf_dir, *parts[-2:])
                    elif not os.path.isabs(fn):
                        fn = os.path.join(urdf_dir, fn)
                    geoms.append((origin, 'mesh',
                                  {'path': fn, 'scale': scale}))
        link_geoms[name] = geoms

    child_links = set()
    joints = []
    for joint in root.findall('joint'):
        jname = joint.get('name')
        jtype = joint.get('type')
        parent = joint.find('parent').get('link')
        child = joint.find('child').get('link')
        child_links.add(child)
        origin = _parse_origin(joint.find('origin'))
        axis_el = joint.find('axis')
        axis = ([float(v) for v in axis_el.get('xyz').split()]
                if axis_el is not None else [0.0, 0.0, 1.0])
        limit_el = joint.find('limit')
        limits = None
        if limit_el is not None and limit_el.get('lower') is not None:
            limits = (float(limit_el.get('lower')),
                      float(limit_el.get('upper')))
        mimic_el = joint.find('mimic')
        mimic = None
        if mimic_el is not None:
            mimic = (mimic_el.get('joint'),
                     float(mimic_el.get('multiplier') or 1.0),
                     float(mimic_el.get('offset') or 0.0))
        joints.append(dict(
            name=jname, parent=parent, child=child, type=jtype, axis=axis,
            origin_rot=origin[:3, :3], origin_trans=origin[:3, 3],
            limits=limits, mimic=mimic))

    roots = [n for n in link_names if n not in child_links]
    if not roots:
        raise ValueError(f'no root link found in {urdf_path}')
    return root.get('name') or os.path.basename(urdf_path), joints, \
        link_geoms, roots[0]


class URDFRobot:
    """URDF robot with batched FK and sphere-model collision checking."""

    def __init__(self, urdf_path: str, name: str = '',
                 base_transform=None, device=None, setup_acm=True,
                 load_visual_meshes: bool = False, link_spheres: int = 8,
                 keep_joints: Optional[List[str]] = None):
        del load_visual_meshes
        self.device = resolve_device(device)
        self.urdf_path = urdf_path
        robot_name, joints, link_geoms, root_link = parse_urdf(urdf_path)
        if keep_joints is not None:
            # restrict the actuated set: joints NOT kept are frozen at
            # q = 0 (converted to fixed, so their origin transform
            # survives); mimics of a frozen joint freeze with it
            keep = set(keep_joints)
            known = {j['name'] for j in joints}
            unknown = keep - known
            if unknown:
                raise ValueError(
                    f'keep_joints names not in {urdf_path}: '
                    f'{sorted(unknown)}')
            frozen = {j['name'] for j in joints
                      if j['type'] != 'fixed' and j['name'] not in keep
                      and j['mimic'] is None}
            for j in joints:
                if (j['name'] in frozen
                        or (j['mimic'] is not None
                            and j['mimic'][0] in frozen)):
                    j['type'] = 'fixed'
                    j['mimic'] = None
        self.name = name or robot_name
        self.spec: ChainSpec = chain_from_joint_list(joints,
                                                     root_name=root_link)
        self._n_dofs = self.spec.n_dofs
        self.dof = self._n_dofs
        self.joint_limits = torch.as_tensor(self.spec.joint_limits,
                                            device=self.device)
        self.limits = self.joint_limits
        if base_transform is not None:
            bt = np.asarray(base_transform, np.float32)
            self.base_rot, self.base_trans = bt[:3, :3], bt[:3, 3]
        else:
            self.base_rot = self.base_trans = None

        # ---- link sphere decomposition (build time, host) ----------------
        centers, radii, link_idx = [], [], []
        for li, lname in enumerate(self.spec.link_names):
            for origin, kind, params in link_geoms.get(lname, ()):
                if kind == 'mesh':
                    try:
                        verts, faces = load_mesh(params['path'])
                    except (FileNotFoundError, ValueError):
                        continue
                    verts = verts * np.asarray(params['scale'], np.float32)
                    c, r = spheres_from_mesh(verts, faces,
                                             n_spheres=link_spheres)
                else:
                    c, r = spheres_from_primitive(kind, params,
                                                  n=link_spheres)
                centers.append(c @ origin[:3, :3].T + origin[:3, 3])
                radii.append(r)
                link_idx.append(np.full(len(c), li, np.int64))
        centers = (np.concatenate(centers).astype(np.float32) if centers
                   else np.zeros((0, 3), np.float32))
        self.link_sphere_centers = torch.as_tensor(       # [P, 3] local
            centers, device=self.device)
        self.link_sphere_radii = torch.as_tensor(         # [P]
            np.concatenate(radii).astype(np.float32) if radii
            else np.zeros(0, np.float32), device=self.device)
        self.sphere_link_idx = torch.as_tensor(           # [P]
            np.concatenate(link_idx) if link_idx
            else np.zeros(0, np.int64), device=self.device)

        # name bookkeeping for FK-dict parity
        self._link_geom_counts = {
            n: len(link_geoms.get(n, ())) for n in self.spec.link_names}

        # ---- analytic-derivative SoA chain FK (robots/fk_jvp.py) ---------
        # control points and sphere centers are static point specs on the
        # flattened chain: the hot paths never build [B, L, 3, 3] poses
        base = (None if self.base_rot is None
                else (self.base_rot, self.base_trans))
        sel = [self.spec.link_index(n)
               for n in self.spec.unique_position_link_names]
        self._fkine_sel = (
            make_chain_fkine(self.spec,
                             tuple((li, (0.0, 0.0, 0.0)) for li in sel),
                             base=base) if sel else None)
        self._sphere_fkine = (
            make_chain_fkine(self.spec, tuple(
                (int(li), tuple(float(v) for v in c))
                for li, c in zip(self.sphere_link_idx.tolist(), centers)),
                base=base) if len(centers) else None)

        # ---- allowed-collision matrix -------------------------------------
        self._self_pair_i = torch.zeros(0, dtype=torch.long,
                                        device=self.device)
        self._self_pair_j = self._self_pair_i
        if setup_acm and len(centers):
            num_cfgs = 100 if setup_acm is True or setup_acm < 2 \
                else int(setup_acm)
            self._setup_acm(num_cfgs)

    # ---------------------------------------------------------------------

    def _load_srdf_disabled(self):
        """Disabled collision pairs from a sibling .srdf (MoveIt
        convention)."""
        srdf = os.path.splitext(self.urdf_path)[0] + '.srdf'
        pairs = set()
        if not os.path.exists(srdf):
            return pairs
        try:
            root = ET.parse(srdf).getroot()
        except ET.ParseError:
            return pairs
        name_to_idx = {n: i for i, n in enumerate(self.spec.link_names)}
        for el in root.iter('disable_collisions'):
            a = name_to_idx.get(el.get('link1'))
            b = name_to_idx.get(el.get('link2'))
            if a is not None and b is not None:
                pairs.add((min(a, b), max(a, b)))
        return pairs

    def _setup_acm(self, num_cfgs: int):
        """Allowed pairs = adjacent links (collapsed through fixed
        joints) + SRDF-disabled pairs + pairs colliding in every one of
        ``num_cfgs`` random configurations; all other link pairs are
        checked by self-collision."""
        spec = self.spec
        L = spec.n_links

        # Collapse fixed joints into RIGID GROUPS (MoveIt's "Adjacent"
        # semantics): links in one group cannot move relative to each
        # other, and two groups joined by a single moving joint are
        # adjacent.
        def rigid_root(i):
            # highest ancestor rigidly connected to i (jtype[r] is the
            # joint attaching link r to its parent)
            r = i
            while int(spec.parent[r]) >= 0 and spec.jtype[r] == FIXED:
                r = int(spec.parent[r])
            return r

        group = [rigid_root(i) for i in range(L)]
        adjacent = set()
        for i in range(L):
            for j in range(i + 1, L):
                gi, gj = group[i], group[j]
                if gi == gj:
                    adjacent.add((i, j))
                    continue
                pi, pj = int(spec.parent[gi]), int(spec.parent[gj])
                if (pi >= 0 and group[pi] == gj) or \
                        (pj >= 0 and group[pj] == gi):
                    adjacent.add((i, j))
        adjacent |= self._load_srdf_disabled()

        li = self.sphere_link_idx.cpu().numpy()
        has_geom = np.unique(li)
        cand_pairs = [(a, b) for ai, a in enumerate(has_geom)
                      for b in has_geom[ai + 1:]
                      if (min(a, b), max(a, b)) not in adjacent]
        if not cand_pairs:
            return
        # sphere-level pair expansion per link pair
        pair_i, pair_j, pair_of_linkpair = [], [], []
        for pid, (a, b) in enumerate(cand_pairs):
            ia = np.where(li == a)[0]
            ib = np.where(li == b)[0]
            gi, gj = np.meshgrid(ia, ib, indexing='ij')
            pair_i.append(gi.ravel())
            pair_j.append(gj.ravel())
            pair_of_linkpair.append(np.full(gi.size, pid, np.int32))
        pair_i = np.concatenate(pair_i)
        pair_j = np.concatenate(pair_j)
        pair_map = np.concatenate(pair_of_linkpair)

        q = self.rand_configs(num_cfgs, torch.Generator().manual_seed(0),
                              self.device)
        with torch.no_grad():
            sd = sphere_set_self_distance(
                self._spheres_world(q), self.link_sphere_radii,
                torch.as_tensor(pair_i, device=self.device),
                torch.as_tensor(pair_j, device=self.device))
        sd = sd.cpu().numpy()                       # [num_cfgs, n_pairs]
        # per link pair: colliding in a config iff any sphere pair overlaps
        n_lp = len(cand_pairs)
        colliding = np.zeros((num_cfgs, n_lp), bool)
        for pid in range(n_lp):
            mask = pair_map == pid
            colliding[:, pid] = (sd[:, mask] > 0).any(axis=1)
        always = colliding.all(axis=0)
        keep_spheres = (~always)[pair_map]
        self._self_pair_i = torch.as_tensor(pair_i[keep_spheres],
                                            device=self.device)
        self._self_pair_j = torch.as_tensor(pair_j[keep_spheres],
                                            device=self.device)
        self._allowed_internal = [cand_pairs[pid]
                                  for pid in np.where(always)[0]]

    # ---------------------------------------------------------------------

    def rand_configs(self, num_cfgs: int, generator: Optional[
            torch.Generator] = None, device=None) -> torch.Tensor:
        """Uniform configurations within the joint limits, on ``device``
        (default: the robot's)."""
        return uniform_configs(self.joint_limits, num_cfgs, generator,
                               self.device if device is None else device)

    def fk_poses(self, q):
        """Batched link poses: q [B, dof] -> (rot [B, L, 3, 3],
        trans [B, L, 3])."""
        return fk_link_poses(self.spec, torch.atleast_2d(q), self.base_rot,
                             self.base_trans)

    def compute_forward_kinematics_all_links(self, q, return_collision=False):
        """Dict API: {link_name: [(trans [B, 3], rot [B, 3, 3])]}; with
        ``return_collision`` one entry per collision geometry of the link
        (the sphere model bakes piece offsets into the sphere centers, so
        each piece reports the link frame)."""
        rot, tr = self.fk_poses(q)
        out = {}
        for li, name in enumerate(self.spec.link_names):
            n = self._link_geom_counts.get(name, 0) if return_collision else 1
            out[name] = [(tr[:, li], rot[:, li])] * n
        return out

    def fkine(self, q, return_collision=False):
        """Stacked control-point positions [B, n_sel, 3] over the
        unique-position links."""
        del return_collision
        q = torch.atleast_2d(q)
        if self._fkine_sel is not None:
            return self._fkine_sel(q).reshape(q.shape[0], -1, 3)
        return q.new_zeros(q.shape[0], 0, 3)

    @property
    def unique_position_link_names(self):
        return self.spec.unique_position_link_names

    def _spheres_world(self, q):
        if self._sphere_fkine is None:
            return q.new_zeros(q.shape[0], 0, 3)
        return self._sphere_fkine(q).reshape(q.shape[0], -1, 3)

    def sphere_centers_world(self, q):
        """World positions of all collision spheres: [B, P, 3]."""
        return self._spheres_world(torch.atleast_2d(q))

    # ---------------------------------------------------------------------

    def collision_signed_dist(self, q, other=None):
        """Per-config signed distances: (env_sd [B, n_objects],
        self_sd [B]); >0 = collision."""
        q = torch.atleast_2d(q)
        B = q.shape[0]
        centers = self._spheres_world(q)
        if other is not None:
            scene = other.scene if hasattr(other, 'scene') else other
            env_sd = spheres_vs_scene_signed_dist(
                centers, self.link_sphere_radii, scene.to(q.device))
        else:
            env_sd = q.new_full((B, 0), -math.inf)
        if self._self_pair_i.shape[0] == 0:
            self_sd = q.new_full((B,), -math.inf)
        else:
            self_sd = torch.amax(sphere_set_self_distance(
                centers, self.link_sphere_radii, self._self_pair_i,
                self._self_pair_j), dim=-1)
        return env_sd, self_sd

    def collision(self, q, other=None, show=False):
        """Boolean labels [B]: env collision OR self collision."""
        del show
        env_sd, self_sd = self.collision_signed_dist(q, other)
        env_hit = (torch.any(env_sd > 0, dim=-1) if env_sd.shape[-1]
                   else torch.zeros(env_sd.shape[0], dtype=torch.bool,
                                    device=env_sd.device))
        return env_hit | (self_sd > 0)

    def self_collision(self, q):
        _, self_sd = self.collision_signed_dist(q, None)
        return self_sd > 0

    @property
    def _revolute_dof_mask(self):
        """Dofs that are plain revolute angles (no mimic scaling)."""
        mask = getattr(self, '_rev_mask_cache', None)
        if mask is None:
            m = np.zeros(self._n_dofs, bool)
            for i in range(self.spec.n_links):
                d = int(self.spec.dof_idx[i])
                if (d >= 0 and self.spec.jtype[i] == REVOLUTE
                        and self.spec.mimic_mult[i] == 1.0
                        and self.spec.mimic_offset[i] == 0.0):
                    m[d] = True
            mask = torch.as_tensor(m, device=self.device)
            self._rev_mask_cache = mask
        return mask

    def wrap(self, q):
        """Angle-wrap the REVOLUTE dofs only: wrapping a prismatic
        coordinate (e.g. a 4 m rail position) would teleport it by 2*pi
        meters."""
        return torch.where(self._revolute_dof_mask.to(q.device), wrap2pi(q),
                           q)


class MultiURDFRobot:
    """Several URDF robots with concatenated configuration vectors. The
    collision check is each robot's own (environment and self) or any
    overlap of one robot's spheres with another's. The robots share one
    device, on which the robot runs."""

    # elements of an inter-robot block [rows, Pa, Pb] at most
    _PAIR_ELEMENTS = 1 << 24

    def __init__(self, urdf_robots: List[URDFRobot]):
        self.robots = list(urdf_robots)
        devices = {r.device for r in self.robots}
        if len(devices) != 1:
            raise ValueError(f'MultiURDFRobot: robots on {devices}, '
                             'not on one device')
        self.device = self.robots[0].device
        self.name = 'multi_' + '_'.join(r.name for r in self.robots)
        self._n_dofs = sum(r._n_dofs for r in self.robots)
        self.dof = self._n_dofs
        self.joint_limits = torch.cat([r.joint_limits for r in self.robots],
                                      dim=0)
        self.limits = self.joint_limits
        self._sizes = [r._n_dofs for r in self.robots]

    def split_q(self, q):
        """q [B, dof] -> each robot's part [B, dof_i]."""
        return list(torch.split(torch.atleast_2d(q), self._sizes, dim=-1))

    def rand_configs(self, num_cfgs: int, generator: Optional[
            torch.Generator] = None, device=None) -> torch.Tensor:
        """Each robot's part drawn in turn from ``generator``, on
        ``device`` (default: the robots')."""
        return torch.cat([r.rand_configs(num_cfgs, generator, device)
                          for r in self.robots], dim=-1)

    def fkine(self, q, return_collision=False):
        """The robots' control points, concatenated: [B, sum n_sel, 3]."""
        return torch.cat([r.fkine(qq, return_collision)
                          for r, qq in zip(self.robots, self.split_q(q))],
                         dim=1)

    def compute_forward_kinematics_all_links(self, q, return_collision=False):
        return [r.compute_forward_kinematics_all_links(qq, return_collision)
                for r, qq in zip(self.robots, self.split_q(q))]

    def _inter_robot_overlap(self, qs):
        """The deepest overlap of two robots' spheres (radius sum less
        centre distance) per configuration [B], -inf where no pair of
        robots has spheres; > 0 is a collision. One pass of tensor ops,
        in row chunks of at most ``_PAIR_ELEMENTS`` sphere pairs."""
        B = qs[0].shape[0]
        out = qs[0].new_full((B,), -math.inf)
        if B == 0:
            return out
        centers = [r.sphere_centers_world(qq)
                   for r, qq in zip(self.robots, qs)]
        for a in range(len(self.robots)):
            for b in range(a + 1, len(self.robots)):
                ca, cb = centers[a], centers[b]
                if ca.shape[1] == 0 or cb.shape[1] == 0:
                    continue
                rsum = (self.robots[a].link_sphere_radii[:, None]
                        + self.robots[b].link_sphere_radii[None, :])
                rows = max(1, self._PAIR_ELEMENTS
                           // (ca.shape[1] * cb.shape[1]))
                deepest = []
                for i in range(0, B, rows):
                    d = torch.sqrt(torch.sum(
                        (ca[i:i + rows, :, None, :]
                         - cb[i:i + rows, None, :, :]) ** 2, dim=-1)
                        + 1e-12)
                    deepest.append(torch.amax((rsum - d).flatten(1), dim=-1))
                out = torch.maximum(out, torch.cat(deepest))
        return out

    def _inter_robot_hit(self, qs):
        """Inter-robot sphere overlap per configuration [B] (bool)."""
        return self._inter_robot_overlap(qs) > 0

    def collision(self, q, other=None, show=False):
        """Boolean labels [B]: any robot's environment or self collision,
        or an overlap between two robots."""
        del show
        qs = self.split_q(q)
        hit = self._inter_robot_hit(qs)
        for r, qq in zip(self.robots, qs):
            hit = hit | r.collision(qq, other)
        return hit

    def wrap(self, q):
        """Angle-wrap each robot's revolute dofs only."""
        mask = torch.cat([r._revolute_dof_mask for r in self.robots])
        return torch.where(mask.to(q.device), wrap2pi(q), q)


# ---------------------------------------------------------------------------
# convenience robots


def _data_path(*parts, vendored: str = None):
    """Resolve a robot-description file; when the robot-data folder does
    not provide it and a generated equivalent exists, use that, so the
    package runs standalone."""
    path = os.path.join(robot_description_folder, *parts)
    if not os.path.exists(path) and vendored is not None:
        from .. import robot_data
        robot_data.ensure_default_assets()
        fallback = os.path.join(robot_data.data_dir, vendored)
        if os.path.exists(fallback):
            return fallback
    return path


class KUKAiiwa(URDFRobot):
    def __init__(self, version='iiwa7', **kwargs):
        super().__init__(
            _data_path('kuka_iiwa', 'urdf', f'{version}.urdf'),
            name=f'kuka_{version}', **kwargs)


class FrankaPanda(URDFRobot):
    """Franka Panda. Uses the third-party panda_description URDF when the
    robot-data folder provides it; otherwise the generated DH-equivalent
    panda_simple (robot_data.generate_panda_like_urdf)."""

    def __init__(self, simple_collision=False, load_gripper=True,
                 **kwargs):
        mid = 'panda' if load_gripper else 'panda_no_gripper'
        if simple_collision:
            mid += '_simple_collision'
        vendored = ('panda_simple.urdf' if load_gripper
                    else 'panda_simple_no_gripper.urdf')
        super().__init__(
            _data_path('panda_description', 'urdf', f'{mid}.urdf',
                       vendored=vendored),
            name='panda', **kwargs)


class TwoLinkRobot(URDFRobot):
    def __init__(self, **kwargs):
        super().__init__(_data_path('2link_robot.urdf',
                                    vendored='2link_robot.urdf'),
                         name='2link_robot', **kwargs)


class TrifingerEdu(URDFRobot):
    def __init__(self, **kwargs):
        super().__init__(
            _data_path('trifinger_edu_description', 'trifinger_edu.urdf'),
            name='trifinger_edu', **kwargs)


class RopeRobot(URDFRobot):
    """The rope of DiffCo's high-DOF rope test (ucsdarclab/diffco
    examples/tests/test_rope.py:18-46), whose shipped URDF is broken: the
    generated ``robot_data.generate_rope_urdf`` chain of ``n_links``
    continuous joints, axes alternating y/x, 0.05 m links of radius 0.01.
    Its control points are the link origins after the first (n_links - 1;
    the last joint moves none). Without a self-collision matrix and with 4
    spheres a link by default, as the rope test builds it."""

    def __init__(self, n_links: int = 35, **kwargs):
        from .. import robot_data
        kwargs.setdefault('setup_acm', False)
        kwargs.setdefault('link_spheres', 4)
        super().__init__(robot_data.generate_rope_urdf(n_links=n_links),
                         name=f'rope_{n_links}', **kwargs)

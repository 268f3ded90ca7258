"""Self-generated robot description assets (a copy of
``diffco_tpu/robot_data/__init__.py`` that writes into this directory).

The upstream robot packages (Franka, KUKA, ...) are third-party data the
framework reads from DIFFCO_ROBOT_DATA; this package holds descriptions we
generate ourselves (e.g. the N-link rope — the reference ships a broken
1-link rope.urdf, rope_description/rope.urdf references a nonexistent
link2)."""
import os

data_dir = os.path.dirname(os.path.abspath(__file__))


def _write(path: str, text: str):
    """Write through a temporary file and rename it into place, so that a
    process reading the asset while another writes it (parallel test
    workers) sees the whole file or none."""
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'w') as f:
        f.write(text)
    os.replace(tmp, path)


def generate_rope_urdf(n_links: int = 20, link_length: float = 0.05,
                       radius: float = 0.01, path: str = None) -> str:
    """Write an N-link rope URDF: continuous joints alternating y/x axes
    (a discretized rope, ~n_links DOF). Returns the file path."""
    parts = ['<?xml version="1.0"?>', '<robot name="rope_robot">']
    parts.append('<link name="base"/>')
    for i in range(1, n_links + 1):
        parts.append(
            f'<link name="link{i}">\n'
            f'  <collision>\n'
            f'    <origin xyz="0 0 {link_length / 2}" rpy="0 0 0"/>\n'
            f'    <geometry><cylinder length="{link_length}" '
            f'radius="{radius}"/></geometry>\n'
            f'  </collision>\n'
            f'</link>')
        parent = 'base' if i == 1 else f'link{i - 1}'
        z = 0.0 if i == 1 else link_length
        axis = '0 1 0' if i % 2 else '1 0 0'
        parts.append(
            f'<joint name="joint{i}" type="continuous">\n'
            f'  <origin xyz="0 0 {z}" rpy="0 0 0"/>\n'
            f'  <parent link="{parent}"/>\n'
            f'  <child link="link{i}"/>\n'
            f'  <axis xyz="{axis}"/>\n'
            f'</joint>')
    parts.append('</robot>')
    if path is None:
        path = os.path.join(data_dir, f'rope_{n_links}.urdf')
    _write(path, '\n'.join(parts))
    return path


def generate_marked_rope_urdf(n_links: int = 11, link_length: float = 0.08,
                              path: str = None) -> str:
    """The N-link rope of ``generate_rope_urdf`` with a marker link on a
    fixed joint beside each link (off the rope's axis): 2N - 1 control
    points on N moving joints (21 on 11 at the default), the widest point
    rows the chain kernels take within their 16 moving joints. Returns the
    file path."""
    parts = ['<?xml version="1.0"?>', '<robot name="marked_rope_robot">',
             '<link name="base"/>']
    for i in range(1, n_links + 1):
        parent = 'base' if i == 1 else f'link{i - 1}'
        z = 0.0 if i == 1 else link_length
        axis = '0 1 0' if i % 2 else '1 0 0'
        parts.append(
            f'<link name="link{i}"/>\n'
            f'<link name="marker{i}"/>\n'
            f'<joint name="joint{i}" type="continuous">\n'
            f'  <origin xyz="0 0 {z}" rpy="0 0 0"/>\n'
            f'  <parent link="{parent}"/>\n'
            f'  <child link="link{i}"/>\n'
            f'  <axis xyz="{axis}"/>\n'
            f'</joint>\n'
            f'<joint name="marker_joint{i}" type="fixed">\n'
            f'  <origin xyz="0.03 0.01 {link_length / 2}" rpy="0 0 0"/>\n'
            f'  <parent link="link{i}"/>\n'
            f'  <child link="marker{i}"/>\n'
            f'</joint>')
    parts.append('</robot>')
    if path is None:
        path = os.path.join(data_dir, f'marked_rope_{n_links}.urdf')
    _write(path, '\n'.join(parts))
    return path


def generate_two_link_urdf(path: str = None) -> str:
    """A planar 2-link arm URDF equivalent to the reference's
    2link_robot.urdf asset (two 1 m x 0.05 m box links on z-axis revolute
    joints; same joint limits). Vendored so the framework runs without the
    third-party data mount."""
    limit = 2.9670597283903604
    parts = ['<?xml version="1.0"?>', '<robot name="2link_robot">',
             '<link name="base"/>']
    for i, (parent, xyz_origin) in enumerate(
            (('base', '0 0 0.15'), ('arm1', '1 0 0')), 1):
        parts.append(
            f'<link name="arm{i}">\n'
            f'  <collision>\n'
            f'    <geometry><box size="1 .05 .05"/></geometry>\n'
            f'    <origin rpy="0 0 0" xyz="0.5 0 0"/>\n'
            f'  </collision>\n'
            f'</link>')
        parts.append(
            f'<joint name="hinge{i}" type="revolute">\n'
            f'  <origin rpy="0 0 0" xyz="{xyz_origin}"/>\n'
            f'  <axis xyz="0 0 1"/>\n'
            f'  <parent link="{parent}"/>\n'
            f'  <child link="arm{i}"/>\n'
            f'  <limit effort="20" lower="-{limit}" upper="{limit}" '
            f'velocity="10"/>\n'
            f'</joint>')
    # end-effector frame at the tip of arm2: without it the FK feature
    # transform has no link position that depends on q2 at all
    parts.append('<link name="endEffector"/>')
    parts.append('<joint name="ee_joint" type="fixed">\n'
                 '  <origin rpy="0 0 0" xyz="1 0 0.05"/>\n'
                 '  <parent link="arm2"/>\n'
                 '  <child link="endEffector"/>\n'
                 '</joint>')
    parts.append('</robot>')
    if path is None:
        path = os.path.join(data_dir, '2link_robot.urdf')
    _write(path, '\n'.join(parts))
    return path


def generate_panda_like_urdf(path: str = None,
                             load_gripper: bool = True) -> str:
    """A 7-DOF serial arm whose kinematics equal the Franka Panda DH chain
    used by robots.analytic.PandaFK (model.py:390-453 constants), with
    cylinder collision geometry along each link.

    DH -> URDF: A_i = RotZ(q_i) C_i with C_i = TransZ(d) TransX(a)
    RotX(alpha) = Trans((a, 0, d)) RotX(alpha); URDF joint i+1 takes
    origin xyz=(a_i, 0, d_i) rpy=(alpha_i, 0, 0) so the chain products
    agree exactly — tests/test_urdf_parity.py asserts FK parity against
    the analytic chain.
    """
    import math
    pi = math.pi
    L = [0.3330, 0.3160, 0.0825, 0.3840, 0.0880, 0.2140]
    a = [0, 0, L[2], -L[2], 0, L[4], 0]
    alpha = [-pi / 2, pi / 2, pi / 2, -pi / 2, pi / 2, pi / 2, 0]
    d = [L[0], 0, L[1], 0, L[3], 0, L[5]]
    limits = [[-2.8973, 2.8973], [-1.7628, 1.7628], [-2.8973, 2.8973],
              [-3.0718, -0.0698], [-2.8973, 2.8973], [-0.0175, 3.7525],
              [-2.8973, 2.8973]]
    parts = ['<?xml version="1.0"?>',
             '<robot name="panda_simple">', '<link name="base"/>']
    for i in range(7):
        # collision: a small sphere at the joint frame plus a cylinder
        # spanning the link's d-offset when it is long enough
        col = (f'  <collision>\n'
               f'    <origin xyz="0 0 0" rpy="0 0 0"/>\n'
               f'    <geometry><sphere radius="0.06"/></geometry>\n'
               f'  </collision>\n')
        # includes i == 6: the 0.214 m link7-to-hand flange stretch needs
        # its cylinder too (endpoint spheres alone left a ~0.1 m
        # uncovered gap in the wrist)
        if abs(d[i]) > 0.15:
            col += (f'  <collision>\n'
                    f'    <origin xyz="0 0 {d[i] / 2}" rpy="0 0 0"/>\n'
                    f'    <geometry><cylinder length="{abs(d[i])}" '
                    f'radius="0.05"/></geometry>\n'
                    f'  </collision>\n')
        parts.append(f'<link name="panda_link{i + 1}">\n{col}</link>')
        parent = 'base' if i == 0 else f'panda_link{i}'
        if i == 0:
            origin = '<origin xyz="0 0 0" rpy="0 0 0"/>'
        else:
            origin = (f'<origin xyz="{a[i - 1]} 0 {d[i - 1]}" '
                      f'rpy="{alpha[i - 1]} 0 0"/>')
        parts.append(
            f'<joint name="panda_joint{i + 1}" type="revolute">\n'
            f'  {origin}\n'
            f'  <axis xyz="0 0 1"/>\n'
            f'  <parent link="{parent}"/>\n'
            f'  <child link="panda_link{i + 1}"/>\n'
            f'  <limit effort="87" lower="{limits[i][0]}" '
            f'upper="{limits[i][1]}" velocity="2.2"/>\n'
            f'</joint>')
    # flange / hand: fixed transform C_7
    parts.append('<link name="panda_hand">\n'
                 '  <collision>\n'
                 '    <origin xyz="0 0 0" rpy="0 0 0"/>\n'
                 '    <geometry><box size="0.08 0.2 0.06"/></geometry>\n'
                 '  </collision>\n'
                 '</link>')
    parts.append(
        f'<joint name="panda_hand_joint" type="fixed">\n'
        f'  <origin xyz="{a[6]} 0 {d[6]}" rpy="{alpha[6]} 0 0"/>\n'
        f'  <parent link="panda_link7"/>\n'
        f'  <child link="panda_hand"/>\n'
        f'</joint>')
    if load_gripper:
        for side, sign in (('left', 1.0), ('right', -1.0)):
            parts.append(
                f'<link name="panda_{side}finger">\n'
                f'  <collision>\n'
                f'    <origin xyz="0 0 0.02" rpy="0 0 0"/>\n'
                f'    <geometry><box size="0.02 0.02 0.06"/></geometry>\n'
                f'  </collision>\n'
                f'</link>')
            parts.append(
                f'<joint name="panda_{side}finger_joint" type="fixed">\n'
                f'  <origin xyz="0 {sign * 0.04} 0" rpy="0 0 0"/>\n'
                f'  <parent link="panda_hand"/>\n'
                f'  <child link="panda_{side}finger"/>\n'
                f'</joint>')
    parts.append('</robot>')
    if path is None:
        name = ('panda_simple.urdf' if load_gripper
                else 'panda_simple_no_gripper.urdf')
        path = os.path.join(data_dir, name)
    _write(path, '\n'.join(parts))
    return path


def generate_trifinger_urdf(path: str = None) -> str:
    """A trifinger-style branching robot (ref TriFingerEdu,
    urdf_interface.py:871-934 and trifinger_edu_description assets): three
    identical 3-DOF fingers mounted at 120-degree intervals around a base
    plate. Exercises branching-tree FK (multiple children per link) with
    mixed joint axes — the serial-chain assets never do."""
    import math
    parts = ['<?xml version="1.0"?>', '<robot name="trifinger_simple">',
             '<link name="base"/>']
    seg = [0.16, 0.16, 0.08]          # upper, middle, tip segment lengths
    axes = ['1 0 0', '0 1 0', '0 1 0']
    for f in range(3):
        ang = 2.0 * math.pi * f / 3.0
        x, y = 0.12 * math.cos(ang), 0.12 * math.sin(ang)
        mount = f'finger{f}_mount'
        parts.append(f'<link name="{mount}"/>')
        parts.append(
            f'<joint name="finger{f}_mount_joint" type="fixed">\n'
            f'  <origin xyz="{x:.6f} {y:.6f} 0.05" rpy="0 0 {ang:.6f}"/>\n'
            f'  <parent link="base"/>\n'
            f'  <child link="{mount}"/>\n'
            f'</joint>')
        parent = mount
        for s in range(3):
            link = f'finger{f}_link{s}'
            col = (f'  <collision>\n'
                   f'    <origin xyz="0 0 {-seg[s] / 2}" rpy="0 0 0"/>\n'
                   f'    <geometry><cylinder length="{seg[s]}" '
                   f'radius="0.015"/></geometry>\n'
                   f'  </collision>\n')
            parts.append(f'<link name="{link}">\n{col}</link>')
            origin = ('<origin xyz="0 0 0" rpy="0 0 0"/>' if s == 0 else
                      f'<origin xyz="0 0 {-seg[s - 1]}" rpy="0 0 0"/>')
            parts.append(
                f'<joint name="finger{f}_joint{s}" type="revolute">\n'
                f'  {origin}\n'
                f'  <axis xyz="{axes[s]}"/>\n'
                f'  <parent link="{parent}"/>\n'
                f'  <child link="{link}"/>\n'
                f'  <limit effort="10" lower="{-math.pi / 2}" '
                f'upper="{math.pi / 2}" velocity="10"/>\n'
                f'</joint>')
            parent = link
    parts.append('</robot>')
    if path is None:
        path = os.path.join(data_dir, 'trifinger_simple.urdf')
    _write(path, '\n'.join(parts))
    return path


def generate_lift_urdf(path: str = None) -> str:
    """A small 'lift' rig covering prismatic and mimic joints in one
    always-available asset: prismatic torso (z) -> revolute elbow ->
    prismatic left finger + right finger mimicking it with
    multiplier -1 (a parallel gripper, like the reference's Panda hand
    fingers, panda.urdf finger2 mimic)."""
    parts = [
        '<?xml version="1.0"?>', '<robot name="lift_rig">',
        '<link name="base"/>',
        '<link name="torso">\n'
        '  <collision><origin xyz="0 0 0" rpy="0 0 0"/>\n'
        '    <geometry><box size="0.1 0.1 0.4"/></geometry>\n'
        '  </collision>\n</link>',
        '<joint name="torso_lift" type="prismatic">\n'
        '  <origin xyz="0 0 0.2" rpy="0 0 0"/>\n'
        '  <axis xyz="0 0 1"/>\n'
        '  <parent link="base"/><child link="torso"/>\n'
        '  <limit effort="100" lower="0.0" upper="0.4" velocity="0.5"/>\n'
        '</joint>',
        '<link name="arm">\n'
        '  <collision><origin xyz="0.15 0 0" rpy="0 1.5707963 0"/>\n'
        '    <geometry><cylinder length="0.3" radius="0.03"/></geometry>\n'
        '  </collision>\n</link>',
        '<joint name="elbow" type="revolute">\n'
        '  <origin xyz="0.05 0 0.15" rpy="0 0 0"/>\n'
        '  <axis xyz="0 0 1"/>\n'
        '  <parent link="torso"/><child link="arm"/>\n'
        '  <limit effort="50" lower="-2.5" upper="2.5" velocity="2"/>\n'
        '</joint>',
        '<link name="finger_l">\n'
        '  <collision><origin xyz="0 0 0" rpy="0 0 0"/>\n'
        '    <geometry><box size="0.02 0.02 0.08"/></geometry>\n'
        '  </collision>\n</link>',
        '<joint name="finger_l_joint" type="prismatic">\n'
        '  <origin xyz="0.3 0.04 0" rpy="0 0 0"/>\n'
        '  <axis xyz="0 1 0"/>\n'
        '  <parent link="arm"/><child link="finger_l"/>\n'
        '  <limit effort="20" lower="0.0" upper="0.04" velocity="0.1"/>\n'
        '</joint>',
        '<link name="finger_r">\n'
        '  <collision><origin xyz="0 0 0" rpy="0 0 0"/>\n'
        '    <geometry><box size="0.02 0.02 0.08"/></geometry>\n'
        '  </collision>\n</link>',
        '<joint name="finger_r_joint" type="prismatic">\n'
        '  <origin xyz="0.3 -0.04 0" rpy="0 0 0"/>\n'
        '  <axis xyz="0 1 0"/>\n'
        '  <parent link="arm"/><child link="finger_r"/>\n'
        '  <limit effort="20" lower="-0.04" upper="0.0" velocity="0.1"/>\n'
        '  <mimic joint="finger_l_joint" multiplier="-1" offset="0"/>\n'
        '</joint>',
        '</robot>']
    if path is None:
        path = os.path.join(data_dir, 'lift_rig.urdf')
    _write(path, '\n'.join(parts))
    return path


def ensure_default_assets() -> str:
    """Generate the vendored default assets (idempotent); returns the
    vendored data directory. Called by the URDFRobot convenience
    constructors when the third-party robot-data mount is absent."""
    if not os.path.exists(os.path.join(data_dir, '2link_robot.urdf')):
        generate_two_link_urdf()
    if not os.path.exists(os.path.join(data_dir, 'panda_simple.urdf')):
        generate_panda_like_urdf(load_gripper=True)
    if not os.path.exists(os.path.join(data_dir,
                                       'panda_simple_no_gripper.urdf')):
        generate_panda_like_urdf(load_gripper=False)
    if not os.path.exists(os.path.join(data_dir, 'trifinger_simple.urdf')):
        generate_trifinger_urdf()
    if not os.path.exists(os.path.join(data_dir, 'lift_rig.urdf')):
        generate_lift_urdf()
    return data_dir

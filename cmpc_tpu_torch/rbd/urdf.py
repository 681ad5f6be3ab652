"""Robot model loading: URDF / JSON spec -> RobotModel static pytree.

The replacement for DART's URDF loader role
(reference: ``dart.utils.DartLoader``, simulation.py:403-417).  Parsing
happens once on the host; the result is a :class:`RobotModel` of numpy
constants that the kinematics/dynamics algorithms
(:mod:`cmpc_tpu_torch.rbd.algorithms`) close over.  Nothing here runs on device
or inside jit.

Two input formats produce the same model:

* ``parse_urdf(path)`` — any URDF (stdlib XML parser; visuals/meshes are
  ignored, only kinematics + inertials matter).
* ``build_model(spec)`` — a plain-dict robot spec; the HRP-4 constants
  ship in ``assets/hrp4.json`` (dynamics parameters extracted from the
  reference robot description by ``tools/extract_hrp4.py`` — data about
  the robot, reformatted; no meshes).

Design (idiomatic for array computation, not a DART translation):

* Fixed joints are **lumped away** at build time: every chain of
  fixed-jointed links collapses into its nearest movable ancestor body,
  with masses/inertias combined about the merged body's frame.  HRP-4's
  55 links / 24 revolute + 30 fixed joints become 25 movable bodies
  (floating base + 24).  The algorithms then see a dense static tree with
  one DoF per non-base body.
* Frames that dynamics clients need (soles, torso, base) survive lumping
  as named **sites**: (movable body index, constant offset transform).
* The zero-mass fix-up of the reference (simulation.py:412-417: bodies
  with zero mass get mass 1e-8, inertia 1e-10*I) is applied per *link*
  before lumping, so degenerate URDF inertias never reach the device.

Velocity convention (matches DART's FreeJoint spatial ordering so logged
traces compare directly): generalized velocity qv (6 + n_joints,) =
[omega_base_world(3), v_base_origin_world(3), qdot(n_joints)].
"""

from __future__ import annotations

import dataclasses
import json
import os
import xml.etree.ElementTree as ET

import numpy as np

# Frames the controller needs (inverse_dynamics.py:34-38 body nodes).
DEFAULT_SITES = ("body", "torso", "l_sole", "r_sole")

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets")


def _rpy_to_matrix(r, p, y):
    """URDF fixed-axis roll-pitch-yaw: R = Rz(y) Ry(p) Rx(r)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _pose_to_T(xyz, rpy) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _rpy_to_matrix(*rpy)
    T[:3, 3] = xyz
    return T


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot constants.  nb = movable bodies (base first),
    nj = nb - 1 actuatable joints, nv = 6 + nj generalized velocities."""

    name: str
    nb: int
    nj: int
    parent: np.ndarray        # (nb,) int32, parent body index; -1 for base
    T_tree: np.ndarray        # (nb,4,4) parent body frame -> joint frame
    axis: np.ndarray          # (nb,3) joint axis in child body frame
    mass: np.ndarray          # (nb,)
    com: np.ndarray           # (nb,3) lumped com in body frame
    inertia: np.ndarray       # (nb,3,3) lumped inertia about com
    ancestor: np.ndarray      # (nb,nb) bool; ancestor[i,j]=1 iff body j is
    #                           on the path root..i (j>0 => joint j moves i)
    joint_names: tuple        # (nj,) names, body i>0 <-> joint_names[i-1]
    sites: dict               # name -> (body_idx, (4,4) offset)
    joint_limits: np.ndarray  # (nj,2) position limits (lo, hi)
    effort_limits: np.ndarray    # (nj,)
    velocity_limits: np.ndarray  # (nj,)

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())

    def dof_index(self, joint_name: str) -> int:
        """Index into the joint-angle vector (0-based over the nj joints)."""
        return self.joint_names.index(joint_name)


def _shift_inertia(I_com, mass, d):
    """Parallel axis: inertia about a point displaced by d from the com."""
    return I_com + mass * (float(d @ d) * np.eye(3) - np.outer(d, d))


def _read_urdf_xml(path: str) -> dict:
    """URDF XML -> plain robot spec dict (the JSON-able format)."""
    robot = ET.parse(path).getroot()
    spec = {"name": robot.get("name", "robot"), "links": [], "joints": []}

    for el in robot.findall("link"):
        inert = el.find("inertial")
        if inert is None:
            mass, com, I = 0.0, np.zeros(3), np.zeros((3, 3))
        else:
            mass = float(inert.find("mass").get("value"))
            origin = inert.find("origin")
            xyz = [float(v) for v in (origin.get("xyz", "0 0 0").split()
                                      if origin is not None else "0 0 0"
                                      .split())]
            rpy = [float(v) for v in (origin.get("rpy", "0 0 0").split()
                                      if origin is not None else "0 0 0"
                                      .split())]
            R = _rpy_to_matrix(*rpy)
            com = np.asarray(xyz)
            ie = inert.find("inertia")
            I_local = np.array([
                [float(ie.get("ixx")), float(ie.get("ixy", 0)),
                 float(ie.get("ixz", 0))],
                [float(ie.get("ixy", 0)), float(ie.get("iyy")),
                 float(ie.get("iyz", 0))],
                [float(ie.get("ixz", 0)), float(ie.get("iyz", 0)),
                 float(ie.get("izz"))]])
            I = R @ I_local @ R.T   # inertia about com, link-frame axes
        spec["links"].append(dict(name=el.get("name"), mass=mass,
                                  com=list(map(float, com)),
                                  inertia=[list(map(float, r)) for r in I]))

    for el in robot.findall("joint"):
        origin = el.find("origin")
        ax = el.find("axis")
        lim = el.find("limit")
        spec["joints"].append(dict(
            name=el.get("name"), type=el.get("type"),
            parent=el.find("parent").get("link"),
            child=el.find("child").get("link"),
            xyz=[float(v) for v in (origin.get("xyz", "0 0 0") if origin
                 is not None else "0 0 0").split()],
            rpy=[float(v) for v in (origin.get("rpy", "0 0 0") if origin
                 is not None else "0 0 0").split()],
            axis=([float(v) for v in ax.get("xyz").split()]
                  if ax is not None else [0.0, 0.0, 1.0]),
            limit=([float(lim.get("lower", "-inf")),
                    float(lim.get("upper", "inf")),
                    float(lim.get("effort", "inf")),
                    float(lim.get("velocity", "inf"))]
                   if lim is not None else
                   [-np.inf, np.inf, np.inf, np.inf])))
    return spec


def build_model(spec: dict, root_link: str | None = None,
                sites: tuple = DEFAULT_SITES,
                zero_mass_floor: float = 1e-8) -> RobotModel:
    """Robot spec dict -> lumped-tree RobotModel."""
    links = {}
    for lk in spec["links"]:
        mass = lk["mass"]
        I = np.asarray(lk["inertia"], dtype=np.float64)
        # zero-mass fix-up (reference simulation.py:412-417)
        if mass == 0.0:
            mass, I = zero_mass_floor, 1e-10 * np.eye(3)
        links[lk["name"]] = (mass, np.asarray(lk["com"], np.float64), I)

    child_of = {j["child"]: j for j in spec["joints"]}
    children: dict[str, list[dict]] = {}
    for j in spec["joints"]:
        children.setdefault(j["parent"], []).append(j)

    if root_link is None:
        root_link = next(lk["name"] for lk in spec["links"]
                         if lk["name"] not in child_of)

    # --- walk the tree, creating movable bodies and lumping fixed links ---
    bodies: list[dict] = []
    site_map: dict[str, tuple] = {}

    def new_body(link_name, parent_idx, T_tree, axis, jname, limit):
        bodies.append(dict(link=link_name, parent=parent_idx, T_tree=T_tree,
                           axis=np.asarray(axis, np.float64), jname=jname,
                           limit=limit, parts=[]))
        return len(bodies) - 1

    def absorb(body_idx: int, link_name: str, T_from_body: np.ndarray):
        """Attach link_name (and its fixed subtree) to body_idx at offset
        T_from_body; recurse into movable children creating new bodies."""
        bodies[body_idx]["parts"].append((link_name, T_from_body))
        if link_name in sites:
            site_map[link_name] = (body_idx, T_from_body.copy())
        for j in children.get(link_name, ()):  # document order
            T_child = T_from_body @ _pose_to_T(j["xyz"], j["rpy"])
            if j["type"] == "fixed":
                absorb(body_idx, j["child"], T_child)
            elif j["type"] in ("revolute", "continuous"):
                ci = new_body(j["child"], body_idx, T_child, j["axis"],
                              j["name"], j["limit"])
                absorb(ci, j["child"], np.eye(4))
            else:
                raise NotImplementedError(
                    f"joint type {j['type']!r} ({j['name']})")

    base = new_body(root_link, -1, np.eye(4), [0.0, 0.0, 1.0], None,
                    [-np.inf, np.inf, np.inf, np.inf])
    absorb(base, root_link, np.eye(4))

    nb = len(bodies)
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for i, b in enumerate(bodies):
        m_tot, mc = 0.0, np.zeros(3)
        for ln, T in b["parts"]:
            m, c, _ = links[ln]
            m_tot += m
            mc += m * (T[:3, :3] @ c + T[:3, 3])
        c_tot = mc / m_tot
        I_tot = np.zeros((3, 3))
        for ln, T in b["parts"]:
            m, c, I = links[ln]
            I_b = T[:3, :3] @ I @ T[:3, :3].T
            d = (T[:3, :3] @ c + T[:3, 3]) - c_tot
            I_tot += _shift_inertia(I_b, m, d)
        mass[i], com[i], inertia[i] = m_tot, c_tot, I_tot

    parent = np.array([b["parent"] for b in bodies], dtype=np.int32)
    T_tree = np.stack([b["T_tree"] for b in bodies]).astype(np.float64)
    axis = np.stack([b["axis"] for b in bodies])
    joint_names = tuple(b["jname"] for b in bodies[1:])
    limits = np.array([b["limit"] for b in bodies[1:]], dtype=np.float64)

    ancestor = np.zeros((nb, nb), dtype=bool)
    for i in range(nb):
        k = i
        while k >= 0:
            ancestor[i, k] = True
            k = parent[k]

    return RobotModel(
        name=spec.get("name", "robot"), nb=nb, nj=nb - 1, parent=parent,
        T_tree=T_tree, axis=axis, mass=mass, com=com, inertia=inertia,
        ancestor=ancestor, joint_names=joint_names, sites=site_map,
        joint_limits=limits[:, 0:2], effort_limits=limits[:, 2],
        velocity_limits=limits[:, 3])


def parse_urdf(path: str, **kw) -> RobotModel:
    return build_model(_read_urdf_xml(path), **kw)


def load_spec(path: str, **kw) -> RobotModel:
    with open(path) as f:
        return build_model(json.load(f), **kw)


def load_hrp4(payload: bool = False) -> RobotModel:
    """The HRP-4 model from this repo's compact JSON spec (dynamics
    parameters only; extracted by tools/extract_hrp4.py)."""
    fname = "hrp4_payload.json" if payload else "hrp4.json"
    return load_spec(os.path.join(ASSETS_DIR, fname))

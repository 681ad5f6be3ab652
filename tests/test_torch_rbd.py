"""The port's rotation utilities, robot-model loader and rigid-body layer
against the JAX package's, in f64 on the CPU: the same numpy inputs from a
seed go through both (the JAX side under vmap), tolerance 1e-10."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmpc_tpu.rbd import algorithms as jrbd, urdf as jurdf
from cmpc_tpu.utils import rotations as jrot
from cmpc_tpu_torch import convert
from cmpc_tpu_torch.rbd import algorithms as trbd, urdf as turdf
from cmpc_tpu_torch.utils import rotations as trot

torch.set_num_threads(1)

B = 4
TOL = dict(rtol=0, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def models():
    return jurdf.load_hrp4(), turdf.load_hrp4()


def random_state(model, seed=0, batch=B):
    """(q dict, qv) numpy, with a proper rotation as base_rot."""
    rng = np.random.default_rng(seed)
    rv = rng.normal(size=(batch, 3)) * 0.4
    rot = np.asarray(jax.vmap(jrot.rotvec_to_matrix)(jnp.asarray(rv)))
    q = dict(base_pos=rng.normal(size=(batch, 3)) * 0.3, base_rot=rot,
             qj=rng.uniform(-0.8, 0.8, size=(batch, model.nj)))
    return q, rng.normal(size=(batch, model.nv)) * 0.5


def both_states(models, seed=0):
    jm, tm = models
    qd, qv = random_state(jm, seed)
    jq = jrbd.RobotQ(**{k: jnp.asarray(v) for k, v in qd.items()})
    return jq, jnp.asarray(qv), convert.robot_q_from_numpy(qd), \
        torch.tensor(qv)


def close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **{**TOL, **kw})


# ---------------------------------------------------------------- rotations

@pytest.mark.parametrize("name", ["rot_z", "hat", "rotvec_to_matrix",
                                  "matrix_to_rotvec", "rotvec_difference",
                                  "pose_difference"])
def test_rotations_match(name):
    """Every rotation utility on random inputs that include the exact
    identity, a sub-threshold angle and a near-pi angle."""
    rng = np.random.default_rng(1)
    rv = rng.normal(size=(8, 3))
    rv[0] = 0.0
    rv[1] = [1e-10, 0.0, 0.0]
    rv[2] = rv[2] / np.linalg.norm(rv[2]) * (np.pi - 1e-3)
    rv2 = rng.normal(size=(8, 3)) * 0.5
    rv2[0] = 0.0
    jf, tf = getattr(jrot, name), getattr(trot, name)
    if name == "rot_z":
        args = (rv[:, 0],)
    elif name in ("hat", "rotvec_to_matrix"):
        args = (rv,)
    elif name == "matrix_to_rotvec":
        args = (np.asarray(jrot.rotvec_to_matrix(jnp.asarray(rv * 0.9))),)
    elif name == "rotvec_difference":
        args = (rv * 0.5, rv2)
    else:
        args = (np.concatenate([rv2, rv * 0.5], 1),
                np.concatenate([rv, rv2], 1))
    want = jf(*(jnp.asarray(a) for a in args))
    got = tf(*(torch.tensor(a) for a in args))
    assert np.isfinite(got.numpy()).all()
    close(got, want)


def test_rotations_nan_free_in_f32():
    """Both sides of every select stay finite in f32 at the identity (the
    guarded divisions and the clamped acos argument)."""
    rv = torch.zeros(3, 3, dtype=torch.float32)
    rv[1, 0] = 1e-9
    R = trot.rotvec_to_matrix(rv)
    back = trot.matrix_to_rotvec(R * (1.0 + 1e-6))   # trace slightly > 3
    assert torch.isfinite(R).all() and torch.isfinite(back).all()
    assert back.abs().max() < 1e-5


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("payload", [False, True])
def test_robot_model_fields_identical(payload):
    """The port's copy of the loader builds the same RobotModel, field by
    field, exactly."""
    a, b = jurdf.load_hrp4(payload), turdf.load_hrp4(payload)
    for f in ("name", "nb", "nj", "joint_names", "nv", "total_mass"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("parent", "T_tree", "axis", "mass", "com", "inertia",
              "ancestor", "joint_limits", "effort_limits",
              "velocity_limits"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert set(a.sites) == set(b.sites)
    for k in a.sites:
        assert a.sites[k][0] == b.sites[k][0]
        np.testing.assert_array_equal(a.sites[k][1], b.sites[k][1])
    assert a.dof_index("R_KNEE_P") == b.dof_index("R_KNEE_P")
    assert turdf.ASSETS_DIR == jurdf.ASSETS_DIR


def test_model_is_hrp4_size(models):
    _, tm = models
    assert (tm.nb, tm.nj, tm.nv) == (25, 24, 30)


# --------------------------------------------------------------- algorithms

def test_fk(models):
    jm, tm = models
    jq, _, tq, _ = both_states(models)
    jf = jax.vmap(lambda q: jrbd.fk(jm, q))(jq)
    tf = trbd.fk(tm, tq)
    for name in jf._fields:
        close(getattr(tf, name), getattr(jf, name), err_msg=name)


@pytest.mark.parametrize("fn", ["mass_matrix", "_body_com_jacobians", "com",
                                "com_jacobian", "centroidal_inertia"])
def test_configuration_functions(models, fn):
    jm, tm = models
    jq, _, tq, _ = both_states(models, seed=2)
    want = jax.vmap(lambda q: getattr(jrbd, fn)(jm, jrbd.fk(jm, q)))(jq)
    got = getattr(trbd, fn)(tm, trbd.fk(tm, tq))
    close(got, want)


@pytest.mark.parametrize("fn", ["velocities", "bias_forces",
                                "centroidal_momentum"])
def test_velocity_functions(models, fn):
    jm, tm = models
    jq, jqv, tq, tqv = both_states(models, seed=3)
    want = jax.vmap(lambda q, v: getattr(jrbd, fn)(jm, jrbd.fk(jm, q), v))(
        jq, jqv)
    got = getattr(trbd, fn)(tm, trbd.fk(tm, tq), tqv)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            close(g, w)
    else:
        close(got, want)


def test_bias_accelerations_and_site_terms(models):
    jm, tm = models
    jq, jqv, tq, tqv = both_states(models, seed=4)

    def jall(q, v):
        f = jrbd.fk(jm, q)
        vel = jrbd.velocities(jm, f, v)
        bias = jrbd.bias_accelerations(jm, f, vel, v)
        return (bias.alpha, bias.a_origin,
                jrbd.com_bias_acc(jm, f, vel, bias),
                *jrbd.site_bias_acc(jm, f, vel, bias, "l_sole"),
                *jrbd.site_bias_acc(jm, f, vel, bias, "torso"))

    want = jax.vmap(jall)(jq, jqv)
    f = trbd.fk(tm, tq)
    vel = trbd.velocities(tm, f, tqv)
    bias = trbd.bias_accelerations(tm, f, vel, tqv)
    got = (bias.alpha, bias.a_origin, trbd.com_bias_acc(tm, f, vel, bias),
           *trbd.site_bias_acc(tm, f, vel, bias, "l_sole"),
           *trbd.site_bias_acc(tm, f, vel, bias, "torso"))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("site", ["body", "torso", "l_sole", "r_sole"])
def test_site_functions(models, site):
    jm, tm = models
    jq, jqv, tq, tqv = both_states(models, seed=5)

    def jall(q, v):
        f = jrbd.fk(jm, q)
        return (*jrbd.site_pose(jm, f, site), jrbd.site_jacobian(jm, f, site),
                *jrbd.site_velocity(jm, f, v, site))

    want = jax.vmap(jall)(jq, jqv)
    f = trbd.fk(tm, tq)
    got = (*trbd.site_pose(tm, f, site), trbd.site_jacobian(tm, f, site),
           *trbd.site_velocity(tm, f, tqv, site))
    for g, w in zip(got, want):
        close(g, w)


def test_point_jacobian_and_batch_of_points(models):
    jm, tm = models
    jq, _, tq, _ = both_states(models, seed=6)
    pts = np.random.default_rng(6).normal(size=(B, 3, 3))
    idx = tm.sites["r_sole"][0]
    want = jax.vmap(lambda q, pp: jax.vmap(
        lambda p: jrbd.point_jacobian(jm, jrbd.fk(jm, q), idx, p))(pp))(
        jq, jnp.asarray(pts))
    f = trbd.fk(tm, tq)
    got = trbd.point_jacobians(tm, f, idx, torch.tensor(pts))
    close(got, want)
    close(trbd.point_jacobian(tm, f, idx, torch.tensor(pts[:, 1])),
          want[:, 1])


def test_forward_dynamics_and_integrate(models):
    """Tolerance 1e-8 on qdd: the 30x30 solve amplifies last-bit
    differences of M by its condition number (~1e4)."""
    jm, tm = models
    jq, jqv, tq, tqv = both_states(models, seed=7)
    rng = np.random.default_rng(7)
    tau = rng.normal(size=(B, jm.nj)) * 5.0
    w = rng.normal(size=(B, 6)) * 20.0
    want = jax.vmap(lambda q, v, t, ww: jrbd.forward_dynamics(
        jm, q, v, t, contact_wrenches=(("l_sole", ww),)))(
        jq, jqv, jnp.asarray(tau), jnp.asarray(w))
    got = trbd.forward_dynamics(tm, tq, tqv, torch.tensor(tau),
                                contact_wrenches=(("l_sole",
                                                   torch.tensor(w)),))
    close(got, want, atol=1e-8 * float(np.abs(np.asarray(want)).max()))
    jq2, jv2 = jax.vmap(lambda q, v, a: jrbd.integrate(q, v, a, 0.002))(
        jq, jqv, want)
    tq2, tv2 = trbd.integrate(tq, tqv, torch.tensor(np.asarray(want)), 0.002)
    close(tv2, jv2)
    for name in jq2._fields:
        close(getattr(tq2, name), getattr(jq2, name), err_msg=name)


def test_neutral_q_and_model_tensor_cache(models):
    _, tm = models
    q = trbd.neutral_q(tm, batch=2, dtype=torch.float64)
    assert q.base_pos.shape == (2, 3) and q.qj.shape == (2, tm.nj)
    assert torch.equal(q.base_rot[1], torch.eye(3, dtype=torch.float64))
    a = trbd.model_tensors(tm, q.qj)
    assert trbd.model_tensors(tm, q.qj) is a        # built once
    b = trbd.model_tensors(tm, q.qj.float())
    assert b is not a and b.mass.dtype == torch.float32


def test_rows_are_independent(models):
    """A permuted batch gives bitwise the same rows (f64, CPU)."""
    _, tm = models
    _, _, tq, tqv = both_states(models, seed=8)
    perm = torch.tensor([2, 0, 3, 1])
    f = trbd.fk(tm, tq)
    M, h = trbd.mass_matrix(tm, f), trbd.bias_forces(tm, f, tqv)
    fp = trbd.fk(tm, trbd.RobotQ(*(x[perm] for x in tq)))
    assert torch.equal(trbd.mass_matrix(tm, fp), M[perm])
    assert torch.equal(trbd.bias_forces(tm, fp, tqv[perm]), h[perm])

"""The port's bindings of the native host library (cmpc_tpu_torch.native):
the g++ build into cmpc_tpu_torch/_build/, the trace sink (numpy rows and
tensors, files crossing between the two packages), and the native URDF
parser against the port's Python parser on a three-link robot."""

import numpy as np
import pytest
import torch

from cmpc_tpu import native as jnative
from cmpc_tpu_torch import native
from cmpc_tpu_torch.rbd import urdf

# the suite runs several worker processes per host: one intra-op thread
# each (more only oversubscribes the cores and slows every worker)
torch.set_num_threads(1)

URDF = """<?xml version="1.0"?>
<robot name="three_link">
  <link name="base">
    <inertial>
      <origin xyz="0.01 0.0 0.05" rpy="0 0 0"/>
      <mass value="3.5"/>
      <inertia ixx="0.02" ixy="0.001" ixz="0" iyy="0.03" iyz="0" izz="0.04"/>
    </inertial>
  </link>
  <link name="thigh">
    <inertial>
      <origin xyz="0 0 -0.15" rpy="0.1 -0.2 0.3"/>
      <mass value="1.25"/>
      <inertia ixx="0.011" ixy="0" ixz="0.0005" iyy="0.012" iyz="0.0002"
               izz="0.002"/>
    </inertial>
  </link>
  <link name="shank">
    <inertial>
      <origin xyz="0 0.01 -0.12"/>
      <mass value="0.75"/>
      <inertia ixx="0.006" iyy="0.006" izz="0.001"/>
    </inertial>
  </link>
  <link name="r_sole"/>
  <joint name="hip" type="revolute">
    <parent link="base"/>
    <child link="thigh"/>
    <origin xyz="0 -0.08 -0.05" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.2" effort="150" velocity="6.5"/>
  </joint>
  <joint name="knee" type="continuous">
    <parent link="thigh"/>
    <child link="shank"/>
    <origin xyz="0 0 -0.3" rpy="0 0.1 0"/>
    <axis xyz="0 1 0"/>
  </joint>
  <joint name="sole_fixed" type="fixed">
    <parent link="shank"/>
    <child link="r_sole"/>
    <origin xyz="0 0 -0.3"/>
  </joint>
</robot>
"""


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.build(), "g++ build of native/src failed"
    assert native.available()


def test_build_goes_to_the_port_build_dir():
    """The library lies in cmpc_tpu_torch/_build/, named by a hash of the
    sources and flags; a second build finds it."""
    p = native.library_path()
    assert p.exists() and p.parent == native.BUILD_DIR
    assert p.parent.name == "_build" and p.parent.parent.name == \
        "cmpc_tpu_torch"
    assert p.name.startswith("libcmpc_host-") and p.suffix == ".so"
    assert native.build()
    assert not [q for q in p.parent.iterdir()
                if q.name.startswith("tmp") and q.suffix == ".so"]


@pytest.mark.parametrize("kind", ["ndarray", "tensor"])
def test_trace_sink_round_trip(tmp_path, kind):
    """1e6 rows, appended in blocks and one by one, read back exactly;
    tensors (f64 here) are written as float32."""
    rows = np.arange(1_000_000 * 4, dtype=np.float32).reshape(-1, 4) / 7.0
    src = rows if kind == "ndarray" else torch.tensor(rows,
                                                      dtype=torch.float64)
    p = str(tmp_path / "run.ctrc")
    with native.TraceSink(p, ncols=4, buf_rows=512) as sink:
        for i in range(0, 990_000, 10_000):
            sink.append(src[i:i + 10_000])
        sink.append(src[990_000:999_990])
        for r in src[999_990:]:
            sink.append(r)
        assert sink.rows_written() == 1_000_000
    np.testing.assert_array_equal(native.TraceSink.read(p), rows)
    with native.TraceSink(str(tmp_path / "bad.ctrc"), ncols=4) as sink:
        with pytest.raises(ValueError, match="4 columns"):
            sink.append(np.zeros((2, 3)))


def test_trace_files_cross_between_the_packages(tmp_path, monkeypatch):
    """A file the port writes reads back through the JAX package's reader,
    and one the JAX package's bindings write reads back in the port.  The
    JAX bindings are pointed at the port's build of the same sources, so
    that this test never runs `make -C native` beside tests/test_native.py
    (whose build it would race)."""
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.library_path()))
    monkeypatch.setattr(jnative, "_lib", None)
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(3000, 5)).astype(np.float32)
    p, q = str(tmp_path / "port.ctrc"), str(tmp_path / "jax.ctrc")
    with native.TraceSink(p, ncols=5) as sink:
        sink.append(torch.tensor(rows))
    np.testing.assert_array_equal(jnative.TraceSink.read(p), rows)
    with jnative.TraceSink(q, ncols=5, buf_rows=100) as sink:
        sink.append(rows)
    np.testing.assert_array_equal(native.TraceSink.read(q), rows)


def test_urdf_parser_parity_and_model(tmp_path):
    """The native spec equals the port's Python spec field by field on a
    three-link URDF (rotated inertials, default limits and axes, a fixed
    link), and build_model gives the same robot from both."""
    path = tmp_path / "three_link.urdf"
    path.write_text(URDF)
    ns = native.parse_urdf_spec(str(path))
    ps = urdf._read_urdf_xml(str(path))
    assert ns["name"] == ps["name"] == "three_link"
    assert [lk["name"] for lk in ns["links"]] == \
        [lk["name"] for lk in ps["links"]]
    for nl, pl in zip(ns["links"], ps["links"]):
        np.testing.assert_allclose(nl["mass"], pl["mass"], rtol=1e-12)
        np.testing.assert_allclose(nl["com"], pl["com"], atol=1e-15)
        np.testing.assert_allclose(nl["inertia"], pl["inertia"], rtol=1e-9,
                                   atol=1e-18)
    assert len(ns["joints"]) == len(ps["joints"]) == 3
    for nj, pj in zip(ns["joints"], ps["joints"]):
        for k in ("name", "type", "parent", "child"):
            assert nj[k] == pj[k]
        for k in ("xyz", "rpy", "axis", "limit"):
            np.testing.assert_allclose(nj[k], pj[k], atol=1e-15)
    mn, mp = urdf.build_model(ns), urdf.build_model(ps)
    assert (mn.nb, mn.nj) == (mp.nb, mp.nj) == (3, 2)
    assert mn.joint_names == mp.joint_names == ("hip", "knee")
    assert set(mn.sites) == {"r_sole"}
    for k in ("mass", "com", "inertia", "T_tree", "axis", "joint_limits",
              "effort_limits", "velocity_limits"):
        np.testing.assert_allclose(getattr(mn, k), getattr(mp, k),
                                   rtol=1e-12, atol=1e-15, err_msg=k)
    np.testing.assert_allclose(mn.total_mass, 3.5 + 1.25 + 1e-8 + 0.75)
    with pytest.raises(FileNotFoundError):
        native.parse_urdf_spec(str(tmp_path / "missing.urdf"))

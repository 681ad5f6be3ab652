"""The JAX package's full-length acceptance walks, run by the port on the
card: every bound of tests/test_full_walk.py, tests/test_wholebody_payload.py
and the four checks of tests/test_closed_loop.py that chip_smoke.py's walk
phase did not make, each unchanged.

* One B = 2 centroidal rollout of the whole 2,100-tick walk in f32: row 0
  the nominal walk with its 3 N push over ticks 801-899, row 1 the payload
  walk (2 kg box at tick 0, gains k1 = 7, k2 = 1).  Both use WalkConfig()
  and differ only in scenario fields.  The push starts at tick 801, so the
  nominal row's first 500 ticks are the 500-tick walk of
  tests/conftest.py's fixture and carry test_closed_loop.py's checks.
* 150 whole-body ticks on the payload model (assets/hrp4_payload.json)
  with the box dropped at tick 30, f32, B = 1.

Both runs count the launches of the hand-written tile kernel: 120 a tick
(5 tiles x 8 interior-point iterations x 3 SQP iterations) shows that it
carried every solve of the walk.

The figures are those that tools/walk_envelope_torch.py prints for a
trace of either package.  Marked ``cuda`` and ``slow``; imports no JAX.
On the card (about 10 min; the centroidal walk runs at 3.6-6 ticks/s, a
whole-body tick takes about 0.8 s):

    python -m pytest tests/test_torch_envelopes.py -m "cuda and slow" \\
        --noconftest -q -s

``-s`` shows each test's figures beside its bounds.
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from cmpc_tpu_torch.config import (Scenario, WalkConfig, nominal_scenario,
                                   payload_scenario)
from cmpc_tpu_torch.ops import batched_chol as bc
from cmpc_tpu_torch.plan import timing as tm
from cmpc_tpu_torch.rbd.urdf import load_hrp4
from cmpc_tpu_torch.sim import closed_loop, wholebody_loop

pytestmark = [pytest.mark.cuda, pytest.mark.slow]

CFG = WalkConfig()
PER_TICK = 5 * CFG.pdip_iters * CFG.sqp_iters      # kernel launches a tick
T_DROP = 150

_spec = importlib.util.spec_from_file_location(
    "walk_envelope_torch", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "walk_envelope_torch.py"))
envelope = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(envelope)


def _say(msg):
    print(f"\n[envelopes] {msg}", flush=True)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


def _rows(tr):
    """The trace's rows as dicts of numpy float64 arrays (T, ...)."""
    B = tr.com_pos.shape[0]
    return [{k: v[b].double().cpu().numpy() for k, v in tr._asdict().items()}
            for b in range(B)]


@pytest.fixture(scope="module")
def full_walks(card):
    """Row 0: nominal_scenario(WalkConfig()) with its push; row 1:
    payload_scenario(WalkConfig()); the whole walk, one rollout, f32.
    Returns the figures of each row and the kernel's launches."""
    nom = nominal_scenario(CFG, device=card)
    pay = payload_scenario(CFG, device=card)
    sc = Scenario(*(torch.cat([a, b]) for a, b in zip(nom, pay)))
    timing = tm.build_timing(CFG)
    T = timing.total_ticks
    bc.LAUNCHES["chol_inv_tile"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = closed_loop.rollout(sc, CFG, T_sim=T)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bc.LAUNCHES["chol_inv_tile"]
    _say(f"B=2 walk of {T} ticks (f32): {wall:.1f} s, {T / wall:.2f} "
         f"ticks/s on {torch.cuda.get_device_name(card)}")
    nominal, payload = _rows(tr)
    events = np.nonzero(timing.update_event[:T])[0]
    assert len(events) == CFG.num_steps - 1 == 19
    return (envelope.nominal_figures(nominal, events),
            envelope.payload_figures(payload), launches, T,
            np.array_equal(np.nonzero(payload["adapted"])[0], events))


def test_full_walk_kernel_carried_every_tick(full_walks):
    launches, T = full_walks[2:4]
    _say(f"walk: chol_inv_tile launches {launches} (want {PER_TICK} x {T})")
    assert launches == PER_TICK * T


def test_full_walk_completes(full_walks):
    """tests/test_full_walk.py::test_full_walk_completes on row 0."""
    f = full_walks[0]
    _say(f"nominal: err_xy to T-200 {f['err_xy_to_T_minus_200']:.4f} (< "
         f"0.035; first over it at tick {f['err_xy_first_tick_over_0.035']}),"
         f" overall {f['err_xy_max']:.4f} (< 0.12; at tick "
         f"{f['err_xy_argmax_tick']}), |z-h| {f['com_z_dev_max']:.4f} (< "
         f"0.03), final com_x {f['final_com_x']:.4f} (> 1.8), median r_prim "
         f"{f['r_prim_median']:.3e} (< 1e-2)")
    assert f["err_xy_to_T_minus_200"] < 0.035, f["err_xy_to_T_minus_200"]
    assert f["err_xy_max"] < 0.12, f["err_xy_max"]
    assert f["com_z_dev_max"] < 0.03
    assert f["final_com_x"] > 1.8, f["final_com_x"]
    assert f["r_prim_median"] < 1e-2
    assert f["com_pos_finite"]


def test_full_walk_hw_bounded(full_walks):
    """tests/test_full_walk.py::test_full_walk_hw_bounded on row 0."""
    f = full_walks[0]
    _say(f"nominal: |hw| to T-200 {f['hw_to_T_minus_200']:.4f} (< 3.2), "
         f"overall {f['hw_max']:.4f} (< 5.5; at tick {f['hw_argmax_tick']})")
    assert f["hw_to_T_minus_200"] < 3.2, f["hw_to_T_minus_200"]
    assert f["hw_max"] < 5.5, f["hw_max"]


def test_full_walk_adaptation_events(full_walks):
    """tests/test_full_walk.py::test_full_walk_adaptation_events, on both
    rows (the event ticks are the gait's, the same for both)."""
    f, _, _, _, payload_ok = full_walks
    _say(f"adaptation at exactly the 19 event ticks: nominal "
         f"{f['adaptation_at_event_ticks']}, payload {payload_ok}")
    assert f["adaptation_at_event_ticks"] and payload_ok


def test_full_walk_push_recovery(full_walks):
    """tests/test_full_walk.py::test_full_walk_push_recovery on row 0."""
    f = full_walks[0]
    pre, post = f["push_pre_600_799"], f["push_post_1200_1399"]
    _say(f"push: pre {pre:.4f}, post {post:.4f} (< {max(2 * pre, 0.03):.4f})")
    assert post < max(2.0 * pre, 0.03), (pre, post)


def test_full_payload_walk_completes(full_walks):
    """tests/test_full_walk.py::test_full_payload_walk_completes on row 1."""
    f = full_walks[1]
    _say(f"payload: err_xy to T-200 {f['err_xy_to_T_minus_200']:.4f} (< "
         f"0.08), overall {f['err_xy_max']:.4f} (< 0.15), final com_x "
         f"{f['final_com_x']:.4f} (> 1.8), |hw| to T-200 "
         f"{f['hw_to_T_minus_200']:.4f} (< 4.5), overall {f['hw_max']:.4f} "
         f"(< 8.0; at tick {f['hw_argmax_tick']})")
    assert f["err_xy_to_T_minus_200"] < 0.08, f["err_xy_to_T_minus_200"]
    assert f["err_xy_max"] < 0.15, f["err_xy_max"]
    assert f["final_com_x"] > 1.8
    assert f["hw_to_T_minus_200"] < 4.5
    assert f["hw_max"] < 8.0


def test_walk_segment_force_and_progress(full_walks):
    """The two checks of tests/test_closed_loop.py::
    test_walk_segment_tracks_reference that chip_smoke.py's walk phase did
    not make before, on row 0's first 500 ticks."""
    f = full_walks[0]
    _say(f"500 ticks: |mean fz - m g| {f['fz_mean_gap_50_499']:.3f} N (< "
         f"30), com_x at tick 499 {f['com_x_499']:.4f} (> 0.1)")
    assert f["fz_mean_gap_50_499"] < 30.0
    assert f["com_x_499"] > 0.1


def test_walk_hw_bounded_like_reference(full_walks):
    """tests/test_closed_loop.py::test_walk_hw_bounded_like_reference on
    row 0's first 500 ticks."""
    f = full_walks[0]
    _say(f"500 ticks: |hw| max {f['hw_max_0_499']:.4f} (< 4.0), over "
         f"200-269 {f['hw_max_200_269']:.4f} (> 0.3), min from 480 "
         f"{f['hw_min_480_499']:.4f} (< {f['hw_max_200_479']:.4f})")
    assert f["hw_max_0_499"] < 4.0, f["hw_max_0_499"]
    assert f["hw_max_200_269"] > 0.3
    assert f["hw_min_480_499"] < f["hw_max_200_479"]


def test_payload_drop_on_wholebody_plant(card):
    """tests/test_wholebody_payload.py::test_payload_drop_on_wholebody_plant
    on the card, and 120 kernel launches a tick."""
    model = load_hrp4(payload=True)
    sc = payload_scenario(CFG, onset_tick=30, device=card)
    bc.LAUNCHES["chol_inv_tile"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tr = wholebody_loop.rollout(model, sc, CFG, T_sim=T_DROP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bc.LAUNCHES["chol_inv_tile"]
    tr = _rows(tr)[0]
    err_xy = np.linalg.norm(tr["com_pos"][:, :2] - tr["com_ref"][:, :2],
                            axis=-1)
    z = tr["com_pos"][:, 2]
    _say(f"payload drop (f32, {wall:.1f} s, {wall / T_DROP * 1e3:.0f} ms "
         f"a tick): err_xy {err_xy.max():.4f} (< 0.08), min z "
         f"{z.min():.4f} (> {CFG.h - 0.06:.2f}), |z_end - h| "
         f"{abs(z[-1] - CFG.h):.4f} (< 0.03), sole z max l "
         f"{tr['pose_l'][:, 5].max():.4f} r {tr['pose_r'][:, 5].max():.4f} "
         f"(< 0.02); chol_inv_tile launches {launches} (want {PER_TICK} x "
         f"{T_DROP})")
    assert np.isfinite(tr["com_pos"]).all()
    assert err_xy.max() < 0.08, err_xy.max()
    assert z.min() > CFG.h - 0.06
    assert abs(z[-1] - CFG.h) < 0.03
    assert tr["pose_l"][:, 5].max() < 0.02
    assert tr["pose_r"][:, 5].max() < 0.02
    assert launches == PER_TICK * T_DROP

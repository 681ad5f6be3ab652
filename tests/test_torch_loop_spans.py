"""The closed loop's spans and counters (``sim/closed_loop.py`` through
``runtime/spans.py``) on the CPU at B = 8: off they leave no record, on the
tick's parts nest in ``closed_loop.tick`` and the counters equal the hand
counts, and either way the tick's output is the same bits.  The tick makes
no eigendecomposition (on the card ``eigh`` makes the host wait), and its
answer is the bits of the solve that makes its own."""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _sweep_cases import (ADAPT, CFG, IMPACT, hand_counts, run_tick,  # noqa: E402
                          start)
from cmpc_tpu_torch.ocp import condense  # noqa: E402
from cmpc_tpu_torch.ops import sqp  # noqa: E402
from cmpc_tpu_torch.runtime import spans  # noqa: E402
from cmpc_tpu_torch.sim import closed_loop  # noqa: E402

torch.set_num_threads(1)

LOOP_SPANS = ("closed_loop.refs", "closed_loop.adapt", "closed_loop.plant",
              "sqp.solve_mpc")
SOLVE_SPANS = ("sqp.warm_start", "condense.build", "pdip.pdip_solve",
               "sqp.line_search")


@pytest.fixture(autouse=True)
def tracing_off():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


@pytest.fixture(scope="module", params=[IMPACT, ADAPT])
def case(request):
    t = request.param
    sc, carry = start(t, torch.float32)
    return t, sc, carry


def traced(sc, carry, t):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run_tick(sc, carry, t)
    ann = sorted((e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation())
    return out, ann


def parent(ann, a):
    held = [b for b in ann if b is not a and b[1] <= a[1] and a[2] <= b[2]]
    return max(held, key=lambda b: b[1])[0] if held else None


def test_off_leaves_no_record(case):
    t, sc, carry = case
    _, ann = traced(sc, carry, t)
    assert ann == []
    assert not any(k.startswith("closed_loop.") for k in spans.counters())


def test_on_the_tick_spans_nest(case):
    t, sc, carry = case
    with spans.recording():
        _, ann = traced(sc, carry, t)
    names = [a[0] for a in ann]
    want = {"closed_loop.tick": 1, "closed_loop.refs": 1,
            "closed_loop.plant": 1, "closed_loop.adapt": int(t == ADAPT),
            "sqp.solve_mpc": 1}
    assert {n: names.count(n) for n in want} == want
    for a in ann:
        if a[0] == "closed_loop.tick":
            assert parent(ann, a) is None
        elif a[0] in LOOP_SPANS:
            assert parent(ann, a) == "closed_loop.tick", a
        elif a[0] == "pdip.newton_matrix":
            assert parent(ann, a) == "pdip.pdip_solve"
        else:
            assert a[0] in SOLVE_SPANS and parent(ann, a) == "sqp.solve_mpc"


def test_counters_equal_the_hand_counts(case):
    t, sc, carry = case
    with spans.recording():
        after, _ = run_tick(sc, carry, t)
    c = spans.counters()
    pushed, impacts = hand_counts(t)
    assert (c["closed_loop.pushed"], c["closed_loop.impacts"],
            c["closed_loop.ticks"]) == (pushed, impacts, 1)
    with spans.recording():
        run_tick(sc, after, t + 1)
    c = spans.counters()
    assert c["closed_loop.ticks"] == 2
    assert c["closed_loop.pushed"] == pushed + hand_counts(t + 1)[0]


def test_outputs_are_the_same_bits_on_and_off(case):
    t, sc, carry = case
    off = run_tick(sc, carry, t)
    with spans.recording():
        on = run_tick(sc, carry, t)
    flat = [torch.utils._pytree.tree_leaves(x) for x in (off, on)]
    assert len(flat[0]) == len(flat[1]) > 20
    for a, b in zip(*flat):
        assert torch.equal(a, b)


def test_the_tick_makes_no_eigendecomposition(case, monkeypatch):
    t, sc, carry = case
    _, tick = closed_loop.rollout(sc, CFG, return_tick=True, t0=t,
                                  carry_in=carry)
    real, calls = torch.linalg.eigh, []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.linalg, "eigh", counted)
    tick(carry, t)
    assert calls == []
    # the solve without the loop's soft-row core makes it once, not once
    # an SQP iteration
    solve = sqp.solve_mpc
    monkeypatch.setattr(sqp, "solve_mpc",
                        lambda state, params, cfg, soft_q: solve(
                            state, params, cfg))
    tick(carry, t)
    assert calls == [(8, 4, 4)]


def test_the_loops_soft_row_core_gives_the_same_bits(case, monkeypatch):
    t, sc, carry = case
    kept = run_tick(sc, carry, t)
    solve = sqp.solve_mpc
    monkeypatch.setattr(sqp, "solve_mpc",
                        lambda state, params, cfg, soft_q: solve(
                            state, params, cfg))
    own = run_tick(sc, carry, t)
    flat = [torch.utils._pytree.tree_leaves(x) for x in (kept, own)]
    assert len(flat[0]) == len(flat[1]) > 20
    for a, b in zip(*flat):
        assert torch.equal(a, b)
    k1, m = sc.k1, sc.mpc_mass
    assert torch.equal(condense.soft_row_q(k1, m, psd=False)[:, 2, :2],
                       torch.stack([k1, torch.ones_like(k1)], -1))

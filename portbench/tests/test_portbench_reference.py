"""The reference against the program on the CPU, in float64: from the same
start and the same parameters they give the same answer, step after step
of a chain.  (The reference imports nothing of the program; the program is
imported here only to be compared.)"""

import json
import os
import subprocess
import sys

import torch

from portbench import traffic
from portbench.core import ROOT


def _walk():
    with open(os.path.join(ROOT, "portbench/configs/hrp4-centroidal.json")) \
            as f:
        return json.load(f)["walk_config"]


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.solve;"
            "import portbench.reference.nlp;"
            "import portbench.reference.tf32;"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'cmpc_tpu_torch', 'cmpc_tpu', 'jax', 'jaxlib'});"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_reference_solves_as_the_program_in_float64():
    """Three chained solves of 8 recorded ticks from the cold start: the
    program's (its plain tile path on the CPU) and the reference's agree
    to rounding, each from the program's own start."""
    from cmpc_tpu_torch.config import WalkConfig
    from cmpc_tpu_torch.ocp.problem import MPCParams
    from cmpc_tpu_torch.ops import sqp
    from portbench.reference.solve import Reference
    walk = _walk()
    mix = dict(traffic.load_mix("recorded-ticks-b2048"), batch=8,
               warm_chain=2)
    inputs = traffic.generate(mix, 7, walk)
    cfg = WalkConfig(**dict(walk, stance_box=tuple(walk["stance_box"])))
    f64 = torch.float64
    ref = Reference(walk, "cpu")
    state = sqp.SolverState(*(torch.as_tensor(a).to(f64)
                              for a in inputs["start"]))
    for arrays in inputs["params"]:
        params = MPCParams(**{k: torch.as_tensor(v).to(f64)
                              for k, v in arrays.items()})
        new, _ = sqp.solve_mpc(state, params, cfg)
        z, y = ref.solve(state.z, state.y, ref.params(arrays))
        gap = (new.z - z).norm(dim=1) / z.norm(dim=1)
        assert gap.max() < 1e-9, gap
        assert (new.y - y).abs().max() < 1e-6 * y.abs().max()
        state = new

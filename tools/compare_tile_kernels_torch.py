"""The port's tile kernels against those of another checkout of the repo,
bit for bit and by the clock, on one GPU.

    mkdir OLD && git archive <commit> | tar -x -C OLD
    python tools/compare_tile_kernels_torch.py OLD

Both trees are driven through the package's public wrappers,
``cmpc_tpu_torch.ops.batched_chol.chol_inv_tile(A)`` and ``chol_tile(A)``,
so the two may differ in anything beneath them: sources, C interface,
build.  Each tree runs in a process of its own (old, new, new, old) that
builds the tree's kernels with nvcc into the tree's own ``_build``.  For
T = 1, 7, 256 and 1280 tiles, f32 and f64 — the 7 include a zero pivot, a
NaN, a negative definite tile, an inf and a tile scaled over nine decades —
the script checks that L and X of the two trees are equal bit for bit (NaN
at the same places, as ``torch.equal`` would say of the rest) and exits
non-zero if not.  It times both at T = 1, 256, 1024 and 1280 in f32, a
CUDA-graph replay of 50 wrapper calls, and prints one JSON object with the
least time of each tree's two processes.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKED_TILES = (1, 7, 256, 1280)
TIMED_TILES = (1, 256, 1024, 1280)


def spd_tiles(rng, T):
    G = rng.normal(size=(T, 64, 64)) * 0.3
    M = G @ np.swapaxes(G, 1, 2) + 5.0 * np.eye(64)
    if T == 7:
        M[1, 7, :] = 0.0
        M[1, :, 7] = 0.0
        M[2, 5, 5] = np.nan
        M[3] = -M[3]
        M[4, 40, 3] = M[4, 3, 40] = np.inf
        d = np.sqrt(10.0 ** rng.uniform(-3, 6, size=64))
        M[5] *= d[:, None] * d[None, :]
    return M


def digest(t):
    """A hash that two tensors share exactly when they have NaN at the same
    places and are ``torch.equal`` elsewhere."""
    import torch
    nan = torch.isnan(t)
    rest = t.masked_fill(nan, 0) + 0            # -0 and +0 are equal
    return hashlib.sha256(nan.cpu().numpy().tobytes()
                          + rest.cpu().numpy().tobytes()).hexdigest()


def worker(tree):
    """Run in a process of its own: the kernels of the checkout `tree`.
    Prints one JSON object: a digest of every result, the f32 times."""
    sys.path.insert(0, tree)
    import torch
    from cmpc_tpu_torch.ops import batched_chol as bc
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(REPO, "chip_smoke.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)

    dev = torch.device("cuda", 0)
    digests = {}
    rng = np.random.default_rng(0)
    for T in CHECKED_TILES:
        M = spd_tiles(rng, T)
        for dtype in (torch.float32, torch.float64):
            A = torch.tensor(M, dtype=dtype, device=dev)
            L, X = bc.chol_inv_tile(A)
            L2 = bc.chol_tile(A)
            torch.cuda.synchronize()
            for name, t in (("chol_inv_tile L", L), ("chol_inv_tile X", X),
                            ("chol_tile L", L2)):
                digests[f"T={T} {dtype} {name}"] = digest(t)
    times = {"chol_inv_tile": {}, "chol_tile": {}}
    for T in TIMED_TILES:
        A = torch.tensor(spd_tiles(np.random.default_rng(1), T),
                         dtype=torch.float32, device=dev)
        runs = (("chol_inv_tile", lambda: bc.chol_inv_tile(A)),
                ("chol_tile", lambda: bc.chol_tile(A)))
        for order in (runs, runs[::-1]):
            for name, fn in order:
                t = timing.graph_ms(fn)
                times[name][str(T)] = min(t, times[name].get(str(T), t))
    print(json.dumps({"digests": digests, "f32_ms_by_tiles": times}),
          flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2])
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    trees = {"old": os.path.abspath(sys.argv[1]), "new": REPO}
    results = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[which]], cwd=trees[which], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"the {which} tree's run failed:\n{proc.stderr}")
        results[which].append(json.loads(proc.stdout.splitlines()[-1]))

    equal = True
    want = results["old"][0]["digests"]
    for key in want:
        ok = all(r["digests"][key] == want[key]
                 for rs in results.values() for r in rs)
        equal &= ok
        print(f"{key}: {'bit-identical' if ok else 'DIFFERS'}", flush=True)
    times = {
        name: {T: {f"{which}_ms": min(r["f32_ms_by_tiles"][name][T]
                                      for r in results[which])
                   for which in ("old", "new")}
               for T in map(str, TIMED_TILES)}
        for name in ("chol_inv_tile", "chol_tile")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip(), "bit_identical": equal,
                      "f32_ms_by_tiles": times}, indent=1), flush=True)
    sys.exit(0 if equal else 1)


if __name__ == "__main__":
    main()

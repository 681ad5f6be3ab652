"""loop.share: percent of a closed-loop tick spent outside its solve: the
spans around the load's tick less the spans around sqp.solve_mpc inside
them, over the tick's spans, each with a synchronize at both ends (program
spans taken from the benchmark's wrappers)."""


def read(run):
    spans = run.get("spans") or {}
    tick, solve = sum(spans.get("tick", [])), sum(spans.get("solve", []))
    return 100.0 * (tick - solve) / tick if tick > 0 and solve > 0 else None

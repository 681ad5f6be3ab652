"""idle_share.solve: percent of the profiled stretch of the traced run in which
the device ran no kernel, copy or set: 1 - (union of its intervals) /
(the stretch's wall time) (device trace)."""

from portbench.readers import idle_share


def read(run):
    return idle_share(run)

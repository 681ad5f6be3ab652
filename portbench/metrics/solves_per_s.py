"""solves_per_s: scenario-solves completed in the window over the
window's seconds (host clock; the window ends when the device has finished
the last solve)."""


def read(run):
    if "profile" in run:
        return None
    return sum(u for _, u in run["steps"]) / run["window_s"]

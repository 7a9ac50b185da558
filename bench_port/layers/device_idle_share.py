"""Device: the share of a solve's wall in which no operation ran on the
card, 1 - busy / wall, with busy from the profiler's trace of one solve
and wall that of the same start solved untraced in the same process
(tracing slows the host, so the traced wall would overstate it)."""


def read(obs):
    if obs.trace is None or not obs.untraced_wall_s or \
            obs.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.untraced_wall_s)

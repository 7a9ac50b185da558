"""Update and residual (solvers/lobpcg.py): the share of the W and P
columns that the window's solves searched in that were live, the
program's LOBPCGResult.live_cols summed over the window's solves over
2 * size_sub * iterations, %.  The blocks keep their full width with dead
columns zero, so 100 minus this is the share of the tall work (Grams,
projections, operator applies of W) that runs on dead columns.  None for
a program without the count."""


def read(obs):
    live = getattr(obs, "live_cols", None)
    cols = getattr(obs, "search_cols", None)
    if not live or not cols or sum(cols) <= 0:
        return None
    return 100.0 * sum(live) / sum(cols)

"""Host loop (solvers/ilobpcg.py, ops/lanes.py): iterations a solve, the
mean of SolveResult.iterations over the window's solves (a program
counter)."""


def read(obs):
    if not obs.iterations:
        return None
    return sum(obs.iterations) / len(obs.iterations)

"""Training traffic: the recipe's optimizer steps back to back, each of
its micro-steps fed by the loader as the train CLI feeds it
(benchmark/training.py). The rate is images over the window, the step in
progress at its close counted by the share of it inside.

Workload keys read: `correct` (the limits of the check)."""

from benchmark import training


def run(run_):
    return training.run_cell(run_)

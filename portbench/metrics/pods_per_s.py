"""Pods of every problem solved in the window over the window's seconds."""


def read(run):
    return sum(r.pods for r in run.rounds) / run.window_s

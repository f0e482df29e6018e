"""Instances solved per second: the instances of every call in the
window whose status is SOLVE_SUCCEEDED (the asked tolerance; a solve
only to the acceptable level counts as failed), over the time from the
first call's start to the last call's end."""

from perfbench.reference.judge import SOLVE_SUCCEEDED


def read(run):
    calls = run.timed_calls
    solved = sum(s == SOLVE_SUCCEEDED for c in calls for s in c.statuses)
    return solved / (calls[-1].end - calls[0].start)

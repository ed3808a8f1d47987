"""Share of the window in the program's em_tasks stage
(em.tasks_from_cigars: subsequences, anchors, splitting)."""

from benchmark.lib.readers import stage_share


def read(run):
    return stage_share(run, "em_tasks")

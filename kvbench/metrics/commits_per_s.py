"""Committed txns over the whole measured window, by the host clock:
every group the window handed in, to the last one's verdicts."""


def read(run):
    if run.window_s <= 0:
        return None
    committed = sum(int((g.verdicts == 0).sum()) for g in run.groups
                    if g.verdicts is not None)
    return committed / run.window_s

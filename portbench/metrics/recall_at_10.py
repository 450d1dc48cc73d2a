"""recall_at_10: the mean recall@10 (paper Eq. 2) of every query served
in the window, against the reference's exact answer, worked out after
the window."""

UNIT = "fraction"


def read(run):
    return run.recall

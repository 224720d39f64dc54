"""Collectives, fusion and the hand-written kernels of the port."""

# Every kernel wrapper whose ``<wrapper>.launches`` counts its kernel's
# launches as the device runs them.  ``TrainStep`` winds back what a
# capture counted and adds it again on each replay, over this list, so a
# new wrapper registers here (:func:`counted`) where it is defined.
LAUNCH_COUNTED: list = []


def counted(fn):
    """Give a kernel wrapper its launch counter, ``fn.launches`` (0), and
    register it in :data:`LAUNCH_COUNTED`."""
    fn.launches = 0
    LAUNCH_COUNTED.append(fn)
    return fn

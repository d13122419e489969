"""Share of the traced training window in which no operation ran on the
device (splatbench.trace: the union of device activity)."""

from splatbench.readings import idle_percent


def read(record, trace):
    return idle_percent(record, trace, "train")

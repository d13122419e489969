"""Share of the traced viewing window (its first frames) in which no
operation ran on the device (splatbench.trace: the union of device
activity)."""

from splatbench.readings import idle_percent


def read(record, trace):
    return idle_percent(record, trace, "view")

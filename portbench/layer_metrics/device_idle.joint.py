"""Share of the traced half of a joint_window run in which no kernel, copy or
set ran on the device, in %."""

from portbench.harness.readings import idle_percent


def read(r):
    return idle_percent(r, "joint_window")

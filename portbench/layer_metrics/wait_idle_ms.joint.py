"""Device idle ms per Joint window after the host's waits: the gaps between
the card's merged busy intervals that began while the host was inside an
`estdepth::host_wait.*` span of JointRunner.run_window, summed, over the
windows of the traced half of a joint_window run."""

from portbench.harness.host_waits import wait_idle_ms


def read(r):
    return wait_idle_ms(r, ("joint_window",))

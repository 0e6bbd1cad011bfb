"""Host ms per Joint window inside the port's outermost
`estdepth::host_wait.*` spans: the calls of JointRunner.run_window at
which the host waits for the card's queue to drain, their summed length
over the windows of the traced half of a joint_window run."""

from portbench.harness.host_waits import host_wait_ms


def read(r):
    return host_wait_ms(r, ("joint_window",))

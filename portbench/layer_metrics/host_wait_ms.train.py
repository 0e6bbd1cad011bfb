"""Host ms per training step inside the port's outermost
`estdepth::host_wait.*` spans: the calls of the training step at which
the host waits for the card's queue to drain, their summed length over
the steps of the traced half of a train_step run."""

from portbench.harness.host_waits import host_wait_ms


def read(r):
    return host_wait_ms(r, ("train_step",))

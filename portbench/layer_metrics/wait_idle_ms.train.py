"""Device idle ms per training step after the host's waits: the gaps
between the card's merged busy intervals that began while the host was
inside an `estdepth::host_wait.*` span of the training step, summed,
over the steps of the traced half of a train_step run."""

from portbench.harness.host_waits import wait_idle_ms


def read(r):
    return wait_idle_ms(r, ("train_step",))

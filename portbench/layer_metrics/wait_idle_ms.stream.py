"""Device idle ms per ESTM frame after the host's waits: the gaps between
the card's merged busy intervals that began while the host was inside an
`estdepth::host_wait.*` span of ESTMRunner.push_frame, summed, over the
frames delivered of the traced half of an estm_stream run."""

from portbench.harness.host_waits import wait_idle_ms


def read(r):
    return wait_idle_ms(r, ("estm_stream",))

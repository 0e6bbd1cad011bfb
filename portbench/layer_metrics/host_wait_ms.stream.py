"""Host ms per ESTM frame inside the port's outermost
`estdepth::host_wait.*` spans: the calls of ESTMRunner.push_frame at
which the host waits for the card's queue to drain, their summed length
over the frames delivered of the traced half of an estm_stream run."""

from portbench.harness.host_waits import host_wait_ms


def read(r):
    return host_wait_ms(r, ("estm_stream",))

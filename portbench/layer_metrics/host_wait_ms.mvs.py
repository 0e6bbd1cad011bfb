"""Host ms per MVS request inside the port's outermost
`estdepth::host_wait.*` spans: the calls of MVSRunner.run_view at which
the host waits for the card's queue to drain, their summed length over
the requests of the traced half of an mvs_views, mvs_views_wta or
mvs_scan run."""

from portbench.harness.host_waits import host_wait_ms


def read(r):
    return host_wait_ms(r, ("mvs_views", "mvs_views_wta", "mvs_scan"))

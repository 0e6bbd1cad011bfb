"""Device idle ms per MVS request after the host's waits: the gaps between
the card's merged busy intervals that began while the host was inside an
`estdepth::host_wait.*` span of MVSRunner.run_view, summed, over the
requests of the traced half of an mvs_views, mvs_views_wta or mvs_scan
run."""

from portbench.harness.host_waits import wait_idle_ms


def read(r):
    return wait_idle_ms(r, ("mvs_views", "mvs_views_wta", "mvs_scan"))

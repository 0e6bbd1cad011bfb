"""The mvs_scan step's share of the card's dense bf16 peak, in %: the
reference's operations of the first half's requests (FlopCounterMode on
the meta device at the cell's shapes: matmuls and convolutions,
347.6 TFLOP a 49-view scan) over that half's host seconds and
989 TFLOP/s (harness/attention.py). The float32 peak of
readings.mfu_percent would overstate a bf16 program's share."""

from portbench.harness.attention import PEAK_BF16_FLOPS


def read(r):
    if r.protocol != "mvs_scan" or not r.host or not r.flops:
        return None
    ops = sum(r.flops[x.kind] for x in r.host)
    return 100.0 * ops / r.host_window_s / PEAK_BF16_FLOPS

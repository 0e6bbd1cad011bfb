"""The mvs_views_wta step's share of the card's float32 peak, in %: the
reference's operations of the first half's requests (FlopCounterMode at the
cell's shapes) over that half's host seconds and 67 TFLOP/s."""

from portbench.harness.readings import mfu_percent


def read(r):
    return mfu_percent(r, "mvs_views_wta")

"""Tokens times the FMT layers they pass, per reference depth map, over the
whole mvs_views_wta run (warm-up requests included, the same mix): the
port's counters `mvs.fmt_tokens` over `mvs.targets`
(models/transmvsnet.py). A 5-view request at 1152x1600 whose views all
pass every layer reads 36 x 115,200 = 4,147,200 (4 self layers for the
reference, 8 for each of 4 sources). A port without the counters gives
None."""


def read(r):
    if r.protocol != "mvs_views_wta":
        return None
    try:
        from estdepth_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    if not c.get("mvs.fmt_tokens") or not c.get("mvs.targets"):
        return None
    return c["mvs.fmt_tokens"] / c["mvs.targets"]

"""Views CasMVSNet's feature net encoded per reference depth map, over the
whole mvs_views run (warm-up requests included, the same mix): the
port's counters `mvs.feature_views` over `mvs.targets`
(models/casmvsnet.py). A request of 5 views that encodes each of them
reads 5. A port without the counters gives None."""


def read(r):
    if r.protocol != "mvs_views":
        return None
    try:
        from estdepth_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    if not c.get("mvs.feature_views") or not c.get("mvs.targets"):
        return None
    return c["mvs.feature_views"] / c["mvs.targets"]

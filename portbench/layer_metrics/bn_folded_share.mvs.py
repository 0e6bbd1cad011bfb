"""Share of the eval-mode `conv_bn` blocks that ran as one convolution
with their BatchNorm folded in, over the whole mvs_views run (warm-up
requests included, the same mix): 100 x the port's counter
`layers.bn_folded` over `layers.bn_folded` + `layers.bn_unfolded`
(models/layers.ConvBN), %. CasMVSNet's float32 forward reads 100. A port
without the counters gives None."""


def read(r):
    if r.protocol != "mvs_views":
        return None
    try:
        from estdepth_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    folded = c.get("layers.bn_folded", 0)
    total = folded + c.get("layers.bn_unfolded", 0)
    if not total:
        return None
    return 100.0 * folded / total

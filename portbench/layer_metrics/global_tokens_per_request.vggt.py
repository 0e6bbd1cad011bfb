"""Tokens each of VGGT's global blocks attends over, per scan, over the
whole mvs_scan run (warm-up requests included, the same mix): the port's
counters `vggt.global_tokens` over `vggt.scans` (models/vggt.py). A
49-view scan at 378x518 reads 49 x 1,004 = 49,196 (a camera token, 4
registers and 27 x 37 patches a frame). A port without the counters
gives None."""


def read(r):
    if r.protocol != "mvs_scan":
        return None
    try:
        from estdepth_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    if not c.get("vggt.global_tokens") or not c.get("vggt.scans"):
        return None
    return c["vggt.global_tokens"] / c["vggt.scans"]

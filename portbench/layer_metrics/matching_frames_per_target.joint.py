"""Frames the matching encoder computed per target depth map, over the
whole joint_window run (warm-up windows included, the same mix): the
port's counters `matching.frames` (DepthNetHybrid._matching) over
`model.targets` (DepthNetHybrid.forward). A window of 5 frames gives 3
targets, so a run that encodes every frame of every window reads 5/3. A
port without the counters gives None."""


def read(r):
    if r.protocol != "joint_window":
        return None
    try:
        from estdepth_tpu_torch.utils.trace import counts
    except ImportError:
        return None
    c = counts()
    if not c.get("matching.frames") or not c.get("model.targets"):
        return None
    return c["matching.frames"] / c["model.targets"]

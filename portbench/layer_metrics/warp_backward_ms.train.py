"""Device ms per training step of the warps' gradients: the work launched
inside the port's `estdepth::<kernel>_backward` spans (autograd of each
kernel's plain version, ops/cuda/build.sample_with_plain_grad, on
autograd's thread), over the steps of the traced half."""

from portbench.harness.readings import device_ms_per


def read(r):
    names = {s.name for s in r.trace.spans
             if s.name.startswith("estdepth::")
             and s.name.endswith("_backward")}
    return device_ms_per(r, "train_step", names)

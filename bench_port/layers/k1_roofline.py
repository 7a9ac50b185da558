"""Kernels (csrc/stencil1d.cu): K1's share of its roofline, the least
bytes of one launch (X once, Y once, the diagonal once) at the card's
published memory rate over the mean device time of a stencil1d_kernel
launch in the trace."""

LAUNCH_KERNELS = ("stencil1d_kernel",)


def read(obs):
    if obs.trace is None or not obs.launch_bytes or not obs.peak_bytes_per_s:
        return None
    sec = launches = 0
    for name, (s, count) in obs.trace.kernels.items():
        if any(p in name for p in LAUNCH_KERNELS):
            sec += s
            launches += count
    if not launches:
        return None
    return 100.0 * obs.launch_bytes / obs.peak_bytes_per_s / (sec / launches)

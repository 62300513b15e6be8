"""idle_share.prefill: the share of the traced stretch (one forward of
each distinct batch) in which no operation ran on the device, from the
profiler's trace, in percent.  The host launches the eager forward far
ahead of the device, so the profiler's cost on the host does not reach the
device's timeline here: the share bounds the untraced one from above."""


def read(ctx):
    window = ctx.trace.get("window_s")
    return (1.0 - ctx.trace["busy_s"] / window) * 100.0 if window else None

"""idle_share.serve: the share of the decode loop's time in which the
device ran no captured step, in percent: over every decode step of the
traced run's window, the time from one step's end event to the next one's
start event (greedy sampling, the host's sync and its turn to launch)
against that time and the steps' own.  CUDA events on the device's clock,
with no profiler running, so the profiler's own cost is not read."""


def read(ctx):
    steps, between = ctx.stats.get("step_device_ms"), ctx.stats.get("between_steps_ms")
    if not (steps and between):
        return None
    return sum(between) / (sum(between) + sum(steps)) * 100.0

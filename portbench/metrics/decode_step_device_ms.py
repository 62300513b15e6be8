"""decode_step_device_ms: the device time of one captured decode step: the
mean, over every decode step of the traced run's window, of the time
between two CUDA events recorded around the step (its inputs copied in and
its graph replayed; the device is idle when it starts, since the server
waits for each token)."""


def read(ctx):
    steps = ctx.stats.get("step_device_ms")
    return sum(steps) / len(steps) if steps else None

"""mfu.prefill: the model operations of the window's forwards
(``work.prefill_flops`` for each sequence of each forward) over the
window's seconds and the bf16 peak, in percent."""
from portbench import work


def read(ctx):
    forwards, seq = ctx.stats.get("forwards"), ctx.stats.get("seq")
    if not forwards:
        return None
    flops = forwards * ctx.stats["batch"] * work.prefill_flops(ctx.model, seq)
    return flops / ctx.stats["seconds"] / work.PEAK_FLOPS * 100.0

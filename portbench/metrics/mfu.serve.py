"""mfu.serve: the model operations of the requests served in the window
(``work.served_flops``: each prompt's tokens and decode steps, the active
experts only, padding not counted) over the window's seconds and the bf16
peak, in percent."""
from portbench import work


def read(ctx):
    lens = ctx.stats.get("prompt_lens")
    if not lens:
        return None
    flops = sum(work.served_flops(ctx.model, n, ctx.stats["new_tokens"]) for n in lens)
    return flops / ctx.stats["seconds"] / work.PEAK_FLOPS * 100.0

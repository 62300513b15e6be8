"""ttft_mean_ms: the mean time to first token over every request of the
window, from ``ServeResult.ttft_s`` (the server's host clock around work it
has synchronised)."""


def read(ctx):
    ttft = ctx.stats.get("ttft_s")
    return sum(ttft) / len(ttft) * 1e3 if ttft else None

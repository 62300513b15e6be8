"""attn_ms_per_step: the device time of the attention layers in one eager
decode step at the cell's bucket: the kernels launched inside ranges around
each call of ``layers/attention.py``'s entry (projections, RoPE, the cache
write, attention over the cache)."""
from portbench.profiler import range_ms

RANGES = {"attn": [("repro_torch.layers.blocks", "gqa_attention"),
                   ("repro_torch.layers.blocks", "mla_attention")]}


def read(ctx):
    ms, calls = range_ms(ctx.extras.get("eager_step_ranges", {}), "attn")
    return ms if calls and ms > 0 else None

"""k2_roofline.prefill: every layer's causal attention (within the window,
where the configuration has one), priced by ``work.flash_bound_s``, over
the device time of the kernels inside ranges around the attention core
(``mha``, or ``chunked_attention`` where the configuration asks for it),
over every forward of the traced stretch, in percent."""
from portbench import work
from portbench.profiler import range_ms

RANGES = {"attn_core": [("repro_torch.layers.attention", "mha"),
                        ("repro_torch.layers.attention", "chunked_attention")]}


def read(ctx):
    ms, calls = range_ms(ctx.trace.get("ranges", {}), "attn_core")
    traced = ctx.trace.get("stats", {})
    if not (calls and traced.get("forwards")) or ms <= 0:
        return None
    bound = (traced["forwards"] * ctx.model["num_layers"]
             * work.flash_bound_s(ctx.model, traced["batch"], traced["seq"]))
    return bound / (ms / 1e3) * 100.0

"""mla_core_ms_per_step: the device time of the latent attention core in
one eager decode step at the cell's bucket: the kernels launched inside
ranges around each call of ``layers/attention.py``'s ``latent_core`` (the
absorbed scores over the whole latent cache, the mask, the softmax, the
weighted latent and ``w_uv``)."""
from portbench.profiler import range_ms

RANGES = {"mla_core": [("repro_torch.layers.attention", "latent_core")]}


def read(ctx):
    ms, calls = range_ms(ctx.extras.get("eager_step_ranges", {}), "mla_core")
    return ms if calls and ms > 0 else None

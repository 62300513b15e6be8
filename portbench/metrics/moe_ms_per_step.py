"""moe_ms_per_step: the device time of the MoE layers in one eager decode
step at the cell's bucket: the kernels launched inside ranges around each
call of ``layers/moe.py``'s ``moe`` (router, dispatch, experts, shared
experts)."""
from portbench.profiler import range_ms

RANGES = {"moe": [("repro_torch.layers.blocks", "moe")]}


def read(ctx):
    ms, calls = range_ms(ctx.extras.get("eager_step_ranges", {}), "moe")
    return ms if calls and ms > 0 else None

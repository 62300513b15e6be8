"""k1_roofline.decode: one decode step's projections and unembedding at the
bucket's rows (``work.linear_products``; bound by bytes at these rows) over
the device time of the kernels inside ranges around ``linear`` and
``unembed``, in one eager decode step at the cell's bucket, in percent."""
from portbench import work
from portbench.profiler import range_ms

RANGES = {"linear": [("repro_torch.layers.attention", "linear"),
                     ("repro_torch.layers.mlp", "linear")],
          "unembed": [("repro_torch.models.lm", "unembed")]}


def read(ctx):
    ranges = ctx.extras.get("eager_step_ranges", {})
    lin, n_lin = range_ms(ranges, "linear")
    emb, n_emb = range_ms(ranges, "unembed")
    rows = ctx.extras.get("eager_step_rows")
    if not (n_lin and n_emb and rows) or lin + emb <= 0:
        return None
    bound = work.products_bound_s(work.linear_products(ctx.model, rows, rows))
    return bound / ((lin + emb) / 1e3) * 100.0

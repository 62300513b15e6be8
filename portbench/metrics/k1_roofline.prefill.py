"""k1_roofline.prefill: the projections' and the unembedding's least time
(``work.linear_products`` at a forward's rows, each product's larger of
operations at the peak and bytes at the memory rate) over the device time
of the kernels inside ranges around ``layers/linear.py``'s ``linear``
(where attention and the MLP look it up) and ``layers/embed.py``'s
``unembed``, over every forward of the traced stretch, in percent."""
from portbench import work
from portbench.profiler import range_ms

RANGES = {"linear": [("repro_torch.layers.attention", "linear"),
                     ("repro_torch.layers.mlp", "linear")],
          "unembed": [("repro_torch.models.lm", "unembed")]}


def read(ctx):
    lin, n_lin = range_ms(ctx.trace.get("ranges", {}), "linear")
    emb, n_emb = range_ms(ctx.trace.get("ranges", {}), "unembed")
    traced = ctx.trace.get("stats", {})
    if not (n_lin and n_emb and traced.get("forwards")) or lin + emb <= 0:
        return None
    rows = traced["batch"] * traced["seq"]
    bound = traced["forwards"] * work.products_bound_s(work.linear_products(ctx.model, rows, rows))
    return bound / ((lin + emb) / 1e3) * 100.0

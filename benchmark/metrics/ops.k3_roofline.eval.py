"""ops.k3_roofline.eval: kernel 3's least time (``work.pair_mlp_work`` at each
launch's U, read from its grid, the relation MLP's widths after its first
layer and h2 at ``tpu.rel_stream_dtype``) over its device time in the
traced slice."""

from benchmark import work


def read(obs):
    t = obs.get("tracer")
    if obs.get("path") != "eval" or t is None:
        return None
    seconds, grids = t.kernel_time("pair_mlp_fwd_kernel")
    if not seconds:
        return None
    cfg = obs["cfg"]
    widths = list(cfg.relation_network_layers_config) + [cfg.word_embedding_dim]
    h2 = 2 if cfg.tpu.rel_stream_dtype == "bfloat16" else 4
    bound = sum(work.pair_mlp_work(g[1], cfg.tpu.max_object_num, widths, h2)["bound_s"]
                for g in grids)
    return 100.0 * bound / seconds

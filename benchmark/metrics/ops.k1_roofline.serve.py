"""ops.k1_roofline.serve: kernel 1's least time (``work.pair_tail_work`` at
each launch's B, read from its grid, and the configuration's O, H, E, R)
over its device time in the traced slice."""

from benchmark import work


def read(obs):
    t = obs.get("tracer")
    if obs.get("path") != "serve" or t is None:
        return None
    seconds, grids = t.kernel_time("relation_oracle_fwd_kernel")
    if not seconds:
        return None
    cfg = obs["cfg"]
    O, R = cfg.tpu.max_object_num, cfg.tpu.rel_table_size
    H, E = cfg.relation_network_layers_config[0], cfg.word_embedding_dim
    bound = sum(work.pair_tail_work(g[1], O, H, E, R)["bound_s"] for g in grids)
    return 100.0 * bound / seconds

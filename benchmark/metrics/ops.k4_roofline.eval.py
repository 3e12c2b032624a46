"""ops.k4_roofline.eval: kernel 4's least time (``work.shared_contract_work``
at each launch's U, read from its grid, the batch's B =
``test_batch_size`` questions and the configuration's O, E, R, h2 at
``tpu.rel_stream_dtype``) over its device time in the traced slice."""

from benchmark import work


def read(obs):
    t = obs.get("tracer")
    if obs.get("path") != "eval" or t is None:
        return None
    seconds, grids = t.kernel_time("shared_contract_kernel")
    if not seconds:
        return None
    cfg = obs["cfg"]
    bound = sum(work.shared_contract_work(cfg.test_batch_size, g[1], cfg.tpu.max_object_num,
                                          cfg.word_embedding_dim, cfg.tpu.rel_table_size,
                                          cfg.tpu.rel_stream_dtype)["bound_s"] for g in grids)
    return 100.0 * bound / seconds

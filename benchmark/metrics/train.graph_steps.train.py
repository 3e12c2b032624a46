"""train.graph_steps.train: the share of the training steps whose
``train.step`` span ends in the traced slice that ran as a CUDA graph
replay (the span's ``route``, from ``GraphCache.last_route``)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    steps = spans.ending(sp, s, "train.step")
    replayed = sum(x[4]["steps"] for x in steps if x[4].get("route") == "replay")
    total = sum(x[4]["steps"] for x in steps)
    return spans.per(100.0 * replayed, total)

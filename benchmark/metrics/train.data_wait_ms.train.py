"""train.data_wait_ms.train: the port's ``transfer.wait`` spans on the
trainer's thread (waiting for the transfer worker's next group) inside the
traced slice, in ms per training step of the ``train.step`` spans that end
in it (their ``steps``)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    steps = spans.ending(sp, s, "train.step")
    threads = {x[1] for x in steps}
    return spans.per(spans.ms(spans.clipped(sp, s, ("transfer.wait",), threads)),
                     sum(x[4]["steps"] for x in steps))

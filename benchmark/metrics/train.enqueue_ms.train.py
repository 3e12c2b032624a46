"""train.enqueue_ms.train: the port's ``train.step`` spans (a group's
dispatch on the trainer's thread: one eager step, or a chunk eagerly, at
its capture or as a graph replay) inside the traced slice, in ms per
training step of the spans that end in it (their ``steps``)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    return spans.per(spans.ms(spans.clipped(sp, s, ("train.step",))),
                     sum(x[4]["steps"] for x in spans.ending(sp, s, "train.step")))

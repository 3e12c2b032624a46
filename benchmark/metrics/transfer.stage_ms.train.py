"""transfer.stage_ms.train: the port's ``transfer.stage`` spans (a group's
copy to the card: staged and stacked on the transfer worker, or one batch
on the trainer's thread) inside the traced slice, in ms per batch of the
spans that end in it (their ``batches``)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    return spans.per(spans.ms(spans.clipped(sp, s, ("transfer.stage",))),
                     sum(x[4]["batches"] for x in spans.ending(sp, s, "transfer.stage")))

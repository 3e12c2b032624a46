"""transfer.pinned_batches.train: the share of the batches of the port's
``transfer.stage`` spans ending in the traced slice whose objects went to
the card straight from the loader's page-locked gather block, with no
host copy (the span's ``pinned`` tag, over its ``batches``). None where the
program tags no ``pinned`` (a program that stages every batch's objects
through a host copy)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    stages = spans.ending(sp, s, "transfer.stage")
    if not any("pinned" in x[4] for x in stages):
        return None
    return spans.per(100.0 * sum(x[4].get("pinned", 0) for x in stages),
                     sum(x[4]["batches"] for x in stages))

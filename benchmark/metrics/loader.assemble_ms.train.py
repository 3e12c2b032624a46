"""loader.assemble_ms.train: the port's ``loader.programs`` (a batch's
program rows) and ``loader.batch`` (its ``LoadedBatch``) spans, on the
loader's producer thread, inside the traced slice, in ms per batch whose
``loader.batch`` span ends in it."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    return spans.per(spans.ms(spans.clipped(sp, s, ("loader.programs", "loader.batch"))),
                     len(spans.ending(sp, s, "loader.batch")))

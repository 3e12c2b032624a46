"""loader.scenes_ms.train: the port's ``loader.scenes`` spans (the scene
block of a batch, ``FeatureSource.batch_unique``, on the loader's producer
thread) inside the traced slice, in ms per batch whose span ends in it."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    return spans.per(spans.ms(spans.clipped(sp, s, ("loader.scenes",))),
                     len(spans.ending(sp, s, "loader.scenes")))

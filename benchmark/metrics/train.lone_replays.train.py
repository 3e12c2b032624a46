"""train.lone_replays.train: the share of the lone training steps (the
port's ``train.step`` spans with ``steps`` 1 that end in the traced slice)
that ran as a CUDA graph replay (the span's ``route``, from
``GraphCache.last_route``). None where no lone step ends in the slice."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    lone = [x for x in spans.ending(sp, s, "train.step") if x[4].get("steps") == 1]
    return spans.per(100.0 * sum(x[4].get("route") == "replay" for x in lone), len(lone))

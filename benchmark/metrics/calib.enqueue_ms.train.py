"""calib.enqueue_ms.train: the port's ``calib.passes`` spans (the
calibrator's two LSTM passes, enqueued by the trainer's thread) inside the
traced slice, in ms per span that ends in it: the calibrator's enqueue per
step in which Python ran it. A CUDA graph replay runs no Python, so only
eager steps and captures record the span. None where no span ends in the
slice (a program without the span, or a slice of replays only)."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    return spans.per(spans.ms(spans.clipped(sp, s, ("calib.passes",))),
                     len(spans.ending(sp, s, "calib.passes")))

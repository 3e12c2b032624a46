"""device.idle_data_wait.train: the share of the traced slice in which no
kernel of the device trace ran while the trainer's thread was inside the
port's ``transfer.wait`` span: the card idle for want of data. The
kernels' trace times are put on the spans' clock by
``utils.profiling.trace_offset_ns``."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    threads = {x[1] for x in spans.ending(sp, s, "train.step")}
    if not threads:
        return None
    from dfol_vqa_tpu_torch.utils import profiling

    off = profiling.trace_offset_ns()
    kernels = [(max(ts * 1e3 + off, s[0]), min((ts + dur) * 1e3 + off, s[1]))
               for _, ts, dur, _ in obs["tracer"].kernels]
    waits = spans.clipped(sp, s, ("transfer.wait",), threads)
    idle = spans.outside(waits, [k for k in kernels if k[1] > k[0]])
    return 100.0 * idle / (s[1] - s[0])

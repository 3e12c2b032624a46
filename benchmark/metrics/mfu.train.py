"""mfu.train: the model FLOP the window's work needs (``benchmark.work``:
per image and per question, real objects only; training adds the backward
of the trained parts) over the window's seconds times the peak of the
configuration's compute dtype (float32: 3xTF32, 165 TFLOP/s)."""

from benchmark import work


def read(obs):
    if obs.get("path") != "train" or not obs.get("model_flop"):
        return None
    peak = work.PEAK_FLOPS[obs["cfg"].tpu.compute_dtype]
    return 100.0 * obs["model_flop"] / (obs["window_s"] * peak)

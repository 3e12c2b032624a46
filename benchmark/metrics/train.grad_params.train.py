"""train.grad_params.train: the share of the parameter elements that
require a gradient in the training steps (the ``grad_elems`` tag of the
port's ``train.step`` spans ending in the traced slice, over their
``param_elems``): what a step differentiates of the model. None for a
program without the tags."""

from benchmark import spans


def read(obs):
    r = spans.record(obs)
    if r is None:
        return None
    s, sp = r
    steps = [x for x in spans.ending(sp, s, "train.step") if "grad_elems" in x[4]]
    return spans.per(100.0 * sum(x[4]["grad_elems"] for x in steps),
                     sum(x[4]["param_elems"] for x in steps))

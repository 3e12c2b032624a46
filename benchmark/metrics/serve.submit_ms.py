"""serve.submit_ms: the mean host time of ``ServingEngine.submit`` (compile,
canonicalize, plan cache, queue) per request, from the harness's span."""


def read(obs):
    s = obs.get("submit_s")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)

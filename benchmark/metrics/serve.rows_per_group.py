"""serve.rows_per_group: requests over the groups the engine dispatched in
the window (``ServingEngine.stats`` counters)."""


def read(obs):
    if not obs.get("batches"):
        return None
    return obs["requests"] / obs["batches"]

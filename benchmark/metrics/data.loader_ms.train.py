"""data.loader_ms.train: the wait in the loader's iterator per batch, from the
harness's wrapper around the iterator of the loader it hands to the
trainer (the loader's gather, batch_unique and prefetch queue)."""


def read(obs):
    if obs.get("path") != "train" or not obs.get("loader_batches"):
        return None
    return 1e3 * obs["loader_wait_s"] / obs["loader_batches"]

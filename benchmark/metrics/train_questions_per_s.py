"""train_questions_per_s: every real question trained in the window, over
the window's seconds (from the drained device at its start to the end of
``VQATrainer.train``), summed over the cards."""


def read(obs):
    if obs.get("path") != "train" or not obs.get("window_s"):
        return None
    return obs["questions"] / obs["window_s"]

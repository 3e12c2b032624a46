"""eval_questions_per_s: every question scored by the window's whole
passes over the question file, over the seconds they took."""


def read(obs):
    if obs.get("path") != "eval" or not obs.get("window_s"):
        return None
    return obs["questions"] / obs["window_s"]

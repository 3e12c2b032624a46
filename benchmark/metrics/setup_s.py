"""setup_s: start of the process to the start of the window (host clock)."""


def read(obs):
    return obs.get("setup_s")

"""setup_s: seconds from the process's start to the first timed step or request (host clock)."""


def read(obs):
    return obs.get("setup_s")

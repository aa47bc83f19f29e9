"""engine.tokens_per_decode_call: tokens generated in the window over the calls of models.model.decode_step the runner counted (traced run)."""


def read(obs):
    return (obs["tokens_generated"] / obs["decode_calls"]) if obs.get("decode_calls") else None

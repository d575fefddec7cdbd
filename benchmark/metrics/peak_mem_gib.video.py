"""``torch.cuda.max_memory_allocated`` over the window, GiB."""


def read(obs):
    peak = obs.get("peak_bytes_window")
    return None if not peak else peak / 2 ** 30

"""peak_mem_gib: the card's peak allocated memory over set-up and window,
``torch.cuda.max_memory_allocated`` after a reset at process start, in GiB."""


def read(m):
    return m.peak_bytes / 2 ** 30 if m.peak_bytes else None

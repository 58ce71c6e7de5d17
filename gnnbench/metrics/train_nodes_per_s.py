"""train_nodes_per_s: labelled seed nodes trained (both nets stepped) over
the whole window, by the host clock ending in a synchronize."""


def read(m):
    return m.units / m.window_s if m.unit == "train_nodes" else None

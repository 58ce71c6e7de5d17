"""eval_nodes_per_s: graph nodes given logits and split accuracies by both
nets, passes x nodes over the whole window (host clock; each pass ends in
the host reading its accuracies)."""


def read(m):
    return m.units / m.window_s if m.unit == "eval_nodes" else None

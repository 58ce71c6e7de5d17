"""graph_load_s: the host seconds of the dataset load (the synthetic graph
generated, or read from its cache), from the pipeline's ``setup`` record
(``load_s``)."""


def read(m):
    return m.setup_record.get("load_s")

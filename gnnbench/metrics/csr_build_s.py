"""csr_build_s: the host seconds of the CSR build and its placement on the
card, from the pipeline's ``setup`` record (``csr_s``)."""


def read(m):
    return m.setup_record.get("csr_s")

"""The port's own span of its host prepare: `PreparedData.prepare_seconds`
(quantisation, the multi-tree codes, the LSH keys and their upload)."""


def read(run):
    return run.prepare_s if run.prepare_s > 0 else None

"""Share of the process's device batches that the provider packed in one
native pass over the job objects: ``PACKS`` in crypto/provider.py counts
each batch packed for the device by its path, the pass (``single_pass``)
or the lists (``fallback``). Read in traced runs, as the other provider
metrics are; a program without the counter, or one that packed nothing,
reads nothing."""


def read(layer: dict):
    if "trace" not in layer:
        return None
    from corda_tpu_torch.crypto import provider

    packs = getattr(provider, "PACKS", None)
    if not packs:
        return None
    total = packs.get("single_pass", 0) + packs.get("fallback", 0)
    if total <= 0:
        return None
    return 100.0 * packs.get("single_pass", 0) / total

"""Threads the provider's native pass ran a batch on, the mean over the
process's batches that the pass packed: ``PASS_THREADS`` in
crypto/provider.py sums those batches and the threads ``pack_jobs``
reported for each (one for a batch read by attribute or too small to
split, else up to the cores of the calling thread's affinity mask). Read
in traced runs, as the other provider metrics are; a program without the
counter, or one whose pass packed nothing, reads nothing."""


def read(layer: dict):
    if "trace" not in layer:
        return None
    from corda_tpu_torch.crypto import provider

    counts = getattr(provider, "PASS_THREADS", None)
    if not counts or counts.get("batches", 0) <= 0:
        return None
    return counts.get("threads", 0) / counts["batches"]

"""Share of the card sidecar's device batches in the window that the
provider packed in one native pass over the job objects: the delta of the
``packs`` its ``stats()`` export (``provider.PACKS``: ``single_pass`` or
``fallback``). A sidecar without the export, or one that packed nothing,
reads nothing."""


def read(layer: dict):
    side = layer.get("sidecar")
    if not side or "packs" not in side[0] or "packs" not in side[1]:
        return None
    before, after = side[0]["packs"], side[1]["packs"]
    single = after["single_pass"] - before["single_pass"]
    total = single + after["fallback"] - before["fallback"]
    if total <= 0:
        return None
    return 100.0 * single / total

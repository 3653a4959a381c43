"""L4/L5 node runtime of the port: services, messaging (in-memory and
TCP), the state machine manager with its verify pump, the notary services,
persistence, RPC, the verify sidecar's client (``verify_client``) and the
production node (``node``, ``python -m corda_tpu_torch.node.node``)."""


def not_ported(feature: str, roadmap_item: str) -> NotImplementedError:
    """The error a configured feature raises while its module waits for a
    later slice of the port: it names the feature and its ROADMAP.md item,
    never a bare ImportError from deep inside a lazy import."""
    return NotImplementedError(
        f"{feature} is not ported to corda_tpu_torch yet "
        f"(ROADMAP.md queue 1 item {roadmap_item})")

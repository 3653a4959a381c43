"""L4/L5 node runtime of the port: services, messaging (in-memory and
TCP), the state machine manager with its verify pump, the notary services,
persistence, RPC, the verify sidecar's client (``verify_client``) and the
production node (``node``, ``python -m corda_tpu_torch.node.node``)."""

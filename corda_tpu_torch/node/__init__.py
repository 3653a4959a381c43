"""L4/L5 node runtime of the port: services, in-memory messaging, the state
machine manager with its verify pump, the notary services, and the verify
sidecar's client (``verify_client``). The TCP node and transport are not
ported yet (ROADMAP.md)."""

"""Node side of the port: the verify sidecar's client (``verify_client``)."""

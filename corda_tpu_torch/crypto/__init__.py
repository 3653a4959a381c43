"""Crypto layer of the port: the oracle copy, the verifier seam and the
verify sidecar. Importing it builds no kernel and loads no torch."""

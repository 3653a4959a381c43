"""Test fixtures of the port: the dummy contract and its states (own copy of
corda_tpu/testing/dummies.py, registered under the same wire names)."""

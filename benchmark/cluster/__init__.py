"""The multi-process cells' parts that run inside the cluster's processes:
the client nodes' firehose (a CorDapp), the sidecar's launcher, and the
move plan that the driver and the clients both derive from the seed."""

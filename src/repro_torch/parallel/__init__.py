"""The storage engine's device mesh (``mesh``): which device owns which
shards and queries of a batched sharded scan; and cross-pod gradient
compression (``compression``)."""

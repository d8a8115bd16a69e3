"""Distribution substrate of the port: the device mesh (``mesh``),
logical-axis sharding rules (``sharding``) and cross-pod gradient
compression (``compression``)."""

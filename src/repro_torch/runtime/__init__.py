"""Training runtime of the port: checkpoint / restore, the
fault-tolerant loop, straggler mitigation.  Elastic re-sharding
(``reshard_state``) comes with ``parallel/sharding.py``."""
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop, Heartbeat

__all__ = ["CheckpointManager", "FaultTolerantLoop", "Heartbeat"]

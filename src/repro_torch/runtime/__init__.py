"""Training runtime of the port: checkpoint / restore, the
fault-tolerant loop, elastic re-sharding, straggler mitigation."""
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import gather_state, reshard_state
from repro_torch.runtime.fault_tolerance import FaultTolerantLoop, Heartbeat

__all__ = ["CheckpointManager", "FaultTolerantLoop", "Heartbeat",
           "gather_state", "reshard_state"]

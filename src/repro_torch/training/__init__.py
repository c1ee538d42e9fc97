"""Training substrate of the port: optimizer, data pipeline, checkpointing
and the fault-tolerant loop (the port of ``repro.training``)."""

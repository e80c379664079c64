"""Runtime of the port (counterpart of lele_tpu.runtime): `CompiledModel`
(runtime.engine) and length bucketing (runtime.bucketing)."""

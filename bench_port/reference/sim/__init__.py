"""A frozen copy of the port's simulation (mupe_tpu_torch's envs, dynamics,
controllers, transforms and sensors as of the benchmark's first version),
the reference that the env step, the auto-reset and the observation are
held to.  Files are copied verbatim; only the package `__init__`s are cut
to what the two tasks import, and `parallel/dist.py` is the one-process
case."""

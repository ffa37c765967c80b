"""The port's host substrate (copies of the reference's jax-free modules)
and the device half of the chunked ingest pipeline."""

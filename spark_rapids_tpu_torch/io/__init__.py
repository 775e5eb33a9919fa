"""Host-side data the scan uploads (the counterpart of
spark_rapids_tpu/io/, only its numpy part)."""

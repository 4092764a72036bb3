"""Model serving (the port of ``fedml_tpu/serving/``)."""

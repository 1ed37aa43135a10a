"""eval of the dss_tpu_torch port."""

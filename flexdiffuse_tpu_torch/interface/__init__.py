"""Web UI (port of ``flexdiffuse_tpu/interface``)."""

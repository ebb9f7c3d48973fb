"""Models (port of ``cliffordtpu/nn``)."""

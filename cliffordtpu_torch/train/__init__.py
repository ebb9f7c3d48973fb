"""Train state and steps (port of ``cliffordtpu/train``)."""

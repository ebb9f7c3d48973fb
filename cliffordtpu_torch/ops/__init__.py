"""Tensor operations (port of ``cliffordtpu/ops``)."""

"""Experiment runners (port of ``cliffordtpu/runners``)."""

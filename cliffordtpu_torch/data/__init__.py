"""Data helpers (port of ``cliffordtpu/data``)."""

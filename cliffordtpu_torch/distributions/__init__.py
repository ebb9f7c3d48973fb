"""Latent distributions (port of ``cliffordtpu/distributions``)."""

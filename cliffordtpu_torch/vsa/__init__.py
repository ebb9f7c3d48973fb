"""Holographic reduced representations: the binding, bundling and
similarity operations (``ops``) and the capacity experiments
(``capacity``)."""

"""Serving graphs (``int8_serve``: int8-through BiSeNet-R18)."""

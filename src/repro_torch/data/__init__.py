"""Synthetic non-IID data (``synthetic``)."""

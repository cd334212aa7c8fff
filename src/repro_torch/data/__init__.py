"""Synthetic non-IID data (``synthetic``) and the streams of the online
train->serve loop (``stream``)."""

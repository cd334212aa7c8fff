"""The paper's CTR models (``deepfm``) on stacked ``(K, ...)`` params."""

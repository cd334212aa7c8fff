"""Models of the port: the paper's CTR models (``deepfm``) on stacked
``(K, ...)`` params, and the dense transformer LM that the serving path
runs (``common``, ``mlp``, ``attention``, ``transformer``; ``registry``
builds one by config)."""

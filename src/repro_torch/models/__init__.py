"""Models of the port: the paper's CTR models (``deepfm``) on stacked
``(K, ...)`` params, and the LMs that the serving path runs: the dense
transformer (``common``, ``mlp``, ``attention``, ``transformer``) and
RWKV6 (``rwkv6``); ``registry`` builds one by config."""

"""Serving: the bucketed decode engine (``engine``) and the lock-free
param store fed from the packed training state (``publish``)."""
from repro_torch.serve.engine import (DecodeEngine, cache_spec, cast_cache,
                                      cast_params, effective_config,
                                      greedy_generate, make_prefill_step,
                                      make_serve_step, select_bucket)
from repro_torch.serve.publish import (ParamStore, publish_from_state,
                                       publish_hbm_bytes, publish_params)

__all__ = ["cache_spec", "effective_config", "make_serve_step",
           "make_prefill_step", "greedy_generate", "DecodeEngine",
           "cast_cache", "cast_params", "select_bucket", "ParamStore",
           "publish_params", "publish_from_state", "publish_hbm_bytes"]

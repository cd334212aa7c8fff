"""The port's analysis tools: the invariant gates and the roofline (the
port of ``repro.analysis``'s ``invariants`` and ``roofline``).

``repro_torch.analysis.check`` (the sweep over every training layout) is
deliberately NOT imported here: it pulls in the train and launch layers;
use ``from repro_torch.analysis import check`` directly.
"""
from repro_torch.analysis.invariants import (RULES, Check, InvariantReport,
                                             InvariantSpec,
                                             InvariantViolation,
                                             assert_invariants,
                                             assert_topology,
                                             check_invariants,
                                             check_schedule, check_topology,
                                             distributed_calls, evaluate)
from repro_torch.analysis.roofline import (H100_SXM, DeviceFigures,
                                           Roofline, mfu, model_flops_for,
                                           prefill_model_flops, step_flops)

__all__ = ["RULES", "Check", "InvariantReport",
           "InvariantSpec", "InvariantViolation", "assert_invariants",
           "assert_topology", "check_invariants", "check_schedule",
           "check_topology", "distributed_calls", "evaluate",
           "H100_SXM", "DeviceFigures", "Roofline", "mfu",
           "model_flops_for", "prefill_model_flops", "step_flops"]

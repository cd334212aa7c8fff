"""D-Adam (Alg. 1) and CD-Adam (Alg. 2) over K stacked workers: topologies
and their time-varying schedules (``topology``, ``schedule``), the
optimizer math, packed state and straggler-tolerant rounds (``dadam``,
``cdadam``), the compressors (``compression``), the baselines
(``baselines``), elastic membership (``elastic``) and the
``make_optimizer`` facade (``api``). Import the submodules directly."""
